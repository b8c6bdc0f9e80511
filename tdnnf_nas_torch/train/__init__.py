"""Objective, optimizer and train step."""
from tdnnf_nas_torch.train.objective import ChainObjectiveConfig, chain_objective
from tdnnf_nas_torch.train.optimizer import (OptimizerConfig, learning_rate_at,
                                             make_optimizer)
from tdnnf_nas_torch.train.trainer import (TrainerConfig, TrainState,
                                           init_train_state, make_train_step)
