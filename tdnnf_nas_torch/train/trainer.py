"""LF-MMI train step (port of ``tdnnf_nas_tpu.train.trainer``).

One call = forward, chain objective, backward, Adam update with
max-change, the semi-orthogonal constraint every ``semiorth_interval``
steps (`nnet-utils.cc:1062`) and the batchnorm running-stat update.  The
step counter is a host int, so choosing whether the constraint runs needs
no device sync, and the step issues no ``.item()``: metrics stay tensors.
Not ported yet: the supernet path (alphas, tau, FLOPs and entropy terms),
the dropout schedule, ``train_theta``/``bn_frozen`` and the valid step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.models import tdnnf as tdnnf_mod
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph, DenGraphArrays
from tdnnf_nas_torch.ops.semiorth import (semi_orthogonal_step,
                                          semi_orthogonal_step_3d)
from tdnnf_nas_torch.train.objective import (ChainObjectiveConfig,
                                             chain_objective)
from tdnnf_nas_torch.train.optimizer import (OptimizerConfig, make_optimizer,
                                             tree_paths, tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainerConfig(Config):
    objective: ChainObjectiveConfig = dataclasses.field(
        default_factory=ChainObjectiveConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    semiorth_interval: int = 4  # reference: ~every 4 minibatches


@dataclasses.dataclass
class TrainState:
    params: Any
    bn_state: Any
    opt_state: Any
    step: int


def _wd_scale(path) -> float:
    """Relative weight decay per param (0 for the fixed lda, 0.2 for the
    output layers, `run_tdnn_7q_fbk_40_manual.sh:119-123`)."""
    name = "/".join(path)
    if "lda" in name:
        return 0.0
    if "output_" in name:
        return 0.2
    return 1.0


def init_train_state(model_cfg, trainer_cfg: TrainerConfig,
                     generator: torch.Generator, device="cpu") -> TrainState:
    params, bn_state = tdnnf_mod.init_model(model_cfg, generator, device)
    opt_init, _ = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    return TrainState(params=params, bn_state=bn_state,
                      opt_state=opt_init(params), step=0)


@torch.no_grad()
def _apply_semiorth(params, model_cfg):
    """Constraint step on all semi-orthogonal factors (a spliced [K, F, D]
    factor as one [K*F, D] matrix)."""
    constrained = set(tdnnf_mod.semiorth_param_paths(model_cfg))

    def constrain(w):
        return (semi_orthogonal_step_3d(w) if w.ndim == 3
                else semi_orthogonal_step(w))

    return tree_unflatten([(p, constrain(x) if p in constrained else x)
                           for p, x in tree_paths(params)])


def make_train_step(model_cfg, trainer_cfg: TrainerConfig,
                    den: Union[BlockedDenGraph, DenGraphArrays],
                    generator: Optional[torch.Generator] = None):
    """Build the train step.

    step(state, batch) -> (new_state, metrics)
    batch: {"feats": [B,T_in,F], "ivectors": [B,D] (optional),
    "sup": ChunkSupervision of tensors} on the den graph's device
    (``convert.batch_to_torch``).  ``generator`` draws dropout masks.
    """
    _, opt_update = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    interval = trainer_cfg.semiorth_interval

    def step(state: TrainState, batch):
        paths_leaves = tree_paths(state.params)
        leaves = [x.detach().requires_grad_(True) for _, x in paths_leaves]
        params = tree_unflatten([(p, x) for (p, _), x in
                                 zip(paths_leaves, leaves)])
        chain_out, xent_out, new_bn = tdnnf_mod.apply_model(
            model_cfg, params, state.bn_state, batch["feats"],
            batch.get("ivectors"), train=True, generator=generator)
        loss, metrics = chain_objective(chain_out, xent_out, den,
                                        batch["sup"], trainer_cfg.objective)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new_params, new_opt = opt_update(grads, state.opt_state,
                                             state.params, state.step)
            if interval > 0 and state.step % interval == 0:
                new_params = _apply_semiorth(new_params, model_cfg)
            metrics["grad_norm"] = torch.sqrt(
                sum(torch.sum(g * g) for g in grads) + 1e-20)
        return TrainState(new_params, new_bn, new_opt, state.step + 1), metrics

    return step
