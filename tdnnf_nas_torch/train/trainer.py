"""LF-MMI train and valid steps for TDNN-F models and DARTS supernets (port
of ``tdnnf_nas_tpu.train.trainer``).

One call = forward, chain objective, backward, Adam update with
max-change, the semi-orthogonal constraint every ``semiorth_interval``
steps (`nnet-utils.cc:1062`) and the batchnorm running-stat update.  The
two-stage NAS pipeline is optimizer partitions (``train_theta`` /
``train_alpha``) plus ``bn_frozen``, as in the reference.  The step
counter is a host int, so the constraint's schedule, the temperature and
the dropout proportion need no device sync, and the step issues no
``.item()``: metrics stay tensors (``tau`` and ``dropout_p`` are host
floats).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.core.prng import fold_in_step
from tdnnf_nas_torch.models import nas as nas_mod
from tdnnf_nas_torch.models import tdnnf as tdnnf_mod
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
    train_theta: bool = True
    train_alpha: bool = False
    bn_frozen: bool = False
    search_mode: str = nas_mod.SearchMode.FIXED  # supernet only
    tau_max: float = 1.0  # temperature anneal (temperature_schedule.py:34-67)
    tau_min: float = 0.03
    flops_coef: float = 0.0  # bottleneck FLOPs penalty
    alpha_entropy_coef: float = 0.0  # explicit version of the x5 entropy hack
    # ((data_fraction, proportion), ...) breakpoints, piecewise-linear in
    # the training fraction (`--trainer.dropout-schedule`); empty => the
    # model config's constant dropout_proportion
    dropout_schedule: tuple = ()


@dataclasses.dataclass
class TrainState:
    params: Any
    bn_state: Any
    opt_state: Any
    step: int
    alphas: Any = dataclasses.field(default_factory=dict)  # {}: plain model
    alpha_opt_state: Any = dataclasses.field(default_factory=dict)


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
                     generator: torch.Generator, device=DEFAULT_DEVICE,
                     supernet: bool = False) -> TrainState:
    device = resolve_device(device)
    if supernet:
        params, alphas, bn_state = nas_mod.init_supernet(model_cfg, generator,
                                                         device)
    else:
        params, bn_state = tdnnf_mod.init_model(model_cfg, generator, device)
        alphas = {}
    opt_init, _ = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    a_init, _ = make_optimizer(trainer_cfg.optimizer)
    return TrainState(params=params, bn_state=bn_state,
                      opt_state=opt_init(params), step=0, alphas=alphas,
                      alpha_opt_state=a_init(alphas))


def _train_fraction(step: int, num_steps: int) -> np.float32:
    f = np.float32(step) / np.float32(max(num_steps, 1))
    return np.clip(f, np.float32(0.0), np.float32(1.0))


def _tau_at(step: int, cfg: TrainerConfig, num_steps: int) -> float:
    """Temperature at a step, in the reference's float32 arithmetic."""
    f = _train_fraction(step, num_steps)
    tau = ((np.float32(1.0) - f) * np.float32(cfg.tau_max - cfg.tau_min)
           + np.float32(cfg.tau_min))
    return float(tau)


def _dropout_at(step: int, cfg: TrainerConfig,
                num_steps: int) -> Optional[float]:
    """Piecewise-linear dropout proportion at the training fraction."""
    if not cfg.dropout_schedule:
        return None
    xs = np.asarray([x for x, _ in cfg.dropout_schedule], np.float32)
    ys = np.asarray([y for _, y in cfg.dropout_schedule], np.float32)
    return float(np.float32(np.interp(_train_fraction(step, num_steps),
                                      xs, ys)))


@torch.no_grad()
def _apply_semiorth(params, base_cfg):
    """Constraint step on all semi-orthogonal factors (a spliced [K, F, D]
    factor, a supernet's K branches included, as one [K*F, D] matrix)."""
    constrained = set(tdnnf_mod.semiorth_param_paths(base_cfg))

    def constrain(w):
        return (semi_orthogonal_step_3d(w) if w.ndim == 3
                else semi_orthogonal_step(w))

    return tree_unflatten([(p, constrain(x) if p in constrained else x)
                           for p, x in tree_paths(params)])


def _with_grad(tree):
    """(leaves requiring grad, the tree rebuilt on them)."""
    pl = tree_paths(tree)
    leaves = [x.detach().requires_grad_(True) for _, x in pl]
    return leaves, tree_unflatten([(p, x) for (p, _), x in zip(pl, leaves)])


def step_seed(seed: int, step: int) -> int:
    """The seed of the draws of step ``step``: a function of (seed, step)
    alone, as the reference's ``fold_in(key, state.step)``
    (`train/trainer.py:198` there), so a run resumed from a checkpoint
    draws at step k what an unbroken run draws there
    (``core.prng.fold_in_step``)."""
    return fold_in_step(seed, step)


def make_train_step(model_cfg, trainer_cfg: TrainerConfig, den,
                    seed: Optional[int] = None,
                    supernet: bool = False, mesh=None):
    """Build the train step.

    step(state, batch) -> (new_state, metrics)
    batch: {"feats": [B,T_in,F], "ivectors": [B,D] (optional),
    "sup": ChunkSupervision of tensors} on the den graph's device
    (``convert.batch_to_torch``).  With a ``seed``, each step draws its
    dropout masks and a supernet's path samples from a generator on the
    batch's device seeded ``step_seed(seed, state.step)``; the uniform and
    gumbel search modes need one, and without it there is no dropout.
    Parameter gradients are always taken, for ``grad_norm``, even when
    ``train_theta`` is off (as in the reference); alpha gradients only
    when ``train_alpha`` is on.  ``den`` is any den graph that
    ``train.objective.chain_objective`` takes.

    With a data-parallel ``mesh`` (``parallel.mesh.make_mesh``), every
    rank calls the step with the same replicated state
    (``parallel.mesh.put_replicated``) and its rows of the global batch
    (``parallel.mesh.put_batch``): batchnorm's statistics, the dropout
    masks and a supernet's per-sequence samples are the global batch's,
    the loss is each rank's share of the global objective, and the
    gradients are sum-all-reduced before ``grad_norm``, max-change and the
    update, so each rank takes the one-process step of the global batch.
    The metrics are the global batch's.
    """
    _, opt_update = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    _, alpha_update = make_optimizer(trainer_cfg.optimizer)
    num_steps = trainer_cfg.optimizer.num_steps
    interval = trainer_cfg.semiorth_interval
    base_cfg = model_cfg.base if supernet else model_cfg
    world = 1 if mesh is None else mesh.size
    generators = {}  # one per device, reseeded at every step

    def step(state: TrainState, batch):
        tau = _tau_at(state.step, trainer_cfg, num_steps)
        dropout_p = _dropout_at(state.step, trainer_cfg, num_steps)
        generator = None
        if seed is not None:
            dev = batch["feats"].device
            generator = generators.get(dev)
            if generator is None:
                generator = generators[dev] = torch.Generator(dev)
            generator.manual_seed(step_seed(seed, state.step))
        p_leaves, params = _with_grad(state.params)
        a_leaves, alphas = [], state.alphas
        if trainer_cfg.train_alpha and state.alphas:
            a_leaves, alphas = _with_grad(state.alphas)
        if supernet:
            chain_out, xent_out, new_bn, _ = nas_mod.apply_supernet(
                model_cfg, params, alphas, state.bn_state, batch["feats"],
                batch.get("ivectors"), mode=trainer_cfg.search_mode, tau=tau,
                generator=generator, train=True,
                bn_frozen=trainer_cfg.bn_frozen, dropout_p=dropout_p,
                mesh=mesh)
        else:
            chain_out, xent_out, new_bn = tdnnf_mod.apply_model(
                model_cfg, params, state.bn_state, batch["feats"],
                batch.get("ivectors"), train=True, generator=generator,
                dropout_p=dropout_p, mesh=mesh)
        loss, metrics = chain_objective(chain_out, xent_out, den,
                                        batch["sup"], trainer_cfg.objective,
                                        mesh=mesh)
        # the alpha-only terms are replicated: each rank adds its share,
        # and the all-reduced gradient holds each term once
        if (supernet and trainer_cfg.flops_coef > 0.0
                and "bottleneck" in alphas):
            ef = nas_mod.expected_flops(alphas["bottleneck"], model_cfg, tau)
            loss = loss + trainer_cfg.flops_coef * ef / world
            metrics["expected_bottleneck"] = ef.detach() / model_cfg.num_layers
        if supernet and trainer_cfg.alpha_entropy_coef > 0.0:
            ent = 0.0
            for _, a in tree_paths(alphas):
                p = torch.softmax(a, dim=-1)
                ent = ent + torch.sum(-p * torch.log(p + 1e-20))
            loss = loss + trainer_cfg.alpha_entropy_coef * ent / world
            metrics["alpha_entropy"] = ent.detach()
        grads = torch.autograd.grad(loss, p_leaves + a_leaves)
        if mesh is not None:
            grads = mesh.all_reduce_sum(grads)
        g_params, g_alphas = grads[:len(p_leaves)], grads[len(p_leaves):]
        with torch.no_grad():
            new_params, new_opt = state.params, state.opt_state
            if trainer_cfg.train_theta:
                new_params, new_opt = opt_update(g_params, state.opt_state,
                                                 state.params, state.step)
                if interval > 0 and state.step % interval == 0:
                    new_params = _apply_semiorth(new_params, base_cfg)
            new_alphas, new_aopt = state.alphas, state.alpha_opt_state
            if a_leaves:
                new_alphas, new_aopt = alpha_update(
                    g_alphas, state.alpha_opt_state, state.alphas, state.step,
                    lr_scale=trainer_cfg.optimizer.alpha_lr_scale)
            if trainer_cfg.bn_frozen:
                new_bn = state.bn_state
            metrics["tau"] = tau
            if dropout_p is not None:
                metrics["dropout_p"] = dropout_p
            metrics["grad_norm"] = torch.sqrt(
                sum(torch.sum(g * g) for g in g_params) + 1e-20)
        return TrainState(params=new_params, bn_state=new_bn,
                          opt_state=new_opt, step=state.step + 1,
                          alphas=new_alphas,
                          alpha_opt_state=new_aopt), metrics

    return step


def make_valid_step(model_cfg, trainer_cfg: TrainerConfig, den,
                    supernet: bool = False):
    """Eval-mode objective (stored BN stats, no sampling), the
    compute_prob_valid equivalent (`train.py:590-627`): a supernet mixes
    its branches by softmax at ``tau_min`` (the share branch only if the
    search mode is fixed).  valid(state, batch) -> metrics."""

    @torch.no_grad()
    def valid(state: TrainState, batch):
        if supernet:
            mode = (nas_mod.SearchMode.FIXED
                    if trainer_cfg.search_mode == nas_mod.SearchMode.FIXED
                    else nas_mod.SearchMode.SOFTMAX)
            chain_out, xent_out, _, _ = nas_mod.apply_supernet(
                model_cfg, state.params, state.alphas, state.bn_state,
                batch["feats"], batch.get("ivectors"), mode=mode,
                tau=trainer_cfg.tau_min, train=False)
        else:
            chain_out, xent_out, _ = tdnnf_mod.apply_model(
                model_cfg, state.params, state.bn_state, batch["feats"],
                batch.get("ivectors"), train=False)
        _, metrics = chain_objective(chain_out, xent_out, den, batch["sup"],
                                     trainer_cfg.objective)
        return metrics

    return valid
