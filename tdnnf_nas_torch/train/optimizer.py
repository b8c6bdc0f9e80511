"""Optimizer (port of ``tdnnf_nas_tpu.train.optimizer``, Adam only).

Exponential LR schedule (`steps/libs/nnet3/train/common.py:606`), Adam
with Kaldi's per-component (0.75) and global (2.0) max-param-change
clipping of the update, and decoupled weight decay.  Architecture logits
get their own LR scale (``alpha_lr_scale``, the explicit form of the
reference's x10000 alpha-grad scale with LearningRateFactor 1e-4,
`nnet-tdnn-component.cc:588-590`).  The ``sgd``, ``adafactor`` and ``ng``
kinds are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tdnnf_nas_torch.core.config import Config


@dataclasses.dataclass(frozen=True)
class OptimizerConfig(Config):
    kind: str = "adam"
    lr_initial: float = 1e-3
    lr_final: float = 1e-4
    num_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_change_per_leaf: float = 0.75  # Kaldi per-component max-change
    max_change_global: float = 2.0  # Kaldi --trainer.max-param-change
    l2_regularize: float = 0.0  # decoupled weight decay (per-leaf scalable)
    alpha_lr_scale: float = 1.0


def learning_rate_at(step: int, cfg: OptimizerConfig) -> float:
    """Exponential decay lr_initial -> lr_final over num_steps."""
    frac = min(max(step / max(cfg.num_steps, 1), 0.0), 1.0)
    return cfg.lr_initial * (cfg.lr_final / cfg.lr_initial) ** frac


def tree_paths(tree, prefix=()):
    """[(path, leaf)] of a nested dict, keys sorted (the JAX leaf order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths_leaves):
    """Inverse of :func:`tree_paths`."""
    out = {}
    for path, leaf in paths_leaves:
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def make_optimizer(
    cfg: OptimizerConfig,
    wd_scale_fn: Optional[Callable[[tuple], float]] = None,
):
    """Returns (init_fn, update_fn).

    init_fn(params) -> opt_state {"m": ..., "v": ...}
    update_fn(grads, opt_state, params, step, lr_scale=1.0)
        -> (new_params, new_opt_state)

    ``grads`` is a list in :func:`tree_paths` order of ``params``; ``step``
    is a host int.  wd_scale_fn(path) -> relative weight-decay multiplier
    per leaf; effective decay = l2_regularize * scale * lr.
    """
    if cfg.kind != "adam":
        raise NotImplementedError(
            f"optimizer kind {cfg.kind!r} is not ported yet (adam only)")

    def init_fn(params):
        zeros = lambda: tree_unflatten(
            [(p, torch.zeros_like(x)) for p, x in tree_paths(params)])
        return {"m": zeros(), "v": zeros()}

    @torch.no_grad()
    def update_fn(grads, opt_state, params, step: int, lr_scale=1.0):
        lr = learning_rate_at(step, cfg) * lr_scale
        pl = tree_paths(params)
        ms = [x for _, x in tree_paths(opt_state["m"])]
        vs = [x for _, x in tree_paths(opt_state["v"])]
        t = step + 1.0
        bc1 = 1.0 - cfg.beta1 ** t
        bc2 = 1.0 - cfg.beta2 ** t
        new_m = [cfg.beta1 * m + (1 - cfg.beta1) * g for m, g in zip(ms, grads)]
        new_v = [cfg.beta2 * v + (1 - cfg.beta2) * g * g
                 for v, g in zip(vs, grads)]
        deltas = [-lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                  for m, v in zip(new_m, new_v)]
        if cfg.max_change_per_leaf > 0:
            deltas = [d * torch.clamp(cfg.max_change_per_leaf
                                      / torch.sqrt(torch.sum(d * d) + 1e-20),
                                      max=1.0)
                      for d in deltas]
        if cfg.max_change_global > 0:
            gn = torch.sqrt(sum(torch.sum(d * d) for d in deltas) + 1e-20)
            scale = torch.clamp(cfg.max_change_global / gn, max=1.0)
            deltas = [d * scale for d in deltas]
        if cfg.l2_regularize > 0:
            deltas = [d - lr * cfg.l2_regularize
                      * (wd_scale_fn(path) if wd_scale_fn else 1.0) * x
                      for d, (path, x) in zip(deltas, pl)]
        new_params = tree_unflatten(
            [(path, x + d) for (path, x), d in zip(pl, deltas)])
        paths = [path for path, _ in pl]
        new_state = {"m": tree_unflatten(list(zip(paths, new_m))),
                     "v": tree_unflatten(list(zip(paths, new_v)))}
        return new_params, new_state

    return init_fn, update_fn
