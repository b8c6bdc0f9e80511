"""Optimizer (port of ``tdnnf_nas_tpu.train.optimizer``).

Exponential LR schedule (`steps/libs/nnet3/train/common.py:606`), four
update rules (``kind``) and, shared by all of them, Kaldi's
per-component (0.75) and global (2.0) max-param-change clipping of the
update and decoupled weight decay:

  - ``adam``;
  - ``sgd``, with optional momentum;
  - ``adafactor``: factored (row/column) second moments per 2-D weight;
  - ``ng``: Kronecker-factored natural gradient, the reference's
    stand-in for Kaldi's NG-SGD (``OnlineNaturalGradient``,
    `nnet-tdnn-component.cc:592-624`): per-side gradient-covariance EMAs,
    their smoothed inverses recomputed by ``eigh`` every
    ``ng_update_period`` steps, the preconditioned direction rescaled to
    the gradient's norm.

Architecture logits get their own LR scale (``alpha_lr_scale``, the
explicit form of the reference's x10000 alpha-grad scale with
LearningRateFactor 1e-4, `nnet-tdnn-component.cc:588-590`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config


@dataclasses.dataclass(frozen=True)
class OptimizerConfig(Config):
    kind: str = "adam"  # adam | sgd | adafactor | ng
    lr_initial: float = 1e-3
    lr_final: float = 1e-4
    num_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.0  # sgd only
    max_change_per_leaf: float = 0.75  # Kaldi per-component max-change
    max_change_global: float = 2.0  # Kaldi --trainer.max-param-change
    l2_regularize: float = 0.0  # decoupled weight decay (per-leaf scalable)
    alpha_lr_scale: float = 1.0
    # kind="ng": trace smoothing R = C + alpha*(trC/dim)*I (Kaldi's alpha),
    # the covariance EMA, the inverse's recompute period, and the largest
    # side that is preconditioned (larger sides use the identity)
    ng_alpha: float = 4.0
    ng_decay: float = 0.95
    ng_update_period: int = 10
    ng_max_dim: int = 2048


def learning_rate_at(step: int, cfg: OptimizerConfig) -> float:
    """Exponential decay lr_initial -> lr_final over num_steps, in the
    reference's float32 arithmetic on an int32 step."""
    f32 = np.float32
    frac = np.clip(f32(np.int32(step)) / f32(max(cfg.num_steps, 1)),
                   f32(0.0), f32(1.0))
    return float(f32(cfg.lr_initial)
                 * f32(cfg.lr_final / cfg.lr_initial) ** frac)


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


def tree_get(tree, path):
    """The node of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


_KINDS = ("adam", "sgd", "adafactor", "ng")


def make_optimizer(
    cfg: OptimizerConfig,
    wd_scale_fn: Optional[Callable[[tuple], float]] = None,
):
    """Returns (init_fn, update_fn).

    init_fn(params) -> opt_state, the reference's structure for its kind:
      adam {"m": tree, "v": tree}; sgd {} or {"m": tree} with momentum;
      adafactor {"f": tree of {"vr", "vc"} (2-D and up) or {"v"}};
      ng {"ng": tree of {"cl", "pl"}? + {"cr", "pr"}?}, empty for a leaf
      with no preconditioned side.
    update_fn(grads, opt_state, params, step, lr_scale=1.0)
        -> (new_params, new_opt_state)

    ``grads`` is a list in :func:`tree_paths` order of ``params``; ``step``
    is a host int.  Per-leaf state is looked up by the parameter's path,
    never by position: an ``ng`` leaf's state may be an empty dict, which
    :func:`tree_paths` skips.  wd_scale_fn(path) -> relative weight-decay
    multiplier per leaf; effective decay = l2_regularize * scale * lr.
    """
    if cfg.kind not in _KINDS:
        raise ValueError(f"unknown optimizer kind {cfg.kind!r} "
                         f"(one of {', '.join(_KINDS)})")

    def _ng_zeros(p):
        """A leaf's ng state: its left side (all dims but the last,
        flattened) and its right side (the last dim) are preconditioned
        when at most ng_max_dim; a 1-D leaf has neither."""
        s = {}
        if p.ndim < 2:
            return s
        for d, c, pk in ((int(np.prod(p.shape[:-1])), "cl", "pl"),
                         (int(p.shape[-1]), "cr", "pr")):
            if d <= cfg.ng_max_dim:
                s[c] = torch.zeros((d, d), device=p.device)
                s[pk] = torch.eye(d, device=p.device)
        return s

    def _factored_zeros(p):
        if p.ndim >= 2:
            rows = int(np.prod(p.shape[:-1]))
            return {"vr": torch.zeros(rows, device=p.device),
                    "vc": torch.zeros(p.shape[-1], device=p.device)}
        return {"v": torch.zeros_like(p)}

    def init_fn(params):
        pl = tree_paths(params)
        per_leaf = lambda fn: tree_unflatten([(p, fn(x)) for p, x in pl])
        if cfg.kind == "adam":
            return {"m": per_leaf(torch.zeros_like),
                    "v": per_leaf(torch.zeros_like)}
        if cfg.kind == "ng":
            return {"ng": per_leaf(_ng_zeros)}
        if cfg.kind == "adafactor":
            return {"f": per_leaf(_factored_zeros)}
        if cfg.momentum > 0:
            return {"m": per_leaf(torch.zeros_like)}
        return {}

    def _inv_smoothed(c):
        """(C + damp I)^-1 by eigh, damp = alpha * tr(C)/dim; the matrix is
        symmetrised first, as jnp.linalg.eigh does (torch's reads one
        triangle, and g g^T is not exactly symmetric in float32)."""
        d = c.shape[0]
        damp = cfg.ng_alpha * (torch.trace(c) / d) + 1e-8
        a = c + damp * torch.eye(d, device=c.device)
        w, v = torch.linalg.eigh((a + a.T) / 2)
        return (v / torch.clamp(w, min=1e-12)) @ v.T

    @torch.no_grad()
    def update_fn(grads, opt_state, params, step: int, lr_scale=1.0):
        lr = float(np.float32(learning_rate_at(step, cfg))
                   * np.float32(lr_scale))
        pl = tree_paths(params)
        paths = [path for path, _ in pl]
        if cfg.kind == "adam":
            # bias corrections in float32, as the reference computes them
            t = np.float32(np.int32(step)) + np.float32(1.0)
            bc1 = float(np.float32(1.0) - np.float32(cfg.beta1) ** t)
            bc2 = float(np.float32(1.0) - np.float32(cfg.beta2) ** t)
            new_m = [cfg.beta1 * tree_get(opt_state["m"], p)
                     + (1 - cfg.beta1) * g for p, g in zip(paths, grads)]
            new_v = [cfg.beta2 * tree_get(opt_state["v"], p)
                     + (1 - cfg.beta2) * g * g for p, g in zip(paths, grads)]
            deltas = [-lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                      for m, v in zip(new_m, new_v)]
            new_state = {"m": tree_unflatten(list(zip(paths, new_m))),
                         "v": tree_unflatten(list(zip(paths, new_v)))}
        elif cfg.kind == "adafactor":
            b2 = cfg.beta2
            deltas, fs = [], []
            for p, g in zip(paths, grads):
                f = tree_get(opt_state["f"], p)
                if g.ndim >= 2:
                    g2d = g.reshape(-1, g.shape[-1])
                    g2 = g2d * g2d + 1e-30
                    vr = b2 * f["vr"] + (1 - b2) * torch.mean(g2, dim=1)
                    vc = b2 * f["vc"] + (1 - b2) * torch.mean(g2, dim=0)
                    vhat = torch.outer(vr, vc) / torch.clamp(
                        torch.mean(vr), min=1e-30)
                    deltas.append((-lr * g2d / (torch.sqrt(vhat) + cfg.eps)
                                   ).reshape(g.shape))
                    fs.append({"vr": vr, "vc": vc})
                else:
                    v = b2 * f["v"] + (1 - b2) * g * g
                    deltas.append(-lr * g / (torch.sqrt(v) + cfg.eps))
                    fs.append({"v": v})
            new_state = {"f": tree_unflatten(list(zip(paths, fs)))}
        elif cfg.kind == "ng":
            # G' = Pl G Pr with P = (C + damp I)^-1 of each side's
            # covariance EMA, rescaled to ||G||; the inverses are
            # recomputed every ng_update_period steps (step 0 included)
            recompute = step % cfg.ng_update_period == 0
            decay = cfg.ng_decay
            deltas, ss = [], []
            for p, g in zip(paths, grads):
                s = tree_get(opt_state["ng"], p)
                if not ("cl" in s or "cr" in s):
                    deltas.append(-lr * g)
                    ss.append(s)
                    continue
                g2d = g.reshape(-1, g.shape[-1])
                ns = dict(s)
                pre = g2d
                if "cl" in s:
                    cl = decay * s["cl"] + (1 - decay) * (
                        g2d @ g2d.T / g2d.shape[1])
                    ns["cl"] = cl
                    ns["pl"] = _inv_smoothed(cl) if recompute else s["pl"]
                    pre = ns["pl"] @ pre
                if "cr" in s:
                    cr = decay * s["cr"] + (1 - decay) * (
                        g2d.T @ g2d / g2d.shape[0])
                    ns["cr"] = cr
                    ns["pr"] = _inv_smoothed(cr) if recompute else s["pr"]
                    pre = pre @ ns["pr"]
                norm_g = torch.sqrt(torch.sum(torch.square(g2d)) + 1e-30)
                norm_p = torch.sqrt(torch.sum(torch.square(pre)) + 1e-30)
                pre = pre * (norm_g / norm_p)
                deltas.append((-lr * pre).reshape(g.shape))
                ss.append(ns)
            new_state = {"ng": tree_unflatten(list(zip(paths, ss)))}
        elif cfg.momentum > 0:
            new_m = [cfg.momentum * tree_get(opt_state["m"], p) + g
                     for p, g in zip(paths, grads)]
            deltas = [-lr * m for m in new_m]
            new_state = {"m": tree_unflatten(list(zip(paths, new_m)))}
        else:
            deltas = [-lr * g for g in grads]
            new_state = opt_state

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
        return new_params, new_state

    return init_fn, update_fn
