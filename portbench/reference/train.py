"""Plain training steps: the chain objective, Adam with Kaldi's
max-change, and the semi-orthogonal constraint.

* Objective: (1/N) sum_b [logZ_num - logZ_den] plus ``xent_regularize``
  times (1/N) sum gamma_num . log_softmax(xent); the loss is its
  negative.  N = B * T output frames; gamma_num = d logZ_num / d chain,
  held constant as the xent head's soft targets.
* Adam: bias-corrected moments, then each leaf's update scaled to at
  most ``max_change_per_leaf`` in norm, then all of them to at most
  ``max_change_global``; learning rate decays exponentially from
  ``lr_initial`` to ``lr_final`` over ``num_steps``.
* Semi-orthogonal constraint (Kaldi's ConstrainOrthonormal with the
  floating scale), every ``semiorth_interval`` steps from step 0, after
  the update, on every TDNN-F ``linear`` factor (its K offsets stacked as
  one [K*F, D] matrix), ``prefinal_l`` and both prefinal ``linear``
  factors: M <- M - 4 s / scale^2 (M M^T - scale^2 I) M, with M the
  weight or its transpose (rows <= columns), scale^2 = tr(P P) / tr(P),
  P = M M^T, and s = 1/8 slowed to 1/16 when tr(P P) rows / tr(P)^2
  exceeds 1.02 and to 1/64 when it exceeds 1.1 (the constant of the
  system's stated constraint).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import den as den_ref
from portbench.reference.model import F32, supernet_forward, tdnnf_forward


def leaves(tree, prefix=()):
    """[(path, tensor)] of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def rebuild(pairs):
    out = {}
    for path, x in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def step_seed(seed: int, step: int) -> int:
    """The seed of a step's random draws: a 64-bit function of (seed,
    step), as the system derives it."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0])


def uniform_coefs(seed: int, step: int, layers: int, k: int, device):
    """Per layer (c_linear, c_affine) of uniform one-hot path sampling:
    one branch drawn per sublayer, linear then affine, from a generator
    on ``device`` seeded ``step_seed(seed, step)``, joined by the share
    branch (linear index K-1, affine index 0)."""
    g = torch.Generator(device)
    g.manual_seed(step_seed(seed, step))
    out = []
    for _ in range(layers):
        pair = []
        for share in (k - 1, 0):
            c = torch.zeros(k, device=device)
            c[int(torch.randint(0, k, (), generator=g, device=device))] = 1.0
            c[share] = 1.0
            pair.append(c)
        out.append(tuple(pair))
    return out


def chain_loss(chain, xent, den: dict, sup: dict, xent_regularize: float,
               leaky: float):
    n = chain.shape[0] * chain.shape[1]
    logz_den = den_ref.den_logz(chain, den["trans"], den["state_pdf"],
                                den["init"], den["final"], leaky)
    logz_num = den_ref.num_logz(chain, sup["trans"], sup["state_pdf"],
                                sup["init"], sup["final"], sup["mask"])
    gamma, = torch.autograd.grad(logz_num.sum(), chain, retain_graph=True)
    objf = (logz_num.sum() - logz_den.sum()) / n
    xent_objf = (gamma.detach() * torch.log_softmax(xent, dim=-1)).sum() / n
    return -objf - xent_regularize * xent_objf


def learning_rate(step: int, opt: dict) -> float:
    frac = min(max(step / max(opt["num_steps"], 1), 0.0), 1.0)
    return opt["lr_initial"] * (opt["lr_final"] / opt["lr_initial"]) ** frac


def adam_update(params, grads, m, v, step: int, opt: dict):
    """New (params, m, v) lists, in the order of ``params``."""
    lr = learning_rate(step, opt)
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    t = step + 1
    m = [b1 * mi + (1 - b1) * g for mi, g in zip(m, grads)]
    v = [b2 * vi + (1 - b2) * g * g for vi, g in zip(v, grads)]
    d = [-lr * (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t)) + eps)
         for mi, vi in zip(m, v)]
    d = [x * min(1.0, opt["max_change_per_leaf"] / math.sqrt(
        float((x * x).sum()) + 1e-20)) for x in d]
    total = math.sqrt(sum(float((x * x).sum()) for x in d) + 1e-20)
    d = [x * min(1.0, opt["max_change_global"] / total) for x in d]
    return [p + x for p, x in zip(params, d)], m, v


def constrain_orthonormal(w: torch.Tensor) -> torch.Tensor:
    shape = w.shape
    w2 = w.reshape(-1, shape[-1])
    transposed = w2.shape[0] >= w2.shape[1]
    m = w2.T if transposed else w2
    p = m @ m.T
    tr_p, tr_pp = torch.trace(p), (p * p).sum()
    scale2 = tr_pp / tr_p
    ratio = float(tr_pp * p.shape[0] / (tr_p * tr_p))
    speed = 0.125 * (0.125 if ratio > 1.1 else 0.5 if ratio > 1.02 else 1.0)
    eye = torch.eye(p.shape[0], dtype=w.dtype, device=w.device)
    m = m - (4.0 * speed / scale2) * ((p - scale2 * eye) @ m)
    return (m.T if transposed else m).reshape(shape)


def constrained_paths(num_layers: int):
    paths = {("prefinal_l",), ("prefinal_chain", "linear"),
             ("prefinal_xent", "linear")}
    paths.update((f"tdnnf{i + 2}", "linear") for i in range(num_layers))
    return paths


class Trainer:
    """Follows a run's first steps from its initial parameters.

    ``forward(params, step, batch) -> (chain, xent)``; ``den`` the dense
    den as ``den_ref.den_logz`` takes it; ``cfg`` the configuration's
    ``training`` section.  ``step(batch)`` returns the step's loss (a
    float) and records the first step's gradients in ``first_grads``.
    """

    def __init__(self, params: dict, forward, den: dict, cfg: dict,
                 num_layers: int, dtype=None):
        dtype = torch.float32 if dtype is None else dtype
        self.paths = [p for p, _ in leaves(params)]
        self.params = [x.detach().clone().to(dtype)
                       for _, x in leaves(params)]
        self.m = [torch.zeros_like(x) for x in self.params]
        self.v = [torch.zeros_like(x) for x in self.params]
        self.forward, self.den, self.cfg = forward, den, cfg
        self.constrained = constrained_paths(num_layers)
        self.step_count = 0
        self.first_grads = None

    def tree(self, xs=None):
        return rebuild(list(zip(self.paths, self.params if xs is None
                                else xs)))

    def step(self, batch: dict) -> float:
        obj, opt = self.cfg["objective"], self.cfg["optimizer"]
        ps = [x.detach().requires_grad_(True) for x in self.params]
        chain, xent = self.forward(self.tree(ps), self.step_count, batch)
        loss = chain_loss(chain, xent, self.den, batch["sup"],
                          obj["xent_regularize"], obj["leaky_hmm_coef"])
        grads = torch.autograd.grad(loss, ps)
        if self.first_grads is None:
            self.first_grads = dict(zip(self.paths, grads))
        with torch.no_grad():
            self.params, self.m, self.v = adam_update(
                self.params, list(grads), self.m, self.v, self.step_count,
                opt)
            interval = self.cfg["semiorth_interval"]
            if interval > 0 and self.step_count % interval == 0:
                self.params = [constrain_orthonormal(x)
                               if p in self.constrained else x
                               for p, x in zip(self.paths, self.params)]
        self.step_count += 1
        return float(loss.detach())


def tdnnf_forward_fn(model_cfg: dict, prec=F32):
    def forward(params, step, batch):
        return tdnnf_forward(model_cfg, params, batch["feats"],
                             batch.get("ivectors"), prec)
    return forward


def supernet_forward_fn(model_cfg: dict, seed: int, prec=F32):
    k = model_cfg["max_stride"] + 1
    layers = len(model_cfg["time_strides"])

    def forward(params, step, batch):
        coefs = uniform_coefs(seed, step, layers, k, batch["feats"].device)
        return supernet_forward(model_cfg, params, coefs, batch["feats"],
                                batch.get("ivectors"), prec)
    return forward
