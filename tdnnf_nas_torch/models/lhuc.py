"""LHUC speaker adaptation, Learning Hidden Unit Contributions (port of
``tdnnf_nas_tpu.models.lhuc``).

The reference's +LHUC rows (`img/search_result.png`, BASELINE.md rows
5-8): a per-speaker scale on each hidden layer's activations,

    h_l <- (2 * sigmoid(a_l[speaker])) * h_l

with only the logits a_l trained on the speaker's adaptation data, the
acoustic model frozen.  Logits start at 0, so the scales start at 1.
They multiply after each layer's batchnorm, before dropout and the
bypass (``models/tdnnf.apply_model``'s ``post_bn_scales``).  Each step
takes the chain objective's gradient through the den scan, so on a
``BlockedDenGraph`` it launches the blocked forward and adjoint kernels
once each.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.models import tdnnf as base
from tdnnf_nas_torch.train.objective import chain_objective


def init_lhuc(cfg: base.TdnnfModelConfig,
              device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Zero float32 logits (identity scales) for tdnn1 and every tdnnf
    layer, on ``device``."""
    device = resolve_device(device)
    names = ["tdnn1"] + [f"tdnnf{i + 2}" for i in range(cfg.num_tdnnf)]
    return {k: torch.zeros(cfg.hidden_dim, device=device) for k in names}


def lhuc_scales(lhuc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: 2.0 * torch.sigmoid(v) for k, v in lhuc.items()}


def apply_model_lhuc(
    cfg: base.TdnnfModelConfig,
    params,
    bn_state,
    lhuc,
    feats: torch.Tensor,
    ivectors: Optional[torch.Tensor] = None,
    train: bool = False,
):
    """Forward with LHUC scaling (one speaker's logits for the whole
    batch).  Returns (chain, xent, new_bn)."""
    return base.apply_model(cfg, params, bn_state, feats, ivectors,
                            train=train, post_bn_scales=lhuc_scales(lhuc))


def _lhuc_step(cfg, objective_cfg, lr: float, l2: float, params, bn_state,
               den, lhuc, batch):
    """One frozen-model SGD step on the LHUC logits: returns (new logits,
    metrics).  ``l2`` decays the logits toward 0 (unit scales), decoupled
    from the gradient: new = (1 - lr * l2) * a - lr * grad."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in lhuc.items()}
    with torch.enable_grad():
        chain, xent, _ = apply_model_lhuc(cfg, params, bn_state, leaves,
                                          batch["feats"],
                                          batch.get("ivectors"), train=False)
        loss, metrics = chain_objective(chain, xent, den, batch["sup"],
                                        objective_cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    new = {k: ((1.0 - lr * l2) * v.detach() - lr * g)
           for (k, v), g in zip(leaves.items(), grads)}
    return new, metrics


def adapt_lhuc(
    cfg: base.TdnnfModelConfig,
    params,
    bn_state,
    den,
    objective_cfg,
    batches,
    num_steps: int = 20,
    lr: float = 0.1,
    l2: float = 0.0,
    on_step=None,
    device=DEFAULT_DEVICE,
):
    """Train LHUC logits on a speaker's adaptation batches by plain SGD,
    the model frozen (``params`` and ``bn_state`` take no gradient;
    batchnorm uses its running stats).

    ``batches``: a sequence of device batches {"feats", "sup",
    ["ivectors"]}, cycled for ``num_steps`` steps; ``den`` the
    objective's den graph on ``device``; ``on_step(metrics)`` sees each
    step's metrics.  Returns (logits, the last step's metrics)."""
    device = resolve_device(device)
    lhuc = init_lhuc(cfg, device)
    metrics = None
    for i in range(num_steps):
        lhuc, metrics = _lhuc_step(cfg, objective_cfg, lr, float(l2), params,
                                   bn_state, den, lhuc,
                                   batches[i % len(batches)])
        if on_step is not None:
            on_step(metrics)
    return lhuc, metrics
