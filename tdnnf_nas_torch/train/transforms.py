"""Model transforms (port of ``tdnnf_nas_tpu.train.transforms``): the
principled replacement of nnet3's edit-directive sub-language
(`ReadEditConfig`, `nnet-utils.cc:1165-1415`) and the recipes'
sed-on-text-model surgery: each transform is a function
(cfg, params) -> (new_cfg, new_params).

Covered directives:
  apply-svd            -> svd_reduce_bottleneck / svd_factor
                          (`SvdApplier`, `nnet-utils.cc:651-760`)
  set-learning-rate-factor / freezing -> optimizer partitions
                          (TrainerConfig.train_theta/train_alpha)
  set-dropout-proportion / set-temperature-proportion -> per-step args
  convert-to-fixed-affine -> the lda leaf is never trained
                          (trainer._wd_scale)
  BatchNorm -> test mode -> TrainerConfig.bn_frozen

The SVDs run in float64 numpy on the host, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.models.tdnnf import TdnnfModelConfig


def svd_factor(w: np.ndarray, rank: int) -> Tuple[np.ndarray, np.ndarray,
                                                  float]:
    """Best rank-`rank` factorization of a 2-D matrix: w ~ a @ b.

    Returns (a [in, r], b [r, out], relative_frobenius_error), the math of
    Kaldi's `apply-svd` on one affine (`nnet-utils.cc:700-760`: U*sqrt(S)
    into the _b affine, sqrt(S)*V^T into the _a linear).
    """
    w = np.asarray(w, np.float64)
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    r = min(rank, s.shape[0])
    rs = np.sqrt(s[:r])
    a = (u[:, :r] * rs[None, :]).astype(np.float32)
    b = (rs[:, None] * vt[:r]).astype(np.float32)
    err = float(np.sqrt(np.sum(s[r:] ** 2) / max(np.sum(s**2), 1e-30)))
    return a, b, err


def svd_reduce_bottleneck(
    cfg: TdnnfModelConfig,
    params,
    new_dims: Sequence[int],
) -> Tuple[TdnnfModelConfig, dict]:
    """Shrink each tdnnf layer's bottleneck to new_dims[i] by SVD.

    The factored pair is linear [k_l, H, b] -> (time splice) -> affine
    [k_a, b, H].  SVD the stacked linear L [k_l*H, b] = U S V^T and keep
    the top-r right-singular basis V_r: the projection is time-local, so
    it commutes with the affine's time splicing, and

        linear' = L V_r  (reshaped back),   affine'_j = V_r^T affine_j

    reproduces the layer up to the discarded singular mass, the exact
    `apply-svd` semantics at the factored-TDNN-F level.  ``params`` are
    the port's tensors; each new factor goes back as float32 on its old
    factor's device.  Returns (new_cfg with bottleneck_dims=new_dims,
    new_params); biases and every non-tdnnf parameter are shared unchanged.
    """
    if len(new_dims) != cfg.num_tdnnf:
        raise ValueError(f"{len(new_dims)} dims for {cfg.num_tdnnf} layers")
    new_params = dict(params)
    for i, r in enumerate(new_dims):
        name = f"tdnnf{i + 2}"
        layer = dict(params[name])
        dev = layer["linear"].device
        lin = layer["linear"].detach().cpu().numpy().astype(np.float64)
        aff = layer["affine"].detach().cpu().numpy().astype(np.float64)
        k_l, h, b = lin.shape
        r = min(int(r), b)
        _, _, vt = np.linalg.svd(lin.reshape(k_l * h, b), full_matrices=False)
        v_r = vt[:r].T  # [b, r]
        layer["linear"] = torch.from_numpy(
            (lin.reshape(k_l * h, b) @ v_r).reshape(k_l, h, r)
            .astype(np.float32)).to(dev)
        layer["affine"] = torch.from_numpy(
            np.einsum("br,kbh->krh", v_r, aff).astype(np.float32)).to(dev)
        new_params[name] = layer
    new_cfg = cfg.replace(bottleneck_dims=tuple(int(d) for d in new_dims),
                          bottleneck_dim=cfg.bottleneck_dim)
    return new_cfg, new_params
