"""Plain float32 forward passes of the two benchmarked networks.

Written from the network descriptions, in plain torch, with no kernel,
no mixed precision and no rate trick beyond the one the network defines:

* TDNN-F 7q (Kaldi swbd ``run_tdnn_7q.sh`` xconfig, as the configuration
  file states it): ``lda`` (fixed affine over the input spliced at
  -1,0,1 with the i-vector appended), ``tdnn1`` (affine, ReLU,
  batchnorm), 14 TDNN-F layers (linear at offsets (-s, 0) into the
  bottleneck, affine at (0, s) out of it, ReLU, batchnorm, bypass
  ``x = cur + 0.66 * prev``), ``prefinal_l`` (linear to 256) and the
  chain and xent heads (affine to 1536, ReLU, batchnorm, linear to 256,
  batchnorm, affine to the pdfs).  Layers from the first one whose
  later strides are all multiples of the frame-subsampling factor run at
  the subsampled rate, on the frames of the output's phase.
* The DARTS context-offset supernet over the same base: each TDNN-F
  sublayer holds K = max_stride + 1 branch weights, mixed by per-branch
  coefficients (uniform sampling: the sampled branch and the always-on
  share branch, weight 1 each); every layer runs at the full rate and the
  output is subsampled at the end.

Batchnorm normalises with the batch's statistics (training mode), no
learned scale or offset, epsilon 1e-3.  Spliced layers are one matmul
over the concatenated, shifted inputs.  Every product goes through
``prec.mm`` and every stored activation through ``prec.cast``, so a
control in a lower precision can replace both; ``F32`` is the
reference's own: float32 products (TF32 off) and no rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

BN_EPS = 1e-3


class Precision(NamedTuple):
    mm: Callable
    cast: Callable


F32 = Precision(mm=torch.matmul, cast=lambda x: x)


def batchnorm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 1))
    var = ((x - mean) ** 2).mean(dim=(0, 1))
    return (x - mean) / torch.sqrt(var + BN_EPS)


def spliced(x: torch.Tensor, w: torch.Tensor, shifts, prec) -> torch.Tensor:
    """sum_k x[t + shifts[k]] @ w[k] for output frames t = 0..T-1-max
    (shifts >= 0), as one product over the concatenated shifted inputs."""
    span = max(shifts)
    t_out = x.shape[1] - span
    cat = torch.cat([x[:, s: s + t_out] for s in shifts], dim=-1)
    return prec.mm(cat, w.reshape(-1, w.shape[-1]))


def input_layers(cfg: dict, p: dict, feats, ivectors, prec):
    t = feats.shape[1] - 2
    x = torch.cat([feats[:, o: o + t] for o in (0, 1, 2)], dim=-1)
    if cfg["ivector_dim"]:
        x = torch.cat([x, ivectors[:, None, :].expand(-1, t, -1)], dim=-1)
    x = prec.cast(prec.mm(x, p["lda"]["w"]) + p["lda"]["b"])
    x = prec.cast(prec.mm(x, p["tdnn1"]["w"]) + p["tdnn1"]["b"])
    return prec.cast(batchnorm(torch.relu(x)))


def heads(p: dict, x, prec):
    pl = prec.cast(prec.mm(x, p["prefinal_l"]))
    outs = []
    for head in ("chain", "xent"):
        hp = p[f"prefinal_{head}"]
        h = prec.cast(prec.mm(pl, hp["affine_w"]) + hp["affine_b"])
        h = prec.cast(batchnorm(torch.relu(h)))
        h = prec.cast(batchnorm(prec.cast(prec.mm(h, hp["linear"]))))
        op = p[f"output_{head}"]
        outs.append(prec.cast(prec.mm(h, op["w"])) + op["b"])
    return outs[0], outs[1]


def tdnnf_forward(cfg: dict, p: dict, feats, ivectors=None, prec=F32):
    """(chain [B, T_out, P], xent [B, T_out, P]) of the TDNN-F."""
    fs = cfg["frame_subsampling_factor"]
    strides = list(cfg["time_strides"])
    x = input_layers(cfg, p, feats, ivectors, prec)
    pos = 1  # input-frame position of x's frame 0
    left_total = 1 + sum(strides)
    sub_at = len(strides)
    while sub_at > 0 and strides[sub_at - 1] % fs == 0:
        sub_at -= 1
    rate = 1
    for i, s in enumerate(strides):
        if i == sub_at and fs > 1:
            x = x[:, (left_total - pos) % fs::fs]
            rate = fs
        q = s // rate
        lp = p[f"tdnnf{i + 2}"]
        if q:
            b = prec.cast(spliced(x, lp["linear"], (0, q), prec))
            cur = spliced(b, lp["affine"], (0, q), prec)
            prev = x[:, q: x.shape[1] - q]
        else:
            b = prec.cast(prec.mm(x, lp["linear"][0]))
            cur = prec.mm(b, lp["affine"][0])
            prev = x
        cur = prec.cast(cur + lp["affine_b"])
        cur = prec.cast(batchnorm(torch.relu(cur)))
        x = prec.cast(cur + cfg["bypass_scale"] * prev)
        pos += s
    if rate == 1 and fs > 1:
        x = x[:, 0::fs]
    return heads(p, x, prec)


def supernet_forward(cfg: dict, p: dict, coefs, feats, ivectors=None,
                     prec=F32):
    """(chain, xent) of the offsets supernet.  ``coefs[i]`` is layer i's
    (c_linear [K], c_affine [K]): c_linear[m] weighs the linear branch
    that reads x[t - m] with weight linear[m] (output frames aligned to
    the latest input frame); c_affine[j] the affine branch that reads the
    bottleneck at t + j with weight affine[j].  Zero coefficients drop
    their branch (no product is formed for it)."""
    fs = cfg["frame_subsampling_factor"]
    x = input_layers(cfg, p, feats, ivectors, prec)
    for i, (c_lin, c_aff) in enumerate(coefs):
        lp = p[f"tdnnf{i + 2}"]
        k = lp["linear"].shape[0]
        t_b = x.shape[1] - (k - 1)
        b = 0.0
        for m in range(k):
            if float(c_lin[m]) != 0.0:
                s = k - 1 - m
                b = b + c_lin[m] * prec.mm(x[:, s: s + t_b], lp["linear"][m])
        b = prec.cast(b)
        t_c = t_b - (k - 1)
        cur = 0.0
        for j in range(k):
            if float(c_aff[j]) != 0.0:
                cur = cur + c_aff[j] * prec.mm(b[:, j: j + t_c],
                                               lp["affine"][j])
        cur = prec.cast(cur + lp["affine_b"])
        cur = prec.cast(batchnorm(torch.relu(cur)))
        x = prec.cast(cur + cfg["bypass_scale"]
                      * x[:, k - 1: x.shape[1] - (k - 1)])
    return heads(p, x[:, 0::fs] if fs > 1 else x, prec)
