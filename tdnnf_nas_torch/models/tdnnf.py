"""Factored TDNN (TDNN-F) acoustic model (port of ``tdnnf_nas_tpu.models.tdnnf``).

The reference xconfig network (`run_tdnn_7q_fbk_40_manual.sh:127-159`):

  lda (fixed affine over Append(-1,0,1, ivector))
  -> tdnn1: affine -> ReLU -> BatchNorm -> dropout                 (dim 1536)
  -> tdnnf2..15: linear([-s,0] splice -> bottleneck, semi-orth)
                 -> affine([0,s] splice -> dim, +bias)
                 -> ReLU -> BatchNorm -> dropout
                 -> bypass: 0.66*prev + cur
  -> prefinal-l: linear -> 256 (semi-orth)
  -> prefinal-{chain,xent}: affine->1536 -> ReLU -> BN -> linear->256 -> BN
     -> output affine -> num_pdfs

Plain functions over a params dict with the JAX package's keys and
layouts (spliced weights [K, F, D]); batchnorm running stats live in a
separate dict.  Valid-convolution time semantics: the chunk input carries
exactly the model's left/right context.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.ops.tdnn import spliced_linear

BN_EPS = 1e-3  # Kaldi BatchNormComponent default epsilon
BN_DECAY = 0.98


@dataclasses.dataclass(frozen=True)
class TdnnfModelConfig(Config):
    """Flagship 7q shape by default (18,751,248 params at 6034 pdfs)."""

    feat_dim: int = 40
    ivector_dim: int = 100
    hidden_dim: int = 1536
    bottleneck_dim: int = 160
    # strides of tdnnf2..tdnnf15 (`run_tdnn_7q_fbk_40_manual.sh:137-151`)
    time_strides: Tuple[int, ...] = (1, 1, 1, 0, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3)
    # nonempty => per-layer (linear_stride, affine_stride) overrides
    time_strides_asym: Tuple[Tuple[int, int], ...] = ()
    bottleneck_dims: Tuple[int, ...] = ()  # empty => bottleneck_dim everywhere
    num_pdfs: int = 6034
    prefinal_big: int = 1536
    prefinal_small: int = 256
    bypass_scale: float = 0.66
    dropout_proportion: float = 0.0
    frame_subsampling_factor: int = 3
    compute_dtype: str = "bfloat16"
    # run trailing stride-divisible layers at the subsampled rate
    rate_optimize: bool = True

    @property
    def lda_dim(self) -> int:
        return self.feat_dim * 3 + self.ivector_dim

    def layer_bottleneck(self, i: int) -> int:
        if self.bottleneck_dims:
            return self.bottleneck_dims[i]
        return self.bottleneck_dim

    @property
    def num_tdnnf(self) -> int:
        return len(self.stride_pairs)

    @property
    def stride_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """(linear_stride, affine_stride) per tdnnf layer."""
        if self.time_strides_asym:
            return tuple(tuple(p) for p in self.time_strides_asym)
        return tuple((s, s) for s in self.time_strides)

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def model_context(cfg: TdnnfModelConfig) -> Tuple[int, int]:
    """(left, right) input context in original frames."""
    pairs = cfg.stride_pairs
    return (1 + sum(l for l, _ in pairs), 1 + sum(r for _, r in pairs))


def chunk_input_frames(cfg: TdnnfModelConfig, chunk_width: int) -> int:
    """Input frames needed for ``chunk_width`` output (subsampled) frames."""
    left, right = model_context(cfg)
    fs = cfg.frame_subsampling_factor
    return left + (chunk_width - 1) * fs + 1 + right


def _subsample_layer_index(cfg: TdnnfModelConfig) -> int:
    """Earliest tdnnf layer from which all later strides are multiples of
    the frame-subsampling factor (num_tdnnf when there is none)."""
    fs = cfg.frame_subsampling_factor
    pairs = cfg.stride_pairs
    if fs <= 1:
        return len(pairs)
    k = len(pairs)
    for i in range(len(pairs) - 1, -1, -1):
        l, r = pairs[i]
        if l % fs == 0 and r % fs == 0:
            k = i
        else:
            break
    return k


def _bn_dims(cfg: TdnnfModelConfig):
    yield "tdnn1", cfg.hidden_dim
    for i in range(cfg.num_tdnnf):
        yield f"tdnnf{i + 2}", cfg.hidden_dim
    for head in ("chain", "xent"):
        yield f"prefinal_{head}_big", cfg.prefinal_big
        yield f"prefinal_{head}_small", cfg.prefinal_small


def init_model(cfg: TdnnfModelConfig, generator: torch.Generator,
               device=DEFAULT_DEVICE):
    """Returns (params, bn_state) dicts of float32 tensors on ``device``.

    Same shapes and init scheme as the JAX package (N(0, 1/fan_in)
    weights, zero biases and output layers, identity lda); the random
    draws come from ``generator`` and so differ from jax.random's.
    """
    device = resolve_device(device)

    def normal(shape, fan_in):
        return _linear_init(generator, shape, fan_in, device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    params = {
        "lda": {"w": torch.eye(cfg.lda_dim, device=device),
                "b": zeros(cfg.lda_dim)},
        "tdnn1": {"w": normal((cfg.lda_dim, cfg.hidden_dim), cfg.lda_dim),
                  "b": zeros(cfg.hidden_dim)},
    }
    for i, (l, r) in enumerate(cfg.stride_pairs):
        k_lin = 2 if l > 0 else 1
        k_aff = 2 if r > 0 else 1
        bdim = cfg.layer_bottleneck(i)
        params[f"tdnnf{i + 2}"] = {
            "linear": normal((k_lin, cfg.hidden_dim, bdim),
                             k_lin * cfg.hidden_dim),
            "affine": normal((k_aff, bdim, cfg.hidden_dim), k_aff * bdim),
            "affine_b": zeros(cfg.hidden_dim),
        }
    params["prefinal_l"] = normal((cfg.hidden_dim, cfg.prefinal_small),
                                  cfg.hidden_dim)
    for head in ("chain", "xent"):
        params[f"prefinal_{head}"] = {
            "affine_w": normal((cfg.prefinal_small, cfg.prefinal_big),
                               cfg.prefinal_small),
            "affine_b": zeros(cfg.prefinal_big),
            "linear": normal((cfg.prefinal_big, cfg.prefinal_small),
                             cfg.prefinal_big),
        }
        params[f"output_{head}"] = {
            "w": zeros(cfg.prefinal_small, cfg.num_pdfs),
            "b": zeros(cfg.num_pdfs),
        }
    return params, _init_bn_state(cfg, device)


def _linear_init(generator: torch.Generator, shape, in_dim: int, device):
    """N(0, 1/in_dim) float32 weights, drawn on the host's generator."""
    return (torch.randn(shape, generator=generator)
            / np.sqrt(in_dim)).to(device)


def _init_bn_state(cfg: TdnnfModelConfig, device):
    """Batchnorm running stats: mean 0, var 1 for every normalized layer."""
    return {name: {"mean": torch.zeros(dim, device=device),
                   "var": torch.ones(dim, device=device)}
            for name, dim in _bn_dims(cfg)}


def _batchnorm(x: torch.Tensor, stats, train: bool, mesh=None):
    """Kaldi-style batchnorm: pure normalization, no learned scale/offset.

    Returns (normalized, new_stats); x: [B, T, D], statistics over (B, T)
    in float32, output in x's dtype.  New running stats are detached.
    Under a data-parallel ``mesh`` (``parallel.mesh.Mesh``; x is this
    rank's rows) the statistics are the global batch's: the sums and
    sums of squares go through a differentiable all-reduce, so the
    gradient through the statistics is the global batch's too.
    """
    if train:
        xf = x.float()
        if mesh is None:
            mean = xf.mean(dim=(0, 1))
            var = torch.square(xf).mean(dim=(0, 1)) - mean ** 2
        else:
            n = xf.shape[0] * xf.shape[1] * mesh.size
            sums = mesh.all_reduce_grad(torch.stack(
                [xf.sum(dim=(0, 1)), torch.square(xf).sum(dim=(0, 1))]))
            mean = sums[0] / n
            var = sums[1] / n - mean ** 2
        new_stats = {
            "mean": (BN_DECAY * stats["mean"]
                     + (1 - BN_DECAY) * mean).detach(),
            "var": (BN_DECAY * stats["var"] + (1 - BN_DECAY) * var).detach(),
        }
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + BN_EPS)
    return ((x - mean) * inv).to(x.dtype), new_stats


def _dropout_keep(p) -> np.float32:
    """Keep probability 1 - p in float32, as the reference computes it."""
    return np.float32(1.0) - np.float32(p)


def _apply_dropout(x: torch.Tensor, mask: torch.Tensor, p) -> torch.Tensor:
    """x * mask / max(1 - p, 1e-3), mask and scale cast to x's dtype
    first, as the reference does; ``p`` may be a host float from the
    dropout schedule."""
    keep = max(_dropout_keep(p), np.float32(1e-3))
    scale = torch.tensor(keep, dtype=torch.float32,
                         device=x.device).to(x.dtype)
    return x * mask.to(x.dtype) / scale


def _dropout(x: torch.Tensor, p, generator: Optional[torch.Generator],
             train: bool, mesh=None):
    """Per-dim dropout mask shared across time (Kaldi's
    GeneralDropoutComponent); no dropout without a generator.  Under a
    data-parallel ``mesh`` every rank draws the global batch's mask from
    the same generator state and keeps its own rows, so the ranks
    together drop what one process would."""
    if not train or generator is None or p <= 0.0:
        return x
    rows = x.shape[0] * (1 if mesh is None else mesh.size)
    mask = torch.bernoulli(
        torch.full((rows, 1, x.shape[-1]), float(_dropout_keep(p)),
                   device=x.device), generator=generator)
    if mesh is not None:
        mask = mask[mesh.rows(rows)]
    return _apply_dropout(x, mask, p)


def _bypass(cur: torch.Tensor, prev: torch.Tensor, scale: float):
    """The TDNN-F bypass cur + scale * prev, the scale cast to cur's dtype
    before it multiplies, as the reference does (in bf16 it scales by
    bf16(0.66) = 0.66015625).  With LHUC scales one of cur and prev may
    be float32 and the other bf16; jnp then multiplies in float32, where
    torch would keep a 0-dim scale's product in prev's dtype, so both
    operands are promoted first."""
    dt = torch.promote_types(cur.dtype, prev.dtype)
    s = torch.tensor(scale, dtype=cur.dtype, device=cur.device).to(dt)
    return cur + s * prev.to(dt)


def _input_layers(cfg: TdnnfModelConfig, params, bn_state, new_bn, feats,
                  ivectors, bn_train: bool, mesh=None) -> torch.Tensor:
    """lda (splice -1,0,1 + appended constant-t ivector, fixed affine) and
    tdnn1 (affine, ReLU, batchnorm); writes tdnn1's stats into new_bn.
    Shared by the plain model and the supernet."""
    dt = cfg.dtype
    t_spliced = feats.shape[1] - 2
    spl = torch.cat([feats[:, o + 1: o + 1 + t_spliced] for o in (-1, 0, 1)],
                    dim=-1)
    if cfg.ivector_dim:
        if ivectors is None:
            raise ValueError("model configured with ivectors")
        iv = ivectors[:, None, :].expand(spl.shape[0], t_spliced,
                                         cfg.ivector_dim)
        spl = torch.cat([spl, iv], dim=-1)
    x = (torch.matmul(spl.to(dt), params["lda"]["w"].to(dt)).float()
         + params["lda"]["b"]).to(dt)
    x = (torch.matmul(x, params["tdnn1"]["w"].to(dt)).float()
         + params["tdnn1"]["b"]).to(dt)
    x = torch.relu(x)
    x, new_bn["tdnn1"] = _batchnorm(x, bn_state["tdnn1"], bn_train, mesh)
    return x


def apply_model(
    cfg: TdnnfModelConfig,
    params,
    bn_state,
    feats: torch.Tensor,
    ivectors: Optional[torch.Tensor] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    dropout_p: Optional[float] = None,
    post_bn_scales=None,
    layer_activations=None,
    mesh=None,
):
    """Forward pass.

    feats: [B, T_in, feat_dim] (T_in from chunk_input_frames());
    ivectors: [B, ivector_dim] when cfg.ivector_dim > 0; ``generator``
    draws the dropout masks (no dropout without one); ``dropout_p``
    overrides the config's proportion (the trainer's schedule);
    ``post_bn_scales``: optional {layer_name: [hidden]} float32 scales
    multiplied in after that layer's batchnorm, before dropout and the
    bypass (LHUC, models/lhuc.py).  As in the reference, a bf16
    activation times a float32 scale is float32, and the layers after it
    see that.  ``layer_activations``: optional {layer_name: callable}
    replacing the ReLU of individual tdnnf layers (GP activations,
    models/bayes.py).  ``mesh``: a data-parallel ``parallel.mesh.Mesh``
    when ``feats`` are this rank's rows of a global batch (batchnorm's
    statistics and the dropout masks are then the global batch's).

    Returns (chain_logits [B, T_out, P], xent_logits [B, T_out, P],
    new_bn_state) at the subsampled rate, logits in float32.
    """
    new_bn = {}
    dp = cfg.dropout_proportion if dropout_p is None else dropout_p
    x = _input_layers(cfg, params, bn_state, new_bn, feats, ivectors, train,
                      mesh)
    x = _scale(x, post_bn_scales, "tdnn1")
    x = _dropout(x, dp, generator, train, mesh)

    chain, xent = tdnnf_stack_and_heads(cfg, params, bn_state, new_bn, x,
                                        train, generator, consumed_left=1,
                                        dropout_p=dp,
                                        post_bn_scales=post_bn_scales,
                                        layer_activations=layer_activations,
                                        mesh=mesh)
    return chain, xent, new_bn


def _scale(x: torch.Tensor, scales, name: str) -> torch.Tensor:
    """x * scales[name] where the layer has a scale (torch promotes a bf16
    x times a float32 scale to float32, as jnp does)."""
    if scales is None or name not in scales:
        return x
    return x * scales[name]


def tdnnf_stack_and_heads(cfg: TdnnfModelConfig, params, bn_state, new_bn,
                          x, train, generator, consumed_left: int = 1,
                          dropout_p: float = 0.0, post_bn_scales=None,
                          layer_activations=None, mesh=None):
    """The tdnnf stack + prefinal/output heads on a hidden sequence x.

    consumed_left: original-frame position of x's frame 0, which fixes the
    phase of the rate-optimized subsample; ``post_bn_scales``,
    ``layer_activations`` and ``mesh`` as in :func:`apply_model`.  Shared
    by the plain and the CNN front-end models.
    """
    dt = cfg.dtype
    fs = cfg.frame_subsampling_factor
    pairs = cfg.stride_pairs
    sub_at = _subsample_layer_index(cfg) if cfg.rate_optimize else len(pairs)
    left_total = consumed_left + sum(l for l, _ in pairs)
    subsampled = False
    for i, (l, r) in enumerate(pairs):
        if i == sub_at and not subsampled and fs > 1:
            # keep positions == left_total (mod fs) in original coords
            p_k = consumed_left + sum(pl for pl, _ in pairs[:i])
            phase = (left_total - p_k) % fs
            x = x[:, phase::fs]
            subsampled = True
        if subsampled:
            l, r = l // fs, r // fs
        name = f"tdnnf{i + 2}"
        p = params[name]
        lin_off = (-l, 0) if l > 0 else (0,)
        aff_off = (0, r) if r > 0 else (0,)
        bottleneck = spliced_linear(x, p["linear"], lin_off,
                                    compute_dtype=dt).to(dt)
        cur = spliced_linear(bottleneck, p["affine"], aff_off,
                             bias=p["affine_b"], compute_dtype=dt).to(dt)
        act = (layer_activations or {}).get(name, torch.relu)
        cur = act(cur)
        cur, new_bn[name] = _batchnorm(cur, bn_state[name], train, mesh)
        cur = _scale(cur, post_bn_scales, name)
        cur = _dropout(cur, dropout_p, generator, train, mesh)
        prev = x[:, l: x.shape[1] - r] if (l or r) else x
        x = _bypass(cur, prev, cfg.bypass_scale)

    if not subsampled and fs > 1:
        x = x[:, 0::fs]

    pl = torch.matmul(x.to(dt), params["prefinal_l"].to(dt)).to(dt)
    outs = []
    for head in ("chain", "xent"):
        hp = params[f"prefinal_{head}"]
        h = (torch.matmul(pl, hp["affine_w"].to(dt)).float()
             + hp["affine_b"]).to(dt)
        h = torch.relu(h)
        h, new_bn[f"prefinal_{head}_big"] = _batchnorm(
            h, bn_state[f"prefinal_{head}_big"], train, mesh)
        h = torch.matmul(h.to(dt), hp["linear"].to(dt)).to(dt)
        h, new_bn[f"prefinal_{head}_small"] = _batchnorm(
            h, bn_state[f"prefinal_{head}_small"], train, mesh)
        op = params[f"output_{head}"]
        outs.append(torch.matmul(h.to(dt), op["w"].to(dt)).float() + op["b"])
    return outs[0], outs[1]


def semiorth_param_paths(cfg: TdnnfModelConfig):
    """Param paths under the semi-orthogonal constraint: every tdnnf
    ``linear`` factor, prefinal-l and the prefinal ``linear`` factors."""
    paths = [("prefinal_l",)]
    for i in range(cfg.num_tdnnf):
        paths.append((f"tdnnf{i + 2}", "linear"))
    for head in ("chain", "xent"):
        paths.append((f"prefinal_{head}", "linear"))
    return paths


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def count_params(params) -> int:
    """Total parameter count (works on tensors, arrays or shape stand-ins)."""
    return int(sum(int(np.prod(p.shape)) for p in _leaves(params)))


def estimate_lda(spliced_feats: np.ndarray, ridge: float = 1e-3
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Whitening preconditioner over spliced input features (numpy, as in
    the reference): zero-mean + decorrelate + unit-variance linear map
    (w, b) with y = x @ w + b, the stand-in for the reference's LDA-like
    preconditioning matrix estimated from egs
    (`steps/nnet3/chain/train.py:426-434`)."""
    x = spliced_feats.reshape(-1, spliced_feats.shape[-1]).astype(np.float64)
    mean = x.mean(axis=0)
    cov = np.cov(x - mean, rowvar=False) + ridge * np.eye(x.shape[1])
    evals, evecs = np.linalg.eigh(cov)
    w = evecs @ np.diag(1.0 / np.sqrt(np.maximum(evals, 1e-8))) @ evecs.T
    b = -mean @ w
    return w.astype(np.float32), b.astype(np.float32)
