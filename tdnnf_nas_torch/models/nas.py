"""DARTS supernets: context-offset and bottleneck-dim search (port of
``tdnnf_nas_tpu.models.nas``).

* **Context-offset supernet** (`TdnnDARTSV3Component`,
  `nnet-tdnn-component.cc:38-1012`): each tdnnf sublayer holds K
  candidate branches (linear offsets -(K-1)..0, affine offsets 0..K-1)
  with per-branch weights [K, F, D] and architecture logits alpha.  The
  branch mixing coefficients per mode (`.cc:256-289`):

    - ``uniform``  : one branch sampled uniformly, weight 1, plus the
                     always-on share branch (offset 0);
    - ``gumbel``   : softmax((alpha + G) / tau), G = -log(-log U), share
                     branch forced to 1;
    - ``softmax``  : softmax(alpha / tau), share branch forced to 1;
    - ``free``     : sigmoid(alpha) on every branch;
    - ``argmax_st``: hard one-hot forward, softmax straight-through grad;
    - ``fixed``    : the share branch only.

* **Bottleneck-dim supernet**: one wide bottleneck masked by nested group
  masks (candidate k activates groups 0..k), with the analytic expected
  FLOPs as its penalty.

Both searches can be active at once, and a bottleneck supernet may take
fixed (searched) offsets.  Plain functions over the JAX package's dict
keys; architecture logits live in their own dict, outside ``params``.

Every random draw (uniform indices, Gumbel uniforms, dropout masks) goes
through :func:`draw_noise`, on the device, from one ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.models import tdnnf as base
from tdnnf_nas_torch.ops.tdnn import spliced_linear

# default bottleneck candidate group widths (cumsum = candidate dims)
BOTTLENECK_GROUPS = (25, 25, 30, 20, 20, 40, 40, 40)
BOTTLENECK_DIMS = tuple(np.cumsum(BOTTLENECK_GROUPS).tolist())  # (25,...,240)


class SearchMode:
    UNIFORM = "uniform"
    GUMBEL = "gumbel"
    SOFTMAX = "softmax"
    FREE = "free"
    ARGMAX_ST = "argmax_st"  # hard one-hot fwd, softmax straight-through grad
    FIXED = "fixed"  # no search: share branch only (diagnostics)


@dataclasses.dataclass(frozen=True)
class DartsModelConfig(Config):
    """Supernet config wrapping the base TDNN-F shape.

    search_offsets: K = max_stride + 1 candidate offsets per sublayer.
    search_bottleneck: nested-mask bottleneck of sum(bottleneck_groups).
    When search_offsets is False, fixed_strides gives each layer's
    (linear, affine) offsets (the base config's when empty).
    """

    base: base.TdnnfModelConfig = dataclasses.field(
        default_factory=base.TdnnfModelConfig)
    search_offsets: bool = True
    max_stride: int = 6
    fixed_strides: Tuple[Tuple[int, int], ...] = ()
    search_bottleneck: bool = False
    bottleneck_groups: Tuple[int, ...] = BOTTLENECK_GROUPS
    sample_per_sequence: bool = False
    # the reference's switch to its one-layer-body lax.scan stack, kept so
    # its configs carry across; the port always runs the unrolled stack,
    # which the reference holds equal to the scanned one
    scan_layers: bool = True

    @property
    def num_candidates(self) -> int:
        return self.max_stride + 1

    @property
    def num_layers(self) -> int:
        return self.base.num_tdnnf

    @property
    def bottleneck_candidates(self) -> Tuple[int, ...]:
        return tuple(np.cumsum(self.bottleneck_groups).tolist())

    @property
    def supernet_bottleneck(self) -> int:
        return (int(sum(self.bottleneck_groups)) if self.search_bottleneck
                else self.base.bottleneck_dim)


def supernet_context(cfg: DartsModelConfig) -> Tuple[int, int]:
    """Max (left, right) context over all candidate branches."""
    if cfg.search_offsets:
        k = cfg.max_stride * cfg.num_layers
        return (1 + k, 1 + k)
    pairs = _fixed_pairs(cfg)
    return (1 + sum(l for l, _ in pairs), 1 + sum(r for _, r in pairs))


def _fixed_pairs(cfg: DartsModelConfig):
    return cfg.fixed_strides or cfg.base.stride_pairs


def init_supernet(cfg: DartsModelConfig, generator: torch.Generator,
                  device=DEFAULT_DEVICE):
    """Returns (params, alphas, bn_state) dicts of float32 tensors.

    alphas: {"offsets_linear": [L, K], "offsets_affine": [L, K],
    "bottleneck": [L, C]}, only the active search axes, all zero.  Same
    keys, shapes and init scheme as the JAX package; the weights come from
    ``generator`` and so differ from jax.random's.
    """
    device = resolve_device(device)
    b = cfg.base

    def normal(shape, fan_in):
        return base._linear_init(generator, shape, fan_in, device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    params = {
        "lda": {"w": torch.eye(b.lda_dim, device=device),
                "b": zeros(b.lda_dim)},
        "tdnn1": {"w": normal((b.lda_dim, b.hidden_dim), b.lda_dim),
                  "b": zeros(b.hidden_dim)},
    }
    bdim = cfg.supernet_bottleneck
    for i in range(cfg.num_layers):
        if cfg.search_offsets:
            k = cfg.num_candidates
            lin_shape, aff_shape = (k, b.hidden_dim, bdim), (k, bdim,
                                                             b.hidden_dim)
            lin_fan, aff_fan = b.hidden_dim * 2, bdim * 2  # ~2 live branches
        else:
            l, r = _fixed_pairs(cfg)[i]
            lin_shape = (2 if l > 0 else 1, b.hidden_dim, bdim)
            aff_shape = (2 if r > 0 else 1, bdim, b.hidden_dim)
            lin_fan, aff_fan = lin_shape[0] * b.hidden_dim, aff_shape[0] * bdim
        params[f"tdnnf{i + 2}"] = {
            "linear": normal(lin_shape, lin_fan),
            "affine": normal(aff_shape, aff_fan),
            "affine_b": zeros(b.hidden_dim),
        }
    params["prefinal_l"] = normal((b.hidden_dim, b.prefinal_small),
                                  b.hidden_dim)
    for head in ("chain", "xent"):
        params[f"prefinal_{head}"] = {
            "affine_w": normal((b.prefinal_small, b.prefinal_big),
                               b.prefinal_small),
            "affine_b": zeros(b.prefinal_big),
            "linear": normal((b.prefinal_big, b.prefinal_small),
                             b.prefinal_big),
        }
        params[f"output_{head}"] = {"w": zeros(b.prefinal_small, b.num_pdfs),
                                    "b": zeros(b.num_pdfs)}
    alphas = {}
    if cfg.search_offsets:
        alphas["offsets_linear"] = zeros(cfg.num_layers, cfg.num_candidates)
        alphas["offsets_affine"] = zeros(cfg.num_layers, cfg.num_candidates)
    if cfg.search_bottleneck:
        alphas["bottleneck"] = zeros(cfg.num_layers,
                                     len(cfg.bottleneck_groups))
    return params, alphas, base._init_bn_state(b, device)


def draw_noise(kind: str, shape, generator: Optional[torch.Generator],
               device, arg) -> torch.Tensor:
    """Every random draw of the supernet, on ``device`` from ``generator``.

    kind "randint": indices in [0, arg) (uniform path sampling);
    "uniform": U[1e-8, 1 - 1e-8) in float32 (the Gumbel noise's source);
    "bernoulli": a 0/1 float mask with P(1) = arg (dropout).  Parity
    tests replace this function with the draws the JAX package made.
    """
    if generator is None:
        raise ValueError(f"a {kind} draw of the supernet needs a generator")
    if kind == "randint":
        return torch.randint(0, int(arg), tuple(shape), generator=generator,
                             device=device)
    if kind == "uniform":
        u = torch.rand(tuple(shape), generator=generator, device=device)
        return u.clamp(1e-8, 1.0 - 1e-8)
    if kind == "bernoulli":
        return torch.bernoulli(torch.full(tuple(shape), float(arg),
                                          device=device), generator=generator)
    raise ValueError(f"unknown draw {kind!r}")


def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx.long(), k).float()


def branch_coefs(alpha: torch.Tensor, mode: str, tau: float,
                 generator: Optional[torch.Generator],
                 share_index: Optional[int],
                 batch: Optional[int] = None) -> torch.Tensor:
    """Per-branch mixing coefficients for one DARTS sublayer.

    alpha: [K] logits.  Returns [K] (or [B, K] when batch is not None).
    The share branch is forced to 1 except in free mode (and is the union
    with the sample in uniform mode); the set is out of place, so the
    other entries keep their gradient to alpha.
    """
    k = alpha.shape[-1]
    shape = (batch, k) if batch is not None else (k,)
    dev = alpha.device
    if mode == SearchMode.FIXED:
        if share_index is None:  # the reference's .at[..., None].set(1.0)
            return torch.ones(shape, device=dev)
        return _one_hot(torch.full(shape[:-1], share_index, device=dev), k)
    if mode == SearchMode.UNIFORM:
        coef = _one_hot(draw_noise("randint", shape[:-1], generator, dev, k),
                        k)
        if share_index is not None:  # share always on (union with sample)
            coef = torch.maximum(coef, _one_hot(
                torch.full(shape[:-1], share_index, device=dev), k))
        return coef
    if mode == SearchMode.ARGMAX_ST:
        # hard one-hot forward, softmax gradient (straight-through), the
        # ArgmaxOnehotFunctionComponent (`nnet-simple-component.cc:9859`)
        soft = torch.softmax(alpha / tau, dim=-1).expand(shape)
        hard = _one_hot(torch.argmax(alpha, dim=-1), k).expand(shape)
        coef = hard + soft - soft.detach()
    elif mode == SearchMode.GUMBEL:
        u = draw_noise("uniform", shape, generator, dev, None)
        g = -torch.log(-torch.log(u))
        coef = torch.softmax((alpha + g) / tau, dim=-1)
    elif mode == SearchMode.SOFTMAX:
        coef = torch.softmax(alpha / tau, dim=-1).expand(shape)
    elif mode == SearchMode.FREE:
        return torch.sigmoid(alpha).expand(shape)
    else:
        raise ValueError(f"unknown mode {mode}")
    if mode != SearchMode.ARGMAX_ST:  # the floor would kill the ST gradient
        coef = torch.clamp(coef, min=1e-20)
    if share_index is not None:
        share = torch.arange(k, device=dev) == share_index
        coef = torch.where(share, torch.ones((), device=dev), coef)
    return coef


def _bottleneck_mask(coef: torch.Tensor, groups: Tuple[int, ...]):
    """coef [..., C] candidate weights -> [..., sum(groups)] mask: group g
    gets sum_{j >= g} coef_j (candidate j activates groups 0..j)."""
    rc = torch.flip(torch.cumsum(torch.flip(coef, (-1,)), dim=-1), (-1,))
    reps = torch.tensor(groups, device=coef.device)
    return torch.repeat_interleave(rc, reps, dim=-1,
                                   output_size=int(sum(groups)))


def expected_flops(alphas_bottleneck: torch.Tensor, cfg: DartsModelConfig,
                   tau: float = 1.0) -> torch.Tensor:
    """Differentiable expected bottleneck width summed over layers,
    E_coef[dim] with coef = softmax(alpha / tau) (the SoftmaxFlopsComponent
    penalty, `nnet-simple-component.cc:10144-10152`)."""
    dims = torch.tensor(cfg.bottleneck_candidates, dtype=torch.float32,
                        device=alphas_bottleneck.device)
    coef = torch.softmax(alphas_bottleneck / tau, dim=-1)
    return torch.sum(coef * dims)


def apply_supernet(
    cfg: DartsModelConfig,
    params,
    alphas,
    bn_state,
    feats: torch.Tensor,
    ivectors: Optional[torch.Tensor] = None,
    mode: str = SearchMode.UNIFORM,
    tau: float = 1.0,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    bn_frozen: bool = False,
    dropout_p: Optional[float] = None,
    mesh=None,
):
    """Supernet forward.

    mode/tau: search mode and Gumbel/softmax temperature.  ``generator``
    draws the path samples and, in training, the dropout masks (no dropout
    without one).  bn_frozen: stored BN stats even in training (the
    cv-update stage).  ``dropout_p`` overrides the base config's
    proportion.  ``mesh``: a data-parallel ``parallel.mesh.Mesh`` when
    ``feats`` are this rank's rows of a global batch (batchnorm's
    statistics, the dropout masks and per-sequence samples are then the
    global batch's: each rank draws them whole and keeps its rows).

    Returns (chain_logits, xent_logits, new_bn_state, coefs), coefs the
    sampled or relaxed branch weights per sublayer.
    """
    b = cfg.base
    dt = b.dtype
    bn_train = train and not bn_frozen
    p_drop = b.dropout_proportion if dropout_p is None else dropout_p
    world = 1 if mesh is None else mesh.size
    batch = feats.shape[0] * world if cfg.sample_per_sequence else None
    new_bn, coefs = {}, {}

    def local(draw):
        """This rank's rows of a draw over the global batch."""
        return draw if mesh is None else draw[mesh.rows(draw.shape[0])]

    def coefs_of(alpha, share_index):
        c = branch_coefs(alpha, mode, tau, generator, share_index, batch)
        return c if batch is None else local(c)

    def dropout(x):
        if not train or generator is None or p_drop <= 0.0:
            return x
        mask = draw_noise("bernoulli", (x.shape[0] * world, 1, x.shape[-1]),
                          generator, x.device, base._dropout_keep(p_drop))
        return base._apply_dropout(x, local(mask), p_drop)

    x = dropout(base._input_layers(b, params, bn_state, new_bn, feats,
                                   ivectors, bn_train, mesh))
    kc = cfg.num_candidates
    for i in range(cfg.num_layers):
        name = f"tdnnf{i + 2}"
        p = params[name]
        c_aff = None
        if cfg.search_offsets:
            # linear offsets -(K-1)..0 (share = offset 0, last), affine
            # offsets 0..K-1 (share first); weights are stored with index
            # |offset|, so the linear side flips weights and coefs
            lin_off, aff_off = tuple(range(-(kc - 1), 1)), tuple(range(kc))
            c_lin = coefs_of(alphas["offsets_linear"][i], kc - 1)
            c_aff = coefs_of(alphas["offsets_affine"][i], 0)
            bottleneck = spliced_linear(
                x, torch.flip(p["linear"], (0,)), lin_off,
                coef=torch.flip(c_lin, (-1,)), compute_dtype=dt).to(dt)
            coefs[f"{name}_linear"] = c_lin
        else:
            l, r = _fixed_pairs(cfg)[i]
            lin_off = (-l, 0) if l > 0 else (0,)
            aff_off = (0, r) if r > 0 else (0,)
            bottleneck = spliced_linear(x, p["linear"], lin_off,
                                        compute_dtype=dt).to(dt)
        if cfg.search_bottleneck:
            c_bn = coefs_of(alphas["bottleneck"][i], None)
            mask = _bottleneck_mask(c_bn, cfg.bottleneck_groups).to(dt)
            bottleneck = bottleneck * (mask[None, None, :] if mask.ndim == 1
                                       else mask[:, None, :])
            coefs[f"{name}_bottleneck"] = c_bn
        cur = spliced_linear(bottleneck, p["affine"], aff_off,
                             bias=p["affine_b"], coef=c_aff,
                             compute_dtype=dt).to(dt)
        if c_aff is not None:
            coefs[f"{name}_affine"] = c_aff
        cur = torch.relu(cur)
        cur, new_bn[name] = base._batchnorm(cur, bn_state[name], bn_train,
                                            mesh)
        cur = dropout(cur)
        lspan, rspan = -lin_off[0], aff_off[-1]
        prev = x[:, lspan: x.shape[1] - rspan] if (lspan or rspan) else x
        x = base._bypass(cur, prev, b.bypass_scale)
    return _supernet_heads(cfg, params, bn_state, new_bn, x, bn_train, coefs,
                           mesh)


def _supernet_heads(cfg, params, bn_state, new_bn, x, bn_train, coefs,
                    mesh=None):
    """Subsample + prefinal/output heads.  Unlike the plain model's heads,
    the products stay float32 between layers, as in the reference."""
    b = cfg.base
    dt = b.dtype
    fs = b.frame_subsampling_factor
    x = x[:, 0::fs] if fs > 1 else x
    pl = torch.matmul(x.to(dt), params["prefinal_l"].to(dt)).float()
    outs = []
    for head in ("chain", "xent"):
        hp = params[f"prefinal_{head}"]
        h = (torch.matmul(pl.to(dt), hp["affine_w"].to(dt)).float()
             + hp["affine_b"])
        h = torch.relu(h)
        h, new_bn[f"prefinal_{head}_big"] = base._batchnorm(
            h, bn_state[f"prefinal_{head}_big"], bn_train, mesh)
        h = torch.matmul(h.to(dt), hp["linear"].to(dt)).float()
        h, new_bn[f"prefinal_{head}_small"] = base._batchnorm(
            h, bn_state[f"prefinal_{head}_small"], bn_train, mesh)
        op = params[f"output_{head}"]
        outs.append(torch.matmul(h.to(dt), op["w"].to(dt)).float() + op["b"])
    return outs[0], outs[1], new_bn, coefs
