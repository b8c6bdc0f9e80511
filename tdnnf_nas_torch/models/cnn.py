"""CNN (2-D time-height convolution) front-ends for cnn-tdnn models (port
of ``tdnnf_nas_tpu.models.cnn``).

The reference's convolution xconfig family
(`steps/libs/nnet3/xconfig/convolution.py`): `XconfigConvLayer` (:115,
TimeHeightConvolutionComponent), `XconfigConvDARTSLayer` (:329, DARTS over
candidate time-offset patterns), `XconfigResBlock` (:844) and
`XconfigRes2Block` (:1203), `ChannelAverageLayer` (:1577).

Time stays valid-convolution (context accounted like the TDNN layers);
height is padded ((k-1)//2, k//2), as the reference pads it, with
optional subsampling.  The JAX package convolves NHWC with HWIO kernels,
H being time and W frequency height, in ``lax.conv_general_dilated``,
outside any Pallas kernel; here the activations are [B, C, T, H] and
``torch.nn.functional.conv2d`` (cuDNN on the card) takes the kernels,
which keep JAX's HWIO shape in ``params`` (so checkpoints and the
converters are identity maps), permuted to OIHW at the call.  Both
compute cross-correlation.  A bf16 model convolves in bf16 and continues
in float32, as the reference's ``preferred_element_type`` does (torch
rounds the conv's output to bf16 first: bf16 runs compare by trajectory).
The ConvDARTS layer mixes K candidate time-offset branches with the
coefficient modes of the TDNN-F supernet (``models/nas.branch_coefs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.models import tdnnf as base
from tdnnf_nas_torch.models.nas import SearchMode, branch_coefs

BN_EPS = base.BN_EPS


@dataclasses.dataclass(frozen=True)
class ConvLayerConfig(Config):
    """One time-height conv layer (XconfigConvLayer equivalent)."""

    out_channels: int = 64
    time_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_kernel: int = 3
    height_subsample: int = 1
    relu: bool = True
    batchnorm: bool = True


@dataclasses.dataclass(frozen=True)
class ConvDartsLayerConfig(Config):
    """DARTS conv layer: K candidate time-offset patterns, mixed by alpha
    (XconfigConvDARTSLayer equivalent)."""

    out_channels: int = 64
    # candidate time-offset patterns; index 0 is the always-on share branch
    candidates: Tuple[Tuple[int, ...], ...] = ((0,), (-1, 0, 1), (-2, 0, 2),
                                               (-3, 0, 3))
    height_kernel: int = 3
    height_subsample: int = 1


@dataclasses.dataclass(frozen=True)
class ResBlockConfig(Config):
    """Two conv layers + identity bypass.

    pre_activation=False: conv->BN->ReLU ordering (`XconfigResBlock`).
    pre_activation=True: BN->ReLU->conv "resnet v2" ordering
    (`XconfigRes2Block`).
    """

    channels: int = 64
    time_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_kernel: int = 3
    pre_activation: bool = False


@dataclasses.dataclass(frozen=True)
class CnnFrontendConfig(Config):
    """Stack of conv / res / conv-darts layers + channel-average collapse."""

    in_height: int = 40  # freq bins
    layers: Tuple[ConvLayerConfig, ...] = (
        ConvLayerConfig(out_channels=32),
        ConvLayerConfig(out_channels=32, height_subsample=2),
        ConvLayerConfig(out_channels=64),
    )
    channel_average: bool = False  # ChannelAverageLayer at the end

    @property
    def left_context(self) -> int:
        return sum(_span_of(l)[0] for l in self.layers)

    @property
    def right_context(self) -> int:
        return sum(_span_of(l)[1] for l in self.layers)

    def out_height(self) -> int:
        h = self.in_height
        for l in self.layers:
            hs = getattr(l, "height_subsample", 1)
            h = (h + hs - 1) // hs
        return h

    def out_dim(self) -> int:
        last = self.layers[-1]
        last_c = (last.out_channels if hasattr(last, "out_channels")
                  else last.channels)
        if self.channel_average:
            return last_c
        return self.out_height() * last_c


def _span_of(layer) -> Tuple[int, int]:
    """(left, right) time context consumed by one layer."""
    if isinstance(layer, ConvDartsLayerConfig):
        return (max(-min(c) for c in layer.candidates),
                max(max(c) for c in layer.candidates))
    if isinstance(layer, ResBlockConfig):
        return (-2 * min(layer.time_offsets), 2 * max(layer.time_offsets))
    return (-min(layer.time_offsets), max(layer.time_offsets))


def _conv_kernel_init(generator, k_t, k_h, c_in, c_out, device):
    """HWIO kernel [k_t, k_h, c_in, c_out], N(0, 1/fan_in)."""
    fan = k_t * k_h * c_in
    return (torch.randn((k_t, k_h, c_in, c_out), generator=generator)
            / np.sqrt(fan)).to(device)


def init_cnn_frontend(cfg: CnnFrontendConfig, generator: torch.Generator,
                      device=DEFAULT_DEVICE):
    """(params, bn_state) of the front end on ``device``; the JAX
    package's keys and shapes (kernels HWIO), draws from ``generator``."""
    device = resolve_device(device)
    zeros = lambda n: torch.zeros(n, device=device)
    stats = lambda n: {"mean": zeros(n), "var": torch.ones(n, device=device)}
    kernel = lambda *s: _conv_kernel_init(generator, *s, device)
    params, bn_state = {}, {}
    c_in = 1
    for i, layer in enumerate(cfg.layers):
        name = f"conv{i}"
        if isinstance(layer, ConvDartsLayerConfig):
            params[name] = {
                "branches": {f"b{j}": kernel(len(cand), layer.height_kernel,
                                             c_in, layer.out_channels)
                             for j, cand in enumerate(layer.candidates)},
                "bias": zeros(layer.out_channels)}
            c_out = layer.out_channels
        elif isinstance(layer, ResBlockConfig):
            k_t, c = len(layer.time_offsets), layer.channels
            params[name] = {
                "w1": kernel(k_t, layer.height_kernel, c_in, c),
                "w2": kernel(k_t, layer.height_kernel, c, c),
                "bias1": zeros(c), "bias2": zeros(c)}
            bn_state[name + "_1"] = stats(c)
            if layer.pre_activation:
                bn_state[name + "_0"] = stats(c_in)
            c_out = c
        else:
            params[name] = {
                "w": kernel(len(layer.time_offsets), layer.height_kernel,
                            c_in, layer.out_channels),
                "bias": zeros(layer.out_channels)}
            c_out = layer.out_channels
        bn_state[name] = stats(c_out)
        c_in = c_out
    return params, bn_state


def _conv2d(x, w, dt, height_subsample=1, time_dilation=1):
    """x [B, C, T, H] -> [B, C', T', H'] float32: valid in time, padded
    ((k-1)//2, k//2) in height; w is the HWIO kernel [k_t, k_h, C, C']."""
    k_h = w.shape[1]
    x = F.pad(x.to(dt), ((k_h - 1) // 2, k_h // 2))
    y = F.conv2d(x, w.to(dt).permute(3, 2, 0, 1),
                 stride=(1, height_subsample), dilation=(time_dilation, 1))
    return y.float()


def _bias(x, b):
    return x + b[:, None, None]


def _bn4(x, stats, train):
    """Batchnorm over (B, T, H) per channel of [B, C, T, H]; new running
    stats are detached."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.mean(torch.square(x), dim=(0, 2, 3)) - mean ** 2
        new = {"mean": (base.BN_DECAY * stats["mean"]
                        + (1 - base.BN_DECAY) * mean).detach(),
               "var": (base.BN_DECAY * stats["var"]
                       + (1 - base.BN_DECAY) * var).detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats
    inv = torch.rsqrt(torch.clamp(var, min=0.0) + BN_EPS)
    return (x - mean[:, None, None]) * inv[:, None, None], new


def _branch_conv(x, w, offsets, dt):
    """Conv restricted to the given time offsets (one tap, or evenly
    spaced taps as a time dilation)."""
    offs = tuple(offsets)
    if len(offs) == 1:
        return _conv2d(x, w, dt)  # the caller aligns the single tap
    step = offs[1] - offs[0]
    if any(offs[i + 1] - offs[i] != step for i in range(len(offs) - 1)):
        raise ValueError(f"offsets {offs} are not evenly spaced")
    return _conv2d(x, w, dt, time_dilation=step)


def apply_cnn_frontend(
    cfg: CnnFrontendConfig,
    params,
    bn_state,
    feats: torch.Tensor,  # [B, T, H]
    alphas: Optional[torch.Tensor] = None,  # [num_darts_layers, K]
    mode: str = SearchMode.FIXED,
    tau=1.0,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
):
    """Returns (hidden [B, T', D], new_bn_state, consumed_left).  D is
    (height, channel)-major as the reference's NHWC reshape, or the
    channels alone after the channel average; ``generator`` draws a
    ConvDARTS layer's path samples (``models/nas.draw_noise``)."""
    new_bn = {}
    x = feats[:, None]  # [B, 1, T, H]
    dt = torch.bfloat16 if feats.dtype == torch.bfloat16 else torch.float32
    darts_idx = 0
    consumed_left = 0
    for i, layer in enumerate(cfg.layers):
        name = f"conv{i}"
        p = params[name]
        if isinstance(layer, ConvDartsLayerConfig):
            coef = branch_coefs(alphas[darts_idx], mode, tau, generator,
                                share_index=0)
            darts_idx += 1
            max_l = max(-min(c) for c in layer.candidates)
            max_r = max(max(c) for c in layer.candidates)
            t_out = x.shape[2] - max_l - max_r
            out = None
            for j, cand in enumerate(layer.candidates):
                l_j = -min(cand)
                y = _branch_conv(x[:, :, max_l - l_j:],
                                 p["branches"][f"b{j}"], cand, dt)
                y = y[:, :, :t_out] * coef[j]
                out = y if out is None else out + y
            x, new_bn[name] = _bn4(torch.relu(_bias(out, p["bias"])),
                                   bn_state[name], train)
            consumed_left += max_l
        elif isinstance(layer, ResBlockConfig):
            l_span = -min(layer.time_offsets)
            trim = l_span + max(layer.time_offsets)
            prev = x[:, :, trim: x.shape[2] - trim] if trim else x
            if layer.pre_activation:
                # Res2Block: BN -> ReLU -> conv, twice, + bypass
                h0, new_bn[name + "_0"] = _bn4(x, bn_state[name + "_0"],
                                               train)
                h1 = _bias(_conv2d(torch.relu(h0), p["w1"], dt), p["bias1"])
                h1, new_bn[name + "_1"] = _bn4(h1, bn_state[name + "_1"],
                                               train)
                h2 = _bias(_conv2d(torch.relu(h1), p["w2"], dt), p["bias2"])
                if prev.shape[1] == h2.shape[1]:
                    h2 = h2 + prev
                x = h2
                new_bn[name] = bn_state[name]
            else:
                h1 = _bias(_conv2d(x, p["w1"], dt), p["bias1"])
                h1, new_bn[name + "_1"] = _bn4(torch.relu(h1),
                                               bn_state[name + "_1"], train)
                h2 = _bias(_conv2d(h1, p["w2"], dt), p["bias2"])
                if prev.shape[1] == h2.shape[1]:
                    h2 = h2 + prev
                x, new_bn[name] = _bn4(torch.relu(h2), bn_state[name], train)
            consumed_left += 2 * l_span
        else:
            x = _bias(_conv2d(x, p["w"], dt,
                              height_subsample=layer.height_subsample),
                      p["bias"])
            if layer.relu:
                x = torch.relu(x)
            if layer.batchnorm:
                x, new_bn[name] = _bn4(x, bn_state[name], train)
            else:
                new_bn[name] = bn_state[name]
            consumed_left += -min(layer.time_offsets)
    if cfg.channel_average:
        x = torch.mean(x, dim=3).transpose(1, 2)  # average over height
    else:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[2], -1)
    return x, new_bn, consumed_left


# ---------------------------------------------------------------------------
# cnn-tdnn model assembly (the reference's cnn-tdnn recipe variants)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CnnTdnnfModelConfig(Config):
    cnn: CnnFrontendConfig = dataclasses.field(
        default_factory=CnnFrontendConfig)
    tdnnf: base.TdnnfModelConfig = dataclasses.field(
        default_factory=base.TdnnfModelConfig)

    @property
    def num_darts_conv_layers(self) -> int:
        return sum(isinstance(l, ConvDartsLayerConfig)
                   for l in self.cnn.layers)


def cnn_tdnnf_context(cfg: CnnTdnnfModelConfig) -> Tuple[int, int]:
    """(left, right) input context in original frames."""
    pairs = cfg.tdnnf.stride_pairs
    return (cfg.cnn.left_context + sum(l for l, _ in pairs),
            cfg.cnn.right_context + sum(r for _, r in pairs))


def init_cnn_tdnnf(cfg: CnnTdnnfModelConfig, generator: torch.Generator,
                   device=DEFAULT_DEVICE):
    """Returns (params, alphas, bn_state) on ``device``; alphas empty
    without a ConvDARTS layer."""
    device = resolve_device(device)
    cnn_params, cnn_bn = init_cnn_frontend(cfg.cnn, generator, device)
    t = cfg.tdnnf
    # stack/head params from the base initializer, minus its input block
    stack_params, stack_bn = base.init_model(
        t.replace(feat_dim=1, ivector_dim=0), generator, device)
    del stack_params["lda"], stack_params["tdnn1"], stack_bn["tdnn1"]
    out_dim = cfg.cnn.out_dim()
    params = dict(stack_params)
    params["cnn"] = cnn_params
    params["proj"] = {
        "w": base._linear_init(generator, (out_dim, t.hidden_dim), out_dim,
                               device),
        "b": torch.zeros(t.hidden_dim, device=device)}
    bn_state = dict(stack_bn)
    bn_state["cnn"] = cnn_bn
    bn_state["proj"] = {"mean": torch.zeros(t.hidden_dim, device=device),
                        "var": torch.ones(t.hidden_dim, device=device)}
    alphas = {}
    n_darts = cfg.num_darts_conv_layers
    if n_darts:
        k = max(len(l.candidates) for l in cfg.cnn.layers
                if isinstance(l, ConvDartsLayerConfig))
        alphas["conv_offsets"] = torch.zeros((n_darts, k), device=device)
    return params, alphas, bn_state


def apply_cnn_tdnnf(
    cfg: CnnTdnnfModelConfig,
    params,
    bn_state,
    feats: torch.Tensor,  # [B, T, H]
    alphas=None,
    mode: str = SearchMode.FIXED,
    tau=1.0,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    dropout_p: Optional[float] = None,
):
    """Forward of the cnn-tdnn model: conv front end -> projection ->
    tdnnf stack + heads.  ``generator`` draws the ConvDARTS samples, then
    the dropout masks.  Returns (chain, xent, new_bn_state)."""
    t = cfg.tdnnf
    dt = t.dtype
    new_bn = {}
    x, new_bn["cnn"], consumed_left = apply_cnn_frontend(
        cfg.cnn, params["cnn"], bn_state["cnn"], feats,
        alphas=(alphas or {}).get("conv_offsets"), mode=mode, tau=tau,
        generator=generator, train=train)
    x = (torch.matmul(x.to(dt), params["proj"]["w"].to(dt)).float()
         + params["proj"]["b"])
    x = torch.relu(x)
    x, new_bn["proj"] = base._batchnorm(x, bn_state["proj"], train)
    dp = t.dropout_proportion if dropout_p is None else dropout_p
    chain, xent = base.tdnnf_stack_and_heads(
        t, params, bn_state, new_bn, x, train, generator,
        consumed_left=consumed_left, dropout_p=dp)
    return chain, xent, new_bn
