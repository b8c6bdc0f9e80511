"""Dense denominator scan: CUDA kernels, their plain versions, autograd.

The forward scan and its exact adjoint replace the Pallas pair
``_fwd_kernel`` / ``_bwd_kernel`` (``tdnnf_nas_tpu/ops/pallas_fwdbwd.py``);
``pallas_forward_score`` is the counterpart of the JAX wrapper of the same
name, the drop-in for ``ops.fwdbwd.forward_score`` on a shared dense graph
with no mask (the biphone denominator).  The kernels live in
``csrc/dense_den.cu``; the source note there says how they are laid out
(one persistent cooperative launch per scan, each block's tile of
``trans`` resident in shared memory for the whole scan, a 3xTF32
tensor-core product), what bounds them on an H100 and why they stay
float32 where the Pallas kernel casts a large ``trans`` to bf16.

Build: at first use, by ``ops/cuda_build.py`` (nvcc for sm_90a into the
git-ignored ``tdnnf_nas_torch/_build/``, keyed on a hash of the source),
loaded with ctypes.  Each direction is one C call: a memset of the
barrier counter and one cooperative launch on the current stream, laid
out by :func:`_plan`.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback.

Beside the plain versions, ``dense_scan_fwd_emulated`` /
``dense_scan_bwd_emulated`` repeat the kernels' own arithmetic in torch
(3xTF32 products per depth slice, partials summed in plan order, deferred
normalization, the adjoint's row dot from per-tile partial dots), so the CPU
tests can hold the design against float64 and the plain scans.  Nothing
on the main path calls them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import torch

from tdnnf_nas_torch.ops import cuda_build
from tdnnf_nas_torch.ops.blocked_den_cuda import split_tf32_matmul
from tdnnf_nas_torch.ops.cuda_build import ptr as _ptr
from tdnnf_nas_torch.ops.fwdbwd import _TINY, _normalized_log_obs

_SRC = cuda_build.CSRC / "dense_den.cu"


# ------------------------------------------------------------ plain versions

def dense_scan_fwd_plain(obs_log_state: torch.Tensor, trans: torch.Tensor,
                         init: torch.Tensor, final: torch.Tensor,
                         leaky: float):
    """Forward recursion (``_fwd_kernel``) as a Python loop over T.

    obs_log_state [B, T, S] float32 max-normalized log observations.
    Returns (logz [B], alphas [T, B, S] normalized, cs [T, B] scales).
    """
    t = obs_log_state.shape[1]
    obs = torch.exp(obs_log_state)
    a0 = init[None, :] * obs[:, 0]
    c0 = torch.clamp(a0.sum(dim=-1), min=_TINY)
    alpha = a0 / c0[:, None]
    alphas, cs = [alpha], [c0]
    for ti in range(1, t):
        if leaky > 0.0:
            alpha = alpha + leaky * init[None, :]
        a = (alpha @ trans) * obs[:, ti]
        c = torch.clamp(a.sum(dim=-1), min=_TINY)
        alpha = a / c[:, None]
        alphas.append(alpha)
        cs.append(c)
    cs = torch.stack(cs)
    zfin = torch.clamp((alpha * final[None, :]).sum(dim=-1), min=_TINY)
    logz = torch.log(cs[0]) + torch.log(cs[1:]).sum(dim=0) + torch.log(zfin)
    return logz, torch.stack(alphas), cs


def dense_scan_bwd_plain(obs_log_state: torch.Tensor, trans: torch.Tensor,
                         final: torch.Tensor, alphas: torch.Tensor,
                         cs: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Exact adjoint (``_bwd_kernel``) over reversed time:

        bar_t  = g_t - (g_t . alpha_t) + gbar
        grad_t = alpha_t * bar_t          (d/d log obs)
        v_t    = (bar_t / c_t) * exp(obs_t),  g_{t-1} = v_t @ trans^T

    with g_{T-1} = gbar * final / zfin; ``trans`` is the forward's, read
    through the view ``trans.T``.  Returns grad [B, T, S].
    """
    t = obs_log_state.shape[1]
    gb = gbar.float()[:, None]
    alpha_last = alphas[-1]
    zfin = torch.clamp((alpha_last * final[None, :]).sum(
        dim=-1, keepdim=True), min=_TINY)
    g = gb * (final[None, :] / zfin)
    bar = g - (g * alpha_last).sum(dim=-1, keepdim=True) + gb
    grads = [alpha_last * bar]
    v = (bar / cs[-1][:, None]) * torch.exp(obs_log_state[:, -1])
    for ti in range(t - 2, -1, -1):
        g = v @ trans.T
        bar = g - (g * alphas[ti]).sum(dim=-1, keepdim=True) + gb
        grads.append(alphas[ti] * bar)
        v = (bar / cs[ti][:, None]) * torch.exp(obs_log_state[:, ti])
    return torch.stack(grads[::-1], dim=1)


# -------------------------------------------------------------- the plan

_OUT_W = 192      # output columns per tile: 8 warps x 3 n8 MMA tiles
_ROWS = 64        # batch rows per row tile (the A stage's height)
# Dynamic shared memory an H100 block may opt in to; on the card
# _device_plan reads the device's own limit.
HOPPER_SMEM = 232_448
_GLOBAL_CHUNK = 256    # A-stage depth per chunk when the tile is not resident
# The largest S whose tiles stay resident on a 132-SM card (see _plan).
RESIDENT_MAX_S = 2304


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """How the kernels cut one frame's product into per-block tiles."""

    out_w: int        # output columns per tile
    n_out: int        # output slices, ceil(S / out_w)
    depth_w: int      # depth per slice, a multiple of 8
    n_depth: int      # depth slices, ceil(S / depth_w)
    chunk: int        # A-stage depth (depth_w when resident)
    resident: bool    # each block keeps its tile in shared memory
    smem_bytes: int   # dynamic shared memory a block needs

    @property
    def tiles(self) -> int:
        return self.n_out * self.n_depth

    def tile_ranges(self, s: int):
        """(out_begin, out_end, depth_begin, depth_end) of each tile, in the
        kernels' order (tile i: depth slice i // n_out, output slice
        i % n_out).  The forward's tile is trans[depth, out]; the adjoint's
        is trans[out, depth], read transposed."""
        for i in range(self.tiles):
            d, j = divmod(i, self.n_out)
            yield (j * self.out_w, min(s, (j + 1) * self.out_w),
                   d * self.depth_w, min(s, (d + 1) * self.depth_w))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(chunk: int, depth_w: int, resident: bool) -> int:
    """A block's shared memory: a small area (the adjoint epilogue's
    reduction), the A stage (which the adjoint's epilogue reuses for a
    [64][196] tile of alpha) and, resident, the larger of the two tile
    layouts (forward [depth][out + 8], adjoint [out][depth + 4]).  The
    CPU's copy of ``dense_den_smem_bytes`` in ``csrc/dense_den.cu``, which
    the card plans with (a card test holds the two equal)."""
    floats = 8 * _ROWS + _ROWS * max(chunk + 4, _OUT_W + 4)
    if resident:
        floats += max(depth_w * (_OUT_W + 8), _OUT_W * (depth_w + 4))
    return 4 * floats


@functools.lru_cache(maxsize=None)
def _plan(b: int, s: int, num_sms: int, smem_limit: int = HOPPER_SMEM,
          smem_bytes=_smem_bytes) -> DensePlan:
    """The kernels' tile plan for B rows and S states on ``num_sms`` SMs
    whose blocks may take ``smem_limit`` bytes of shared memory, sized by
    ``smem_bytes(chunk, depth_w, resident)``.

    Output slices of 192 columns; as many depth slices as keep
    n_out * n_depth <= num_sms (each a multiple of 8 deep), so every SM
    holds at most one tile: at S = 2,208 on 132 SMs, 12 x 11 tiles of
    192 x 208 (159,744 bytes of trans each, 222,720 bytes with the row
    padding, the A stage and the small area).  Rows go in
    tiles of 64 (B > 64 takes more row tiles; B <= 32 skips the empty MMA
    rows), so the plan does not depend on B beyond its check.

    The tile stays resident in shared memory when it and its stages fit
    232,448 bytes (an H100's limit): on 132 SMs that holds for every S <= 2,304
    (``RESIDENT_MAX_S``, 12 x 11 tiles of 192 x 216); above it (13 output
    slices leave 10 depth slices of >= 232) the same kernel reads its tile
    from global memory every frame, with the A stage in chunks of 256.
    """
    if b < 1 or s < 1 or num_sms < 1:
        raise ValueError(f"bad plan request B={b} S={s} SMs={num_sms}")
    n_out = _cdiv(s, _OUT_W)
    n_depth = max(1, min(num_sms // n_out, _cdiv(s, 8)))
    depth_w = 8 * _cdiv(_cdiv(s, n_depth), 8)
    n_depth = _cdiv(s, depth_w)
    resident = (n_out * n_depth <= num_sms
                and smem_bytes(depth_w, depth_w, True) <= smem_limit)
    chunk = depth_w if resident else min(depth_w, _GLOBAL_CHUNK)
    return DensePlan(_OUT_W, n_out, depth_w, n_depth, chunk, resident,
                     int(smem_bytes(chunk, depth_w, resident)))


# ------------------------------------- the kernels' arithmetic (tests only)

def _slice_sums(x: torch.Tensor, pl: DensePlan, total: bool = True):
    """Row sums of x [B, S] per output slice (the kernels' per-slice
    partials): their sum in slice order, or the list of them."""
    s = x.shape[1]
    parts = [x[:, j * pl.out_w: min(s, (j + 1) * pl.out_w)].sum(-1)
             for j in range(pl.n_out)]
    if not total:
        return parts
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _sliced_product(x: torch.Tensor, m: torch.Tensor,
                    pl: DensePlan) -> torch.Tensor:
    """x [B, S] @ m [S, S] as the kernels form it: one 3xTF32 partial per
    depth slice, the partials summed in slice order."""
    s = x.shape[1]
    total = None
    for d in range(pl.n_depth):
        d0, d1 = d * pl.depth_w, min(s, (d + 1) * pl.depth_w)
        part = split_tf32_matmul(x[:, d0:d1], m[d0:d1])
        total = part if total is None else total + part
    return total


def dense_scan_fwd_emulated(obs_log_state: torch.Tensor, trans: torch.Tensor,
                            init: torch.Tensor, final: torch.Tensor,
                            leaky: float, num_sms: int = 132):
    """The forward kernel's arithmetic: deferred normalization (frame t
    multiplies the unnormalized row a_{t-1} and scales the product,
    a_t = (a_{t-1} @ trans / c_{t-1} + w) * exp(obs_t) with
    w = (leaky*init) @ trans), 3xTF32 products per depth slice of
    ``_plan``, scales from per-slice row sums.  Same contract as
    :func:`dense_scan_fwd_plain`."""
    b, t, s = obs_log_state.shape
    pl = _plan(b, s, num_sms)
    obs = torch.exp(obs_log_state)
    w = (_sliced_product(leaky * init[None, :], trans, pl) if leaky > 0.0
         else 0.0)
    a = init[None, :] * obs[:, 0]
    alphas, cs = [], []
    for ti in range(1, t):
        c = torch.clamp(_slice_sums(a, pl), min=_TINY)
        rc = (1.0 / c)[:, None]
        alphas.append(a * rc)
        cs.append(c)
        a = (_sliced_product(a, trans, pl) * rc + w) * obs[:, ti]
    c = torch.clamp(_slice_sums(a, pl), min=_TINY)
    rc = 1.0 / c
    alphas.append(a * rc[:, None])
    cs.append(c)
    cs = torch.stack(cs)
    zf = torch.clamp((a * final[None, :]).sum(-1) * rc, min=_TINY)
    return torch.log(cs).sum(dim=0) + torch.log(zf), torch.stack(alphas), cs


def dense_scan_bwd_emulated(obs_log_state: torch.Tensor, trans: torch.Tensor,
                            final: torch.Tensor, alphas: torch.Tensor,
                            cs: torch.Tensor, gbar: torch.Tensor,
                            num_sms: int = 132) -> torch.Tensor:
    """The adjoint kernel's arithmetic: g_t = v_{t+1} @ trans^T as 3xTF32
    partials per depth slice (columns of trans) summed in order, the row dot g_t . alpha_t
    from the per-tile partial dots (each depth partial times alpha_t over
    each output slice, summed in tile order), the last frame's dot as
    gbar * (alpha . final) / zfin.  Same contract as
    :func:`dense_scan_bwd_plain`."""
    b, t, s = obs_log_state.shape
    pl = _plan(b, s, num_sms)
    gb = gbar.float()[:, None]
    obs = torch.exp(obs_log_state)
    s_fin = (alphas[-1] * final[None, :]).sum(-1, keepdim=True)
    rz = 1.0 / torch.clamp(s_fin, min=_TINY)
    g = (gb * final[None, :]) * rz
    dot = (gb * s_fin) * rz
    grads = [None] * t
    for ti in range(t - 1, -1, -1):
        bar = (g - dot) + gb
        grads[ti] = alphas[ti] * bar
        if ti == 0:
            break
        v = bar * (1.0 / cs[ti])[:, None] * obs[:, ti]
        g, dot = None, None
        for d in range(pl.n_depth):
            d0, d1 = d * pl.depth_w, min(s, (d + 1) * pl.depth_w)
            part = split_tf32_matmul(v[:, d0:d1], trans[:, d0:d1].T)
            g = part if g is None else g + part
            tile_dots = _slice_sums(part * alphas[ti - 1], pl, total=False)
            for x in tile_dots:
                dot = x if dot is None else dot + x
        dot = dot[:, None]
    return torch.stack(grads, dim=1)


# ----------------------------------------------------------- CUDA binding

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib = cuda_build.load(_SRC)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_den_scratch.argtypes = [i] * 4
    lib.dense_den_scratch.restype = ctypes.c_longlong
    lib.dense_den_smem_bytes.argtypes = [i] * 3
    lib.dense_den_smem_bytes.restype = ctypes.c_longlong
    lib.dense_den_smem_limit.argtypes = []
    lib.dense_den_smem_limit.restype = i
    lib.dense_den_fwd.argtypes = [p, p, p, p, f] + [i] * 8 + [p] * 5
    lib.dense_den_fwd.restype = i
    lib.dense_den_bwd.argtypes = [p] * 6 + [i] * 8 + [p] * 3
    lib.dense_den_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """Shared memory a block may opt in to on CUDA device ``index``."""
    with torch.cuda.device(index):
        limit = _library().dense_den_smem_limit()
    if limit <= 0:
        raise RuntimeError(f"reading the shared-memory limit failed with CUDA "
                           f"error {-limit}")
    return limit


def _device_plan(dev: torch.device, b: int, s: int) -> DensePlan:
    """The plan on a CUDA device: its SM count and shared-memory limit, and
    the kernels' own shared-memory size (``dense_den_smem_bytes``)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _plan(b, s, sms, _smem_limit(index), _kernel_smem_bytes)


def _kernel_smem_bytes(chunk: int, depth_w: int, resident: bool) -> int:
    """The kernels' own shared-memory size (``dense_den_smem_bytes``)."""
    return _library().dense_den_smem_bytes(chunk, depth_w, int(resident))


def _plan_args(pl: DensePlan):
    return (pl.n_out, pl.depth_w, pl.n_depth, pl.chunk, int(pl.resident))


def _check_cuda_inputs(obs_log_state: torch.Tensor, **graph) -> None:
    if obs_log_state.device.type != "cuda":
        raise ValueError(f"the dense-den kernels take CUDA tensors, got "
                         f"{obs_log_state.device}")
    if obs_log_state.dtype != torch.float32:
        raise TypeError(f"obs must be float32, got {obs_log_state.dtype}")
    if obs_log_state.ndim != 3 or not obs_log_state.is_contiguous():
        raise ValueError("obs must be a contiguous [B, T, S] tensor")
    b, t, s = obs_log_state.shape
    if b < 1 or t < 1:
        raise ValueError("need at least one sequence and one frame")
    for name, x in graph.items():
        shape = (s, s) if name == "trans" else (s,)
        if (tuple(x.shape) != shape or x.device != obs_log_state.device
                or x.dtype != torch.float32 or not x.is_contiguous()):
            raise ValueError(f"graph tensor {name} must be a contiguous "
                             f"float32 {shape} tensor on "
                             f"{obs_log_state.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def scratch_floats(obs_log_state: torch.Tensor) -> int:
    """Floats of scratch either kernel takes for these obs (its plan's)."""
    b, _, s = obs_log_state.shape
    pl = _device_plan(obs_log_state.device, b, s)
    return _library().dense_den_scratch(b, s, pl.n_out, pl.n_depth)


def dense_den_fwd_cuda(obs_log_state: torch.Tensor, trans: torch.Tensor,
                       init: torch.Tensor, final: torch.Tensor, leaky: float,
                       out=None, scratch=None):
    """Forward scan kernel; same contract as :func:`dense_scan_fwd_plain`.
    ``out`` = (logz, alphas, cs) and ``scratch`` (``scratch_floats``
    floats) may be given, as views into a larger allocation, so that a
    caller can check what the kernel writes around them."""
    _check_cuda_inputs(obs_log_state, trans=trans, init=init, final=final)
    lib = _library()
    b, t, s = obs_log_state.shape
    dev = obs_log_state.device
    f32 = torch.float32
    pl = _device_plan(dev, b, s)
    logz, alphas, cs = (None,) * 3 if out is None else out
    alphas = cuda_build.buffer(alphas, (t, b, s), f32, dev, "alphas")
    cs = cuda_build.buffer(cs, (t, b), f32, dev, "cs")
    logz = cuda_build.buffer(logz, (b,), f32, dev, "logz")
    scratch = cuda_build.buffer(scratch, (scratch_floats(obs_log_state),), f32, dev,
                     "scratch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.dense_den_fwd(
            _ptr(obs_log_state), _ptr(trans), _ptr(init), _ptr(final),
            float(leaky), b, t, s, *_plan_args(pl), _ptr(alphas), _ptr(cs),
            _ptr(logz), _ptr(scratch), ctypes.c_void_p(stream))
    _raise_on(rc, "dense_den_fwd")
    dense_den_fwd_cuda.launches += 1
    return logz, alphas, cs


dense_den_fwd_cuda.launches = 0


def dense_den_bwd_cuda(obs_log_state: torch.Tensor, trans: torch.Tensor,
                       final: torch.Tensor, alphas: torch.Tensor,
                       cs: torch.Tensor, gbar: torch.Tensor, out=None,
                       scratch=None) -> torch.Tensor:
    """Adjoint scan kernel; same contract as :func:`dense_scan_bwd_plain`.
    It reads the forward's contiguous ``trans`` with each tile transposed.
    ``out`` (the gradient) and ``scratch`` may be given, as for the
    forward."""
    _check_cuda_inputs(obs_log_state, trans=trans, final=final)
    lib = _library()
    b, t, s = obs_log_state.shape
    dev = obs_log_state.device
    f32 = torch.float32
    for x, shape in ((alphas, (t, b, s)), (cs, (t, b))):
        if (x.shape != shape or x.dtype != f32 or x.device != dev
                or not x.is_contiguous()):
            raise ValueError("alphas/cs do not match obs")
    gbar = gbar.to(f32).contiguous()
    if gbar.shape != (b,) or gbar.device != dev:
        raise ValueError(f"gbar must be a [{b}] tensor on {dev}")
    pl = _device_plan(dev, b, s)
    grad = cuda_build.buffer(out, (b, t, s), f32, dev, "out")
    scratch = cuda_build.buffer(scratch, (scratch_floats(obs_log_state),), f32, dev,
                     "scratch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.dense_den_bwd(
            _ptr(obs_log_state), _ptr(trans), _ptr(final),
            _ptr(alphas), _ptr(cs), _ptr(gbar), b, t, s, *_plan_args(pl),
            _ptr(grad), _ptr(scratch), ctypes.c_void_p(stream))
    _raise_on(rc, "dense_den_bwd")
    dense_den_bwd_cuda.launches += 1
    return grad


dense_den_bwd_cuda.launches = 0


# ------------------------------------------------------------- dispatch

def _scan_impl(device: torch.device):
    """(fwd, bwd) for the tensor's device: the plain versions on the CPU,
    the kernels on a CUDA device, anything else raises."""
    if device.type == "cpu":
        return dense_scan_fwd_plain, dense_scan_bwd_plain
    if device.type == "cuda":
        return dense_den_fwd_cuda, dense_den_bwd_cuda
    raise ValueError(f"no dense-den scan for device {device}")


class _DenseDenScore(torch.autograd.Function):
    """logZ [B] of a dense den from state-indexed log observations
    [B, T, S] (the counterpart of ``pallas_den_score_state``).

    The backward is the exact adjoint scan and needs only the saved
    normalized alphas and scales; it reads the forward's ``trans``
    transposed.  Only ``obs_log_state`` gets a gradient: the graph's
    tensors get None, as the reference's ``_vjp_bwd`` returns None for
    trans, init and final.
    """

    @staticmethod
    def forward(ctx, obs_log_state, trans, init, final, leaky):
        fwd, _ = _scan_impl(obs_log_state.device)
        logz, alphas, cs = fwd(obs_log_state, trans, init, final, leaky)
        ctx.save_for_backward(obs_log_state, trans, final, alphas, cs)
        return logz

    @staticmethod
    def backward(ctx, gbar):
        obs_log_state, trans, final, alphas, cs = ctx.saved_tensors
        _, bwd = _scan_impl(obs_log_state.device)
        grad = bwd(obs_log_state, trans, final, alphas, cs, gbar)
        return grad, None, None, None, None


def pallas_den_score_state(obs_log_state: torch.Tensor, trans: torch.Tensor,
                           init: torch.Tensor, final: torch.Tensor,
                           leaky: float) -> torch.Tensor:
    """Differentiable logZ [B] from pre-normalized (e.g. max-subtracted)
    state-indexed log observations [B, T, S]; the caller re-adds the
    normalizer."""
    return _DenseDenScore.apply(obs_log_state.float().contiguous(), trans,
                                init, final, float(leaky))


def pallas_forward_score(
    obs_logprob: torch.Tensor,
    trans: torch.Tensor,
    state_pdf: torch.Tensor,
    init: torch.Tensor,
    final: torch.Tensor,
    leaky_coef: float = 0.0,
) -> torch.Tensor:
    """logZ [B] of a shared dense den graph (no mask) for nnet log-outputs
    [B, T, P]: normalized as every den's obs are
    (``fwdbwd._normalized_log_obs``), expanded pdf -> state by
    ``state_pdf`` in log space and scanned by the dense-den kernels (plain
    versions on the CPU), which exponentiate inside."""
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_log_state = obs_norm.index_select(-1, state_pdf.long())  # [B, T, S]
    logz = pallas_den_score_state(obs_log_state, trans, init, final,
                                  float(leaky_coef))
    return logz + offset
