"""Blocked denominator scan: CUDA kernels, their plain versions, autograd.

The forward scan and its exact adjoint replace the Pallas pair
``_blk_fwd_kernel`` / ``_blk_bwd_kernel``
(``tdnnf_nas_tpu/ops/pallas_fwdbwd.py``) and compute what the XLA twin
``_blocked_score_core`` (``tdnnf_nas_tpu/ops/fwdbwd.py``) computes.  The
kernels live in ``csrc/blocked_den.cu``; the source note there says what
bounds them on an H100 (about 1.3 GFLOP of float32 block product per
flagship frame against a 40.5 MB W that fits L2) and how they are laid out.

Build: at first use, by ``ops/cuda_build.py`` (nvcc for sm_90a into the
git-ignored ``tdnnf_nas_torch/_build/``, keyed on a hash of the source),
loaded with ctypes.  Each direction is one C call that runs the whole
T-loop on the current stream.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tdnnf_nas_torch.ops import cuda_build
from tdnnf_nas_torch.ops.cuda_build import ptr as _ptr

_TINY = 1e-30
_SRC = cuda_build.CSRC / "blocked_den.cu"


# ------------------------------------------------------------ plain versions

def blocked_scan_fwd_plain(obs_virtual: torch.Tensor, g, leaky: float):
    """Forward recursion as a Python loop over T.

    obs_virtual [B, T, V] probability-space observations (f32 or bf16).
    Returns (logz [B], alphas [T, B, V] normalized, cs [T, B] scales).
    """
    b, t, v = obs_virtual.shape
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    ndpos = (ndp - nsrc) // r
    perm = g.perm.long()
    a0 = g.init_virtual[None, :] * obs_virtual[:, 0]
    c0 = torch.clamp(a0.sum(dim=-1), min=_TINY)
    alpha = a0 / c0[:, None]
    alphas, cs = [alpha], [c0]
    for ti in range(1, t):
        a3 = alpha.reshape(b, c, ndp)
        beta_dst = a3[:, :, : r * ndpos].reshape(b, c, r, ndpos).sum(2)
        beta_dst = beta_dst.reshape(b, c * ndpos)
        a_loop = a3[:, :, r * ndpos:].reshape(b, c * nsrc)
        beta = F.pad(beta_dst, (0, 1))[:, perm] + a_loop
        if leaky > 0.0:
            beta = beta + leaky * g.init_pos[None, :]
        a = torch.einsum("bcs,csd->bcd", beta.reshape(b, c, nsrc),
                         g.w_blocks).reshape(b, v)
        if g.bcast_sel is not None:
            a = a + (beta @ g.bcast_sel) @ g.bcast_vec
        a = a * obs_virtual[:, ti]
        cn = torch.clamp(a.sum(dim=-1), min=_TINY)
        alpha = a / cn[:, None]
        alphas.append(alpha)
        cs.append(cn)
    cs = torch.stack(cs)
    zfin = torch.clamp((alpha * g.final_virtual[None, :]).sum(dim=-1),
                       min=_TINY)
    logz = torch.log(cs[0]) + torch.log(cs[1:]).sum(dim=0) + torch.log(zfin)
    return logz, torch.stack(alphas), cs


def blocked_scan_bwd_plain(obs_virtual: torch.Tensor, g, alphas: torch.Tensor,
                           cs: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Exact adjoint over reversed time (``_blocked_core_vjp_bwd``):

        bar_t   = g_t - (g_t . alpha_t) + gbar
        dL/dobs = alpha_t * bar_t / max(obs_t, 1e-30)   (in obs's dtype)
        v_{t-1} = L^T((bar_t / c_t) * obs_t)

    with L = blockmm . (perm + enter-sum + loop (+ wildcard)).
    Returns grad [B, T, V].
    """
    b, t, v = obs_virtual.shape
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    ndpos = (ndp - nsrc) // r
    perm_inv = g.perm_inv.long()
    gb = gbar.float()[:, None]
    obs = obs_virtual.float()

    def l_transpose(vv):
        u = torch.einsum("bcd,csd->bcs", vv.reshape(b, c, ndp),
                         g.w_blocks).reshape(b, c * nsrc)
        if g.bcast_sel is not None:
            u = u + (vv @ g.bcast_vec.T) @ g.bcast_sel.T
        gbd = F.pad(u, (0, 1))[:, perm_inv].reshape(b, c, 1, ndpos)
        ent = gbd.expand(b, c, r, ndpos).reshape(b, c, r * ndpos)
        return torch.cat([ent, u.reshape(b, c, nsrc)], dim=-1).reshape(b, v)

    def g_obs_frame(alpha_t, bar_t, obs_t):
        return (alpha_t * bar_t / torch.clamp(obs_t, min=1e-30)).to(
            obs_virtual.dtype)

    alpha_last = alphas[-1]
    zfin = torch.clamp((alpha_last * g.final_virtual[None, :]).sum(
        dim=-1, keepdim=True), min=_TINY)
    gg = gb * g.final_virtual[None, :] / zfin
    bar = gg - (gg * alpha_last).sum(dim=-1, keepdim=True) + gb
    grads = [g_obs_frame(alpha_last, bar, obs[:, -1])]
    vcar = (bar / cs[-1][:, None]) * obs[:, -1]
    for ti in range(t - 2, -1, -1):
        gg = l_transpose(vcar)
        bar = gg - (gg * alphas[ti]).sum(dim=-1, keepdim=True) + gb
        grads.append(g_obs_frame(alphas[ti], bar, obs[:, ti]))
        vcar = (bar / cs[ti][:, None]) * obs[:, ti]
    return torch.stack(grads[::-1], dim=1)


# ----------------------------------------------------------- CUDA binding

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib = cuda_build.load(_SRC)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.blocked_den_fwd_partials.argtypes = [i, i]
    lib.blocked_den_fwd_partials.restype = i
    lib.blocked_den_bwd_splits.argtypes = [i]
    lib.blocked_den_bwd_splits.restype = i
    lib.blocked_den_fwd.argtypes = ([p, i, p, p, p, p, p, f] + [i] * 6
                                    + [p] * 5 + [p])
    lib.blocked_den_fwd.restype = i
    lib.blocked_den_bwd.argtypes = ([p, i, p, p, p, p, p, p] + [i] * 6
                                    + [p] * 4 + [p])
    lib.blocked_den_bwd.restype = i
    return lib


def _check_cuda_inputs(obs_virtual: torch.Tensor, g) -> None:
    if g.bcast_sel is not None:
        raise ValueError("the CUDA blocked-den kernels have no wildcard "
                         "(bcast) term; this graph needs one")
    if obs_virtual.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"obs must be float32 or bfloat16, got "
                        f"{obs_virtual.dtype}")
    if obs_virtual.ndim != 3 or not obs_virtual.is_contiguous():
        raise ValueError("obs must be a contiguous [B, T, V] tensor")
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    if obs_virtual.shape[2] != c * ndp or (ndp - nsrc) % r:
        raise ValueError(f"obs {tuple(obs_virtual.shape)} does not match "
                         f"the graph {tuple(g.w_blocks.shape)}, R={r}")
    if obs_virtual.shape[1] < 1:
        raise ValueError("need at least one frame")
    for name, x, dt in (("w_blocks", g.w_blocks, torch.float32),
                        ("perm", g.perm, torch.int32),
                        ("perm_inv", g.perm_inv, torch.int32),
                        ("init_pos", g.init_pos, torch.float32),
                        ("init_virtual", g.init_virtual, torch.float32),
                        ("final_virtual", g.final_virtual, torch.float32)):
        if (x.device != obs_virtual.device or x.dtype != dt
                or not x.is_contiguous()):
            raise ValueError(f"graph tensor {name} must be a contiguous {dt} "
                             f"tensor on {obs_virtual.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def blocked_den_fwd_cuda(obs_virtual: torch.Tensor, g, leaky: float):
    """Forward scan kernel; same contract as :func:`blocked_scan_fwd_plain`."""
    _check_cuda_inputs(obs_virtual, g)
    lib = _library()
    b, t, v = obs_virtual.shape
    c, nsrc, ndp = g.w_blocks.shape
    dev = obs_virtual.device
    f32 = torch.float32
    alphas = torch.empty((t, b, v), dtype=f32, device=dev)
    cs = torch.empty((t, b), dtype=f32, device=dev)
    logz = torch.empty((b,), dtype=f32, device=dev)
    beta = torch.empty((b, c * nsrc), dtype=f32, device=dev)
    partial = torch.empty((b, lib.blocked_den_fwd_partials(c, ndp)),
                          dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.blocked_den_fwd(
        _ptr(obs_virtual), int(obs_virtual.dtype == torch.bfloat16),
        _ptr(g.w_blocks), _ptr(g.perm), _ptr(g.init_pos),
        _ptr(g.init_virtual), _ptr(g.final_virtual), float(leaky),
        b, t, c, nsrc, ndp, g.enter_pad,
        _ptr(alphas), _ptr(cs), _ptr(logz), _ptr(beta), _ptr(partial),
        ctypes.c_void_p(stream))
    _raise_on(rc, "blocked_den_fwd")
    blocked_den_fwd_cuda.launches += 1
    return logz, alphas, cs


blocked_den_fwd_cuda.launches = 0


def blocked_den_bwd_cuda(obs_virtual: torch.Tensor, g, alphas: torch.Tensor,
                         cs: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Adjoint scan kernel; same contract as :func:`blocked_scan_bwd_plain`."""
    _check_cuda_inputs(obs_virtual, g)
    lib = _library()
    b, t, v = obs_virtual.shape
    c, nsrc, ndp = g.w_blocks.shape
    dev = obs_virtual.device
    f32 = torch.float32
    if (alphas.shape != (t, b, v) or cs.shape != (t, b)
            or not alphas.is_contiguous() or not cs.is_contiguous()):
        raise ValueError("alphas/cs do not match obs")
    gbar = gbar.to(f32).contiguous()
    grad = torch.empty_like(obs_virtual)
    vcar = torch.empty((b, v), dtype=f32, device=dev)
    gg = torch.empty((b, v), dtype=f32, device=dev)
    upart = torch.empty((lib.blocked_den_bwd_splits(ndp), b, c * nsrc),
                        dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.blocked_den_bwd(
        _ptr(obs_virtual), int(obs_virtual.dtype == torch.bfloat16),
        _ptr(g.w_blocks), _ptr(g.perm_inv), _ptr(g.final_virtual),
        _ptr(alphas), _ptr(cs), _ptr(gbar),
        b, t, c, nsrc, ndp, g.enter_pad,
        _ptr(grad), _ptr(vcar), _ptr(gg), _ptr(upart),
        ctypes.c_void_p(stream))
    _raise_on(rc, "blocked_den_bwd")
    blocked_den_bwd_cuda.launches += 1
    return grad


blocked_den_bwd_cuda.launches = 0


# ------------------------------------------------------------- dispatch

def _scan_impl(device: torch.device):
    """(fwd, bwd) for the tensor's device: the plain versions on the CPU,
    the kernels on a CUDA device, anything else raises."""
    if device.type == "cpu":
        return blocked_scan_fwd_plain, blocked_scan_bwd_plain
    if device.type == "cuda":
        return blocked_den_fwd_cuda, blocked_den_bwd_cuda
    raise ValueError(f"no blocked-den scan for device {device}")


class _BlockedDenScore(torch.autograd.Function):
    """logZ [B] of the blocked den from probability-space virtual
    observations [B, T, V].

    The backward is the exact adjoint scan and needs only the saved
    normalized alphas and scales.  Only ``obs_virtual`` gets a gradient:
    the graph's tensors get None, as the reference's custom VJP returns
    zero cotangents for every graph array.
    """

    @staticmethod
    def forward(ctx, obs_virtual, g, leaky):
        fwd, _ = _scan_impl(obs_virtual.device)
        logz, alphas, cs = fwd(obs_virtual, g, leaky)
        ctx.save_for_backward(obs_virtual, alphas, cs)
        ctx.graph = g
        return logz

    @staticmethod
    def backward(ctx, gbar):
        obs_virtual, alphas, cs = ctx.saved_tensors
        _, bwd = _scan_impl(obs_virtual.device)
        return bwd(obs_virtual, ctx.graph, alphas, cs, gbar), None, None


def blocked_den_score(obs_virtual: torch.Tensor, g, leaky: float) -> torch.Tensor:
    """Differentiable logZ [B] of the blocked den (see _BlockedDenScore)."""
    return _BlockedDenScore.apply(obs_virtual.contiguous(), g, float(leaky))
