"""Dense denominator scan: CUDA kernels, their plain versions, autograd.

The forward scan and its exact adjoint replace the Pallas pair
``_fwd_kernel`` / ``_bwd_kernel`` (``tdnnf_nas_tpu/ops/pallas_fwdbwd.py``);
``pallas_forward_score`` is the counterpart of the JAX wrapper of the same
name, the drop-in for ``ops.fwdbwd.forward_score`` on a shared dense graph
with no mask (the biphone denominator).  The kernels live in
``csrc/dense_den.cu``; the source note there says what bounds them on an
H100 and why they stay float32 where the Pallas kernel casts a large
``trans`` to bf16.

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
from typing import Optional

import torch

from tdnnf_nas_torch.ops import cuda_build
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


def dense_scan_bwd_plain(obs_log_state: torch.Tensor, trans_T: torch.Tensor,
                         final: torch.Tensor, alphas: torch.Tensor,
                         cs: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Exact adjoint (``_bwd_kernel``) over reversed time:

        bar_t  = g_t - (g_t . alpha_t) + gbar
        grad_t = alpha_t * bar_t          (d/d log obs)
        v_t    = (bar_t / c_t) * exp(obs_t),  g_{t-1} = v_t @ trans^T

    with g_{T-1} = gbar * final / zfin.  Returns grad [B, T, S].
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
        g = v @ trans_T
        bar = g - (g * alphas[ti]).sum(dim=-1, keepdim=True) + gb
        grads.append(alphas[ti] * bar)
        v = (bar / cs[ti][:, None]) * torch.exp(obs_log_state[:, ti])
    return torch.stack(grads[::-1], dim=1)


# ----------------------------------------------------------- CUDA binding

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib = cuda_build.load(_SRC)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dense_den_splits.argtypes = [i, i]
    lib.dense_den_splits.restype = i
    lib.dense_den_fwd.argtypes = [p, p, p, p, f, i, i, i, p, p, p, p, p]
    lib.dense_den_fwd.restype = i
    lib.dense_den_bwd.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.dense_den_bwd.restype = i
    return lib


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
        shape = (s, s) if name.startswith("trans") else (s,)
        if (tuple(x.shape) != shape or x.device != obs_log_state.device
                or x.dtype != torch.float32 or not x.is_contiguous()):
            raise ValueError(f"graph tensor {name} must be a contiguous "
                             f"float32 {shape} tensor on "
                             f"{obs_log_state.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


def dense_den_fwd_cuda(obs_log_state: torch.Tensor, trans: torch.Tensor,
                       init: torch.Tensor, final: torch.Tensor, leaky: float):
    """Forward scan kernel; same contract as :func:`dense_scan_fwd_plain`."""
    _check_cuda_inputs(obs_log_state, trans=trans, init=init, final=final)
    lib = _library()
    b, t, s = obs_log_state.shape
    dev = obs_log_state.device
    f32 = torch.float32
    alphas = torch.empty((t, b, s), dtype=f32, device=dev)
    cs = torch.empty((t, b), dtype=f32, device=dev)
    logz = torch.empty((b,), dtype=f32, device=dev)
    part = torch.empty((lib.dense_den_splits(b, s), b, s), dtype=f32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dense_den_fwd(
        _ptr(obs_log_state), _ptr(trans), _ptr(init), _ptr(final),
        float(leaky), b, t, s, _ptr(alphas), _ptr(cs), _ptr(logz), _ptr(part),
        ctypes.c_void_p(stream))
    _raise_on(rc, "dense_den_fwd")
    dense_den_fwd_cuda.launches += 1
    return logz, alphas, cs


dense_den_fwd_cuda.launches = 0


def dense_den_bwd_cuda(obs_log_state: torch.Tensor, trans_T: torch.Tensor,
                       final: torch.Tensor, alphas: torch.Tensor,
                       cs: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """Adjoint scan kernel; same contract as :func:`dense_scan_bwd_plain`."""
    _check_cuda_inputs(obs_log_state, trans_T=trans_T, final=final)
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
    grad = torch.empty_like(obs_log_state)
    vcar = torch.empty((b, s), dtype=f32, device=dev)
    part = torch.empty((lib.dense_den_splits(b, s), b, s), dtype=f32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dense_den_bwd(
        _ptr(obs_log_state), _ptr(trans_T), _ptr(final), _ptr(alphas),
        _ptr(cs), _ptr(gbar), b, t, s, _ptr(grad), _ptr(vcar), _ptr(part),
        ctypes.c_void_p(stream))
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
    normalized alphas and scales.  Only ``obs_log_state`` gets a gradient:
    the graph's tensors get None, as the reference's ``_vjp_bwd`` returns
    None for trans, init and final.
    """

    @staticmethod
    def forward(ctx, obs_log_state, trans, trans_T, init, final, leaky):
        fwd, _ = _scan_impl(obs_log_state.device)
        logz, alphas, cs = fwd(obs_log_state, trans, init, final, leaky)
        ctx.save_for_backward(obs_log_state, trans_T, final, alphas, cs)
        return logz

    @staticmethod
    def backward(ctx, gbar):
        obs_log_state, trans_T, final, alphas, cs = ctx.saved_tensors
        _, bwd = _scan_impl(obs_log_state.device)
        grad = bwd(obs_log_state, trans_T, final, alphas, cs, gbar)
        return grad, None, None, None, None, None


def pallas_den_score_state(obs_log_state: torch.Tensor, trans: torch.Tensor,
                           init: torch.Tensor, final: torch.Tensor,
                           leaky: float,
                           trans_T: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Differentiable logZ [B] from pre-normalized (e.g. max-subtracted)
    state-indexed log observations [B, T, S]; the caller re-adds the
    normalizer.  ``trans_T`` (trans transposed, contiguous) is formed here
    when not given."""
    if trans_T is None:
        trans_T = trans.T.contiguous()
    return _DenseDenScore.apply(obs_log_state.float().contiguous(), trans,
                                trans_T, init, final, float(leaky))


def pallas_forward_score(
    obs_logprob: torch.Tensor,
    trans: torch.Tensor,
    state_pdf: torch.Tensor,
    init: torch.Tensor,
    final: torch.Tensor,
    leaky_coef: float = 0.0,
    trans_T: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """logZ [B] of a shared dense den graph (no mask) for nnet log-outputs
    [B, T, P]: normalized as every den's obs are
    (``fwdbwd._normalized_log_obs``), expanded pdf -> state by
    ``state_pdf`` in log space and scanned by the dense-den kernels (plain
    versions on the CPU), which exponentiate inside."""
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_log_state = obs_norm.index_select(-1, state_pdf.long())  # [B, T, S]
    logz = pallas_den_score_state(obs_log_state, trans, init, final,
                                  float(leaky_coef), trans_T=trans_T)
    return logz + offset
