"""Blocked denominator scan: CUDA kernels, their plain versions, autograd.

The forward scan and its exact adjoint replace the Pallas pair
``_blk_fwd_kernel`` / ``_blk_bwd_kernel``
(``tdnnf_nas_tpu/ops/pallas_fwdbwd.py``) and compute what the XLA twin
``_blocked_score_core`` (``tdnnf_nas_tpu/ops/fwdbwd.py``) computes.  The
kernels live in ``csrc/blocked_den.cu``; the source note there says what
bounds them on an H100 (about 1.3 GFLOP of float32-accurate block product
per flagship frame against a 40.5 MB W that fits L2; a committed +-1
graph's W of 136.8 MB does not) and how they are laid out: one persistent
cooperative launch per scan, the block product as 3xTF32 on the tensor
cores, and the rank-R wildcard term of committed graphs as per-group sums
(``_wildcard``: each source slot's group index and the groups' out-rows,
made once per graph).

Build: at first use, by ``ops/cuda_build.py`` (nvcc for sm_90a into the
git-ignored ``tdnnf_nas_torch/_build/``, keyed on a hash of the source),
loaded with ctypes.  Each direction is one C call: a memset of its
scratch and one cooperative launch on the current stream.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback.

Beside the plain versions, ``blocked_scan_fwd_emulated`` /
``blocked_scan_bwd_emulated`` repeat the kernels' own arithmetic in torch
(3xTF32 products, deferred normalization, the adjoint's split partial
sums and its row dot through the gathered alphas), so the CPU tests can
hold the design against the plain scan.  Nothing on the main path calls
them.
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
# wildcard groups the kernels take (kMaxR in the source; a card test holds
# the two equal through blocked_den_max_groups)
MAX_WILDCARD_GROUPS = 4


# ------------------------------------------------------------ plain versions

def _dims(g):
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    return c, nsrc, ndp, r, (ndp - nsrc) // r


def _gather_beta(alpha: torch.Tensor, g) -> torch.Tensor:
    """beta [B, C*NSRC] without the leaky term: for each source slot the
    sum of its R enter slots (through ``perm``) plus its loop slot."""
    b = alpha.shape[0]
    c, nsrc, ndp, r, ndpos = _dims(g)
    a3 = alpha.reshape(b, c, ndp)
    beta_dst = a3[:, :, : r * ndpos].reshape(b, c, r, ndpos).sum(2)
    beta_dst = beta_dst.reshape(b, c * ndpos)
    a_loop = a3[:, :, r * ndpos:].reshape(b, c * nsrc)
    return F.pad(beta_dst, (0, 1))[:, g.perm.long()] + a_loop


def _assemble(u: torch.Tensor, g) -> torch.Tensor:
    """[B, C*NSRC] -> [B, V]: the inverse permutation (sentinel reads
    zero) broadcast to the R enter slots, and the loop slice."""
    b = u.shape[0]
    c, nsrc, ndp, r, ndpos = _dims(g)
    gbd = F.pad(u, (0, 1))[:, g.perm_inv.long()].reshape(b, c, 1, ndpos)
    ent = gbd.expand(b, c, r, ndpos).reshape(b, c, r * ndpos)
    return torch.cat([ent, u.reshape(b, c, nsrc)], dim=-1).reshape(b, -1)


def blocked_scan_fwd_plain(obs_virtual: torch.Tensor, g, leaky: float):
    """Forward recursion as a Python loop over T.

    obs_virtual [B, T, V] probability-space observations (f32 or bf16).
    Returns (logz [B], alphas [T, B, V] normalized, cs [T, B] scales).
    """
    b, t, v = obs_virtual.shape
    c, nsrc, _, _, _ = _dims(g)
    a0 = g.init_virtual[None, :] * obs_virtual[:, 0]
    c0 = torch.clamp(a0.sum(dim=-1), min=_TINY)
    alpha = a0 / c0[:, None]
    alphas, cs = [alpha], [c0]
    for ti in range(1, t):
        beta = _gather_beta(alpha, g)
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
    c, nsrc, ndp, _, _ = _dims(g)
    gb = gbar.float()[:, None]
    obs = obs_virtual.float()

    def l_transpose(vv):
        u = torch.einsum("bcd,csd->bcs", vv.reshape(b, c, ndp),
                         g.w_blocks).reshape(b, c * nsrc)
        if g.bcast_sel is not None:
            u = u + (vv @ g.bcast_vec.T) @ g.bcast_sel.T
        return _assemble(u, g)

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


# ------------------------------------- the kernels' arithmetic (tests only)

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low mantissa bits, as the tensor
    cores read a float32 register handed to them as TF32."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def split_tf32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the kernels compute it on the tensor cores (3xTF32): each
    operand split into hi = tf32(x) (round to nearest) and lo = x - hi,
    which the tensor cores truncate to TF32; then lo@hi + hi@lo + hi@hi
    accumulated in float32.  Error bound, as the source note of
    ``csrc/blocked_den.cu`` states it: per element,
    (2^-20 + 3K * 2^-24) * (|x| @ |w|) for depth K."""
    xh, wh = tf32_round(x), tf32_round(w)
    xl, wl = tf32_truncate(x - xh), tf32_truncate(w - wh)
    return xl @ wh + xh @ wl + xh @ wh


def _split_bounds(ndp: int, splits: int):
    """The adjoint kernel's d-ranges: 32-wide chunks shared out evenly."""
    chunks = -(-ndp // 32)
    per = -(-chunks // splits)
    return [(min(ndp, s * per * 32), min(ndp, (s + 1) * per * 32))
            for s in range(splits)]


def blocked_scan_fwd_emulated(obs_virtual: torch.Tensor, g, leaky: float):
    """The forward kernel's arithmetic: deferred normalization (beta from
    the unnormalized alpha, divided by the scale), 3xTF32 block products
    and, on a wildcard graph, the group sums of beta times the groups'
    out-rows in float32.  Same contract as :func:`blocked_scan_fwd_plain`;
    refuses a wildcard term the kernels cannot take (``_wildcard``)."""
    _wildcard(g)
    b, t, v = obs_virtual.shape
    c, nsrc, ndp, _, _ = _dims(g)
    obs = obs_virtual.float()
    a = g.init_virtual[None, :] * obs[:, 0]
    alphas, cs = [], []
    for ti in range(1, t):
        cn = torch.clamp(a.sum(dim=-1), min=_TINY)
        rc = (1.0 / cn)[:, None]
        alphas.append(a * rc)
        cs.append(cn)
        beta = _gather_beta(a, g) * rc
        if leaky > 0.0:
            beta = beta + leaky * g.init_pos[None, :]
        prod = split_tf32_matmul(beta.reshape(b, c, nsrc).transpose(0, 1),
                                 g.w_blocks)
        a = prod.transpose(0, 1).reshape(b, v)
        if g.bcast_sel is not None:
            a = a + (beta @ g.bcast_sel) @ g.bcast_vec
        a = a * obs[:, ti]
    cn = torch.clamp(a.sum(dim=-1), min=_TINY)
    alphas.append(a * (1.0 / cn)[:, None])
    cs.append(cn)
    cs = torch.stack(cs)
    zfin = torch.clamp((a * g.final_virtual[None, :]).sum(dim=-1) / cn,
                       min=_TINY)
    return torch.log(cs).sum(dim=0) + torch.log(zfin), torch.stack(alphas), cs


def blocked_scan_bwd_emulated(obs_virtual: torch.Tensor, g,
                              alphas: torch.Tensor, cs: torch.Tensor,
                              gbar: torch.Tensor, splits: int = 4):
    """The adjoint kernel's arithmetic: u = v @ W^T in ``splits`` partial
    sums over d (3xTF32 each), and the row dot g_t . alpha_t taken as
    sum_j u[j] * beta0_t[j] from the partials (beta0_t the forward's
    gather of alpha_t without leaky), which equals it because perm_inv
    inverts perm.  On a wildcard graph z = v @ vec^T joins each member's
    u, and the dot gains z . (beta0 @ sel), the group sums of beta0.  Same
    contract as :func:`blocked_scan_bwd_plain`; refuses what the forward
    refuses."""
    _wildcard(g)
    b, t, v = obs_virtual.shape
    c, nsrc, ndp, _, _ = _dims(g)
    gb = gbar.float()[:, None]
    obs = obs_virtual.float()

    def g_obs_frame(alpha_t, bar_t, obs_t):
        return (alpha_t * bar_t / torch.clamp(obs_t, min=1e-30)).to(
            obs_virtual.dtype)

    s_fin = (alphas[-1] * g.final_virtual[None, :]).sum(-1, keepdim=True)
    zfin = torch.clamp(s_fin, min=_TINY)
    bar = (gb * g.final_virtual[None, :] * (1.0 / zfin)
           - gb * (s_fin / zfin) + gb)
    grads = [g_obs_frame(alphas[-1], bar, obs[:, -1])]
    vcar = (bar * (1.0 / cs[-1])[:, None]) * obs[:, -1]
    w_t = g.w_blocks.transpose(1, 2)
    for ti in range(t - 2, -1, -1):
        beta0 = _gather_beta(alphas[ti], g)
        v3 = vcar.reshape(b, c, ndp).transpose(0, 1)
        u = vcar.new_zeros(b, c * nsrc)
        dot = vcar.new_zeros(b, 1)
        for d0, d1 in _split_bounds(ndp, splits):
            up = split_tf32_matmul(v3[:, :, d0:d1], w_t[:, d0:d1])
            up = up.transpose(0, 1).reshape(b, c * nsrc)
            u = u + up
            dot = dot + (up * beta0).sum(-1, keepdim=True)
        if g.bcast_sel is not None:
            z = vcar @ g.bcast_vec.T
            dot = dot + (z * (beta0 @ g.bcast_sel)).sum(-1, keepdim=True)
            u = u + z @ g.bcast_sel.T
        bar = _assemble(u, g) - dot + gb
        grads.append(g_obs_frame(alphas[ti], bar, obs[:, ti]))
        vcar = (bar * (1.0 / cs[ti])[:, None]) * obs[:, ti]
    return torch.stack(grads[::-1], dim=1)


# ----------------------------------------------------------- CUDA binding

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    lib = cuda_build.load(_SRC)
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.blocked_den_fwd_scratch.argtypes = [i] * 5
    lib.blocked_den_fwd_scratch.restype = ll
    lib.blocked_den_max_groups.argtypes = []
    lib.blocked_den_max_groups.restype = i
    lib.blocked_den_bwd_splits.argtypes = [i] * 4
    lib.blocked_den_bwd_splits.restype = i
    lib.blocked_den_bwd_scratch.argtypes = [i] * 6
    lib.blocked_den_bwd_scratch.restype = ll
    lib.blocked_den_fwd.argtypes = ([p, i, p, p, p, p, p, p, p, f] + [i] * 8
                                    + [p] * 4 + [p])
    lib.blocked_den_fwd.restype = i
    lib.blocked_den_bwd.argtypes = ([p, i] + [p] * 9 + [i] * 9
                                    + [p] * 2 + [p])
    lib.blocked_den_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_splits(device_index: int, b: int, c: int, nsrc: int,
                ndp: int) -> int:
    """The adjoint's d-splits on this device (as many as fill its SMs)."""
    with torch.cuda.device(device_index):
        s = _library().blocked_den_bwd_splits(b, c, nsrc, ndp)
    if s < 1:
        raise RuntimeError("blocked_den_bwd_splits: CUDA occupancy query "
                           "failed")
    return s


def _w_rows16(g) -> torch.Tensor:
    """W with its rows zero-padded to a multiple of 4 floats, so the kernels
    move it in 16-byte copies; made once per graph and W version, kept on
    the graph (its only copy when NDP is already a multiple of 4)."""
    w = g.w_blocks
    ndp = w.shape[2]
    if ndp % 4 == 0:
        return w
    cached = g.__dict__.get("_w_rows16")
    if cached is not None and cached[0] is w and cached[1] == w._version:
        return cached[2]
    padded = F.pad(w, (0, -ndp % 4)).contiguous()
    g.__dict__["_w_rows16"] = (w, w._version, padded)
    return padded


def _wildcard(g):
    """(gid, vec, R) of the graph's wildcard term for the kernels: gid
    [C*NSRC] int32, each source slot's group (-1 = none), read off the 0/1
    ``bcast_sel``; vec [R, V] float32, the groups' out-rows; R the group
    count.  (None, None, 0) without a wildcard term.  Made once per graph
    and ``bcast_sel`` version, kept on the graph.  Raises where the kernels
    cannot take the term: more than ``MAX_WILDCARD_GROUPS`` groups, or a
    ``bcast_sel`` that is not a 0/1 matrix with at most one group a
    slot."""
    sel = g.bcast_sel
    if sel is None:
        return None, None, 0
    cached = g.__dict__.get("_wildcard")
    if cached is not None and cached[0] is sel and cached[1] == sel._version:
        return cached[2]
    c, nsrc, ndp = g.w_blocks.shape
    r = sel.shape[1]
    if r > MAX_WILDCARD_GROUPS:
        raise ValueError(f"the blocked-den kernels take at most "
                         f"{MAX_WILDCARD_GROUPS} wildcard groups; this graph "
                         f"has R={r}")
    if (sel.shape[0] != c * nsrc or g.bcast_vec is None
            or g.bcast_vec.shape != (r, c * ndp)):
        raise ValueError(f"bcast_sel {tuple(sel.shape)} / bcast_vec do not "
                         f"match the graph {(c, nsrc, ndp)}")
    if not bool(((sel == 0) | (sel == 1)).all()) or bool(
            (sel.sum(1) > 1).any()):
        raise ValueError("bcast_sel must be 0/1 with at most one group a "
                         "source slot")
    gid = torch.where(sel.sum(1) > 0, sel.argmax(1),
                      torch.full_like(sel[:, 0], -1, dtype=torch.long))
    out = (gid.to(torch.int32).contiguous(),
           g.bcast_vec.to(torch.float32).contiguous(), r)
    g.__dict__["_wildcard"] = (sel, sel._version, out)
    return out


def _check_cuda_inputs(obs_virtual: torch.Tensor, g) -> None:
    if obs_virtual.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"obs must be float32 or bfloat16, got "
                        f"{obs_virtual.dtype}")
    if obs_virtual.ndim != 3 or not obs_virtual.is_contiguous():
        raise ValueError("obs must be a contiguous [B, T, V] tensor")
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    if obs_virtual.shape[2] != c * ndp or ndp <= nsrc or (ndp - nsrc) % r:
        raise ValueError(f"obs {tuple(obs_virtual.shape)} does not match "
                         f"the graph {tuple(g.w_blocks.shape)}, R={r}")
    if obs_virtual.shape[1] < 1 or obs_virtual.shape[0] < 1:
        raise ValueError("need at least one frame and one row")
    for name, x, dt in (("w_blocks", g.w_blocks, torch.float32),
                        ("perm", g.perm, torch.int32),
                        ("perm_inv", g.perm_inv, torch.int32),
                        ("init_pos", g.init_pos, torch.float32),
                        ("init_virtual", g.init_virtual, torch.float32),
                        ("final_virtual", g.final_virtual, torch.float32),
                        ("bcast_sel", g.bcast_sel, torch.float32),
                        ("bcast_vec", g.bcast_vec, torch.float32)):
        if x is None and name.startswith("bcast"):
            continue
        if (x.device != obs_virtual.device or x.dtype != dt
                or not x.is_contiguous()):
            raise ValueError(f"graph tensor {name} must be a contiguous {dt} "
                             f"tensor on {obs_virtual.device}")


def _opt_ptr(x):
    return None if x is None else _ptr(x)


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
    gid, vec, rw = _wildcard(g)
    scratch = torch.empty((lib.blocked_den_fwd_scratch(b, c, nsrc, ndp, rw),),
                          dtype=f32, device=dev)
    w = _w_rows16(g)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.blocked_den_fwd(
            _ptr(obs_virtual), int(obs_virtual.dtype == torch.bfloat16),
            _ptr(w), _ptr(g.perm), _ptr(g.init_pos),
            _ptr(g.init_virtual), _ptr(g.final_virtual), _opt_ptr(gid),
            _opt_ptr(vec), float(leaky), b, t, c, nsrc, ndp, g.enter_pad,
            w.shape[2], rw, _ptr(alphas), _ptr(cs), _ptr(logz),
            _ptr(scratch), ctypes.c_void_p(stream))
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
    if (alphas.shape != (t, b, v) or cs.shape != (t, b)
            or not alphas.is_contiguous() or not cs.is_contiguous()):
        raise ValueError("alphas/cs do not match obs")
    gbar = gbar.to(torch.float32).contiguous()
    grad = torch.empty_like(obs_virtual)
    splits = _bwd_splits(dev.index if dev.index is not None
                         else torch.cuda.current_device(), b, c, nsrc, ndp)
    gid, vec, rw = _wildcard(g)
    scratch = torch.empty(
        (lib.blocked_den_bwd_scratch(b, c, nsrc, ndp, splits, rw),),
        dtype=torch.float32, device=dev)
    w = _w_rows16(g)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.blocked_den_bwd(
            _ptr(obs_virtual), int(obs_virtual.dtype == torch.bfloat16),
            _ptr(w), _ptr(g.perm), _ptr(g.perm_inv),
            _ptr(g.final_virtual), _ptr(alphas), _ptr(cs), _ptr(gbar),
            _opt_ptr(gid), _opt_ptr(vec), b, t, c, nsrc, ndp, g.enter_pad,
            w.shape[2], splits, rw, _ptr(grad), _ptr(scratch),
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
