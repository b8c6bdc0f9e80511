"""LF-MMI forward(-backward) (port of ``tdnnf_nas_tpu.ops.fwdbwd``).

Denominator, in four forms:
- class-blocked (composed n-gram graphs): ``forward_score_blocked``, whose
  forward and adjoint scans run as hand-written CUDA kernels on the card
  (``ops/blocked_den_cuda.py``);
- dense [S, S] (bigram biphone graphs, ``DenGraphArrays``): trained
  through the hand-written kernel pair behind
  ``ops/dense_den_cuda.pallas_forward_score``; the plain scaled-probability
  recursion ``forward_score`` here (the reference's XLA path, gradient from
  autograd) is the tested reference and serves ``occupancy_posteriors``
  and the dense numerator;
- position-factored (composed dens the blocked export refuses, such as
  the +-1 den at the bench's scale): ``forward_score_factored``, plain
  torch with an explicit adjoint over the whole scan (the reference's is
  XLA, not Pallas);
- padded CSR (``SparseDenGraph``): ``forward_score_sparse``, plain torch
  with autograd, as the reference's XLA path.
Numerator: the log-space banded recursion ``forward_score_linear`` in
plain torch; its gradient comes from autograd.

logZ stays exact regardless of output scale: the per-frame max of the
network output is subtracted before ``exp`` and added back into logZ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tdnnf_nas_torch.ops.blocked_den_cuda import _TINY, blocked_den_score

# Emission floor on max-normalized log-observations: the per-frame mass
# can never underflow (c >= e^-30 >> _TINY), so the backward's 1/c terms
# stay finite for wildly confident outputs.
_MIN_LOG_OBS = -30.0
_NEG_LOG = -1e30


def _normalized_log_obs(obs_logprob: torch.Tensor):
    """(obs, offset) for nnet log-outputs [B, T, P]: float32 obs minus its
    detached per-frame max, floored at ``_MIN_LOG_OBS``, and the [B] sum of
    those maxima, which the caller adds back into logZ."""
    obs = obs_logprob.float()
    mx = obs.amax(dim=-1, keepdim=True).detach()
    floor = torch.tensor(_MIN_LOG_OBS, device=obs.device)
    return torch.maximum(obs - mx, floor), mx[:, :, 0].sum(dim=1)


@dataclasses.dataclass
class DenGraphArrays:
    """Device copy of a dense denominator graph (shared across the batch).
    The adjoint reads ``trans`` transposed, so no transposed copy is kept.
    """

    trans: torch.Tensor  # [S, S] f32
    state_pdf: torch.Tensor  # [S] int64 (index_select)
    init: torch.Tensor  # [S] f32
    final: torch.Tensor  # [S] f32

    @classmethod
    def from_graph(cls, g, device) -> "DenGraphArrays":
        """Copy a host ``graphs.fsa.StateGraph`` to ``device`` (required,
        as for ``BlockedDenGraph.from_host``)."""

        def dev(a, dtype):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)

        return cls(
            trans=dev(g.trans, torch.float32),
            state_pdf=dev(g.state_pdf, torch.int64),
            init=dev(g.init, torch.float32),
            final=dev(g.final, torch.float32),
        )


@dataclasses.dataclass
class BlockedDenGraph:
    """Device copy of the superblocked denominator graph.

    Layout per superblock c (C superblocks, V = C*NDp virtual slots):

        [ R*NDPOS enter slots (r-major) | NSRC loop slots ]

    Per frame the forward recursion is

        beta_dst = sum_r alpha_enters[r]                       [B, C*NDPOS]
        beta     = beta_dst[perm] + alpha_loops (+ leaky*init_pos)
        alpha'   = einsum('bcs,csd->bcd', beta, W) * obs_t, renormalized

    (+ the rank-R wildcard term ``beta @ bcast_sel @ bcast_vec`` on graphs
    that have one).  Pad slots carry zero in-weight, so they hold no mass
    and their obs gradients are exactly zero.
    """

    w_blocks: torch.Tensor  # [C, NSRC, NDp] f32
    perm: torch.Tensor  # [C*NSRC] int32 (C*NDPOS = zero slot)
    perm_inv: torch.Tensor  # [C*NDPOS] int32 (C*NSRC = no source)
    init_pos: torch.Tensor  # [C*NSRC] f32
    pdf_virtual: torch.Tensor  # [V] int64 (index_select)
    init_virtual: torch.Tensor  # [V] f32
    final_virtual: torch.Tensor  # [V] f32
    bcast_sel: Optional[torch.Tensor]  # [C*NSRC, R'] f32 or None
    bcast_vec: Optional[torch.Tensor]  # [R', V] f32 or None
    enter_pad: int = 4
    num_states: int = 0
    num_pdfs: int = 0

    @classmethod
    def from_host(cls, g, device) -> "BlockedDenGraph":
        """Copy a host ``graphs.den_graph.BlockedDenGraph`` to ``device``."""

        def dev(a, dtype):
            if a is None:
                return None
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(
            w_blocks=dev(g.w_blocks, torch.float32),
            perm=dev(g.perm, torch.int32),
            perm_inv=dev(g.perm_inv, torch.int32),
            init_pos=dev(g.init_pos, torch.float32),
            pdf_virtual=dev(g.pdf_virtual, torch.int64),
            init_virtual=dev(g.init_virtual, torch.float32),
            final_virtual=dev(g.final_virtual, torch.float32),
            bcast_sel=dev(g.bcast_sel, torch.float32),
            bcast_vec=dev(g.bcast_vec, torch.float32),
            enter_pad=int(g.enter_pad),
            num_states=int(g.num_states),
            num_pdfs=int(g.num_pdfs),
        )


def forward_score_blocked(
    obs_logprob: torch.Tensor,
    g: BlockedDenGraph,
    leaky_coef: float = 0.0,
    obs_bf16: bool = False,
) -> torch.Tensor:
    """logZ [B] of the blocked den graph for nnet log-outputs [B, T, P].

    ``obs_bf16`` keeps the expanded (virtual-slot) observations in bf16;
    the recursion stays float32 (upcast at the multiply).
    """
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_exp = torch.exp(obs_norm)
    if obs_bf16:
        obs_exp = obs_exp.to(torch.bfloat16)
    obs_virtual = obs_exp.index_select(-1, g.pdf_virtual)  # [B, T, V]
    logz = blocked_den_score(obs_virtual, g, float(leaky_coef))
    return logz + offset


def _index(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                           device=device)


def _f32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=device)


@dataclasses.dataclass
class FactoredDenGraph:
    """Device copy of the position-factored denominator graph.

    Every state belongs to a *position* (LM state x carried phone
    context), laid out contiguously (``seg_bounds``), and all states of a
    position share their out-arcs, so the forward recursion factors:

        beta[pos]  = sum of alpha over the position's states
        alpha'[s]  = (sum over arcs pos -> s of beta[pos] * w) * obs[s]

    ``form`` names how the second line runs, chosen at export by size:
    ``"dense"``, one float32 matmul with the [Npos, S] ``trans_pos``;
    ``"arcs"``, a segment sum over the destination-sorted arc list, the
    same sum as the reference's K-wide gather over its padded in-arc
    tables without the padding (every per-frame intermediate is
    [B, arcs]).  The arc form's adjoint sums over the arc list sorted by
    source position (``*_t``); no form scatters, so runs repeat bit for
    bit.
    """

    seg_bounds: torch.Tensor  # [Npos+1] int64
    pos_of_state: torch.Tensor  # [S] int64
    state_pdf: torch.Tensor  # [S] int64
    init: torch.Tensor  # [S] f32
    final: torch.Tensor  # [S] f32
    pdf_perm: torch.Tensor  # [S] int64 states sorted by pdf (0-padded)
    pdf_bounds: torch.Tensor  # [P+1] int64
    trans_pos: Optional[torch.Tensor]  # [Npos, S] f32
    # the arc lists are padded (index 0, weight 0) to a multiple of
    # _SCAN_CHUNK, past every segment's end
    arc_src_pos: torch.Tensor  # [A'] int64, sorted by destination
    arc_w: torch.Tensor  # [A'] f32
    dst_bounds: torch.Tensor  # [S+1] int64
    arc_dst_t: torch.Tensor  # [A'] int64, sorted by source position
    arc_w_t: torch.Tensor  # [A'] f32
    src_bounds: torch.Tensor  # [Npos+1] int64
    num_pdfs: int = 0

    @property
    def form(self) -> str:
        return "dense" if self.trans_pos is not None else "arcs"

    @property
    def num_states(self) -> int:
        return int(self.state_pdf.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the graph's tensors."""
        return sum(v.numel() * v.element_size()
                   for v in vars(self).values()
                   if isinstance(v, torch.Tensor))

    @classmethod
    def from_host(cls, g, device) -> "FactoredDenGraph":
        """Copy a host ``graphs.den_graph.FactoredDenGraph`` to ``device``
        (required, as for ``BlockedDenGraph.from_host``)."""
        seg = np.asarray(g.seg_bounds, np.int64)
        pos_of_state = np.repeat(np.arange(len(seg) - 1), np.diff(seg))
        order = np.argsort(g.arc_src_pos, kind="stable")
        src_bounds = np.searchsorted(g.arc_src_pos[order],
                                     np.arange(len(seg)))
        return cls(
            seg_bounds=_index(seg, device),
            pos_of_state=_index(pos_of_state, device),
            state_pdf=_index(g.state_pdf, device),
            init=_f32(g.init, device), final=_f32(g.final, device),
            pdf_perm=_pad_index(g.pdf_perm, device),
            pdf_bounds=_index(g.pdf_bounds, device),
            trans_pos=(None if g.trans_pos is None
                       else _f32(g.trans_pos, device)),
            arc_src_pos=_pad_index(g.arc_src_pos, device),
            arc_w=_pad_f32(g.arc_w, device),
            dst_bounds=_index(g.dst_bounds, device),
            arc_dst_t=_pad_index(g.arc_dst[order], device),
            arc_w_t=_pad_f32(g.arc_w[order], device),
            src_bounds=_index(src_bounds, device),
            num_pdfs=int(g.num_pdfs))


# the chunk of the blocked cumsum in _segment_sums; the device copies of
# the index lists it scans are padded to a multiple of it
_SCAN_CHUNK = 1024


def _pad_index(a, device):
    """An index list on ``device``, padded with 0 to a multiple of
    _SCAN_CHUNK (the padding lies past every segment's end)."""
    a = np.asarray(a, np.int64)
    return _index(np.pad(a, (0, -len(a) % _SCAN_CHUNK)), device)


def _pad_f32(a, device):
    a = np.asarray(a, np.float32)
    return _f32(np.pad(a, (0, -len(a) % _SCAN_CHUNK)), device)


def _segment_sums(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, len(bounds) - 1] float32 sums of the runs
    x[:, bounds[i]:bounds[i+1]] (bounds[-1] <= N; entries past it are
    ignored), as differences of a float64 inclusive cumsum: float32 would
    lose a short run's sum beside a running total over millions of arcs.
    The cumsum runs in chunks of _SCAN_CHUNK, all rows of all chunks at
    once, and adds each chunk's prefix only at the bounds (a scan along a
    row of millions runs on a handful of thread blocks)."""
    b, n = x.shape
    if n % _SCAN_CHUNK:
        x = F.pad(x, (0, -n % _SCAN_CHUNK))
    chunks = torch.cumsum(x.view(b, -1, _SCAN_CHUNK), dim=-1,
                          dtype=torch.float64)
    totals = chunks[:, :, -1]
    prefix = torch.cumsum(totals, dim=-1) - totals  # exclusive, [B, chunks]
    end = (bounds - 1).clamp(min=0)
    at = (chunks.view(b, -1).index_select(-1, end)
          + prefix.index_select(-1, torch.div(end, _SCAN_CHUNK,
                                              rounding_mode="floor")))
    at = torch.where(bounds > 0, at, torch.zeros((), dtype=at.dtype,
                                                 device=at.device))
    return (at[:, 1:] - at[:, :-1]).float()


def _transition(beta: torch.Tensor, g: FactoredDenGraph) -> torch.Tensor:
    """[B, Npos] position masses -> [B, S] in-arc sums."""
    if g.trans_pos is not None:
        return beta @ g.trans_pos
    return _segment_sums(beta.index_select(-1, g.arc_src_pos).mul_(g.arc_w),
                         g.dst_bounds)


def _transition_adjoint(gu: torch.Tensor,
                        g: FactoredDenGraph) -> torch.Tensor:
    """The transpose of :func:`_transition`: [B, S] -> [B, Npos]."""
    if g.trans_pos is not None:
        return gu @ g.trans_pos.T
    return _segment_sums(gu.index_select(-1, g.arc_dst_t).mul_(g.arc_w_t),
                         g.src_bounds)


class _FactoredScan(torch.autograd.Function):
    """logZ [B] (without the max offsets) of per-state observations
    obs_state [B, T, S] on a factored den, with the scan's exact adjoint.

    The forward keeps the normalised alphas and the frame scales; the
    backward walks time in reverse with d logZ / d alpha_t.  For
    alpha_t = a_t / c_t, c_t = max(sum a_t, _TINY):

        g_a = (g_alpha + (1 - <g_alpha, alpha_t>) * [c_t > _TINY]) / c_t
        g_obs_t = g_a * a_t / obs_t      (a_t = u_t * obs_t)
        g_alpha_{t-1} = (M^T (g_a * obs_t))[pos(s)]

    M the position->state transition; the leaky term adds a constant, so
    it passes the gradient through unchanged.
    """

    @staticmethod
    def forward(ctx, obs_state, g, leaky_coef):
        b, t, s = obs_state.shape
        init_b = g.init[None, :]
        alphas = obs_state.new_empty((t, b, s))
        scales = obs_state.new_empty((t, b))
        a = init_b * obs_state[:, 0]
        for ti in range(t):
            if ti > 0:
                alpha = alphas[ti - 1]
                if leaky_coef > 0.0:
                    alpha = alpha + leaky_coef * init_b
                # the reference's exclusive cumsum over seg_bounds, its
                # running total in float64: in float32 each position's sum
                # would carry the total's rounding, ~1e-7 against a mean
                # position mass of 1e-5 on the bench-scale +-1 den
                beta = _segment_sums(alpha, g.seg_bounds)
                a = _transition(beta, g) * obs_state[:, ti]
            c = torch.clamp(a.sum(dim=-1), min=_TINY)
            alphas[ti] = a / c[:, None]
            scales[ti] = c
        fin = (alphas[t - 1] * g.final[None, :]).sum(dim=-1)
        ctx.save_for_backward(obs_state, alphas, scales, fin)
        ctx.graph = g
        return torch.log(scales).sum(dim=0) + torch.log(
            torch.clamp(fin, min=_TINY))

    @staticmethod
    def backward(ctx, g_logz):
        obs_state, alphas, scales, fin = ctx.saved_tensors
        g = ctx.graph
        t = obs_state.shape[1]
        g_obs = torch.empty_like(obs_state)
        zero = torch.zeros((), dtype=fin.dtype, device=fin.device)
        g_alpha = g.final[None, :] * torch.where(
            fin > _TINY, 1.0 / torch.clamp(fin, min=_TINY), zero)[:, None]
        for ti in range(t - 1, -1, -1):
            alpha, c = alphas[ti], scales[ti]
            dot = (g_alpha * alpha).sum(dim=-1)
            live = (c > _TINY).to(alpha.dtype)
            g_a = (g_alpha + ((1.0 - dot) * live)[:, None]) / c[:, None]
            if ti == 0:
                g_obs[:, 0] = g_a * g.init[None, :]
                break
            o = obs_state[:, ti]
            g_obs[:, ti] = g_a * (alpha * c[:, None]) / o
            g_beta = _transition_adjoint(g_a * o, g)
            g_alpha = g_beta.index_select(-1, g.pos_of_state)
        return g_obs * g_logz[:, None, None], None, None


class _GatherObsSorted(torch.autograd.Function):
    """Shared-graph obs expansion [B, T, P] -> [B, T, S] whose backward
    sums each pdf's run of the pdf-sorted states (``pdf_perm``, runs
    bounded by ``pdf_bounds``) as cumsum differences, as the reference's
    ``_gather_obs_sorted`` does; autograd's scatter-add would use atomics,
    and runs would not repeat bit for bit.  The cumsum runs in float64:
    the per-state gradients (posterior over observation) reach the
    hundreds where an observation is small, and a float32 running total
    over S states would round each pdf's sum to that total's ulp."""

    @staticmethod
    def forward(ctx, obs_exp, state_pdf, pdf_perm, pdf_bounds):
        ctx.save_for_backward(pdf_perm, pdf_bounds)
        return obs_exp.index_select(-1, state_pdf)

    @staticmethod
    def backward(ctx, g):
        pdf_perm, pdf_bounds = ctx.saved_tensors
        b, t, s = g.shape
        g_obs = _segment_sums(g.reshape(b * t, s).index_select(-1, pdf_perm),
                              pdf_bounds)
        return g_obs.reshape(b, t, -1), None, None, None


def forward_score_factored(
    obs_logprob: torch.Tensor,
    g: FactoredDenGraph,
    leaky_coef: float = 0.0,
) -> torch.Tensor:
    """logZ [B] of the factored den graph for nnet log-outputs [B, T, P],
    with the reference's math: float32 obs less the detached per-frame
    max, floored at ``_MIN_LOG_OBS``, the leaky term added before the
    position sums, ``_TINY`` floors on every scale.  The cumsums behind
    the position sums, the arc sums and the pdf-gather backward keep
    their running totals in float64; the rest is float32."""
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_state = _GatherObsSorted.apply(torch.exp(obs_norm), g.state_pdf,
                                       g.pdf_perm, g.pdf_bounds)
    return _FactoredScan.apply(obs_state, g, float(leaky_coef)) + offset


@dataclasses.dataclass
class SparseDenGraph:
    """Padded-CSR denominator graph: each state's in-arcs padded to the
    graph's largest in-degree K (``in_src`` [S, K] source states, 0 for
    padding with weight 0), so a frame is a gather and a K-wide weighted
    sum instead of an [S, S] product."""

    in_src: torch.Tensor  # [S, K] int64
    in_w: torch.Tensor  # [S, K] f32
    state_pdf: torch.Tensor  # [S] int64
    init: torch.Tensor  # [S] f32
    final: torch.Tensor  # [S] f32

    @classmethod
    def from_graph(cls, g, device) -> "SparseDenGraph":
        """From a host ``graphs.fsa.StateGraph`` (each state's in-arcs in
        source order) onto ``device`` (required)."""
        trans = np.asarray(g.trans)
        dst, src = np.nonzero(trans.T)
        return cls._padded(trans.shape[0], src, dst, trans[src, dst],
                           g.state_pdf, g.init, g.final, device)

    @classmethod
    def from_arcs(cls, num_states: int, src, dst, weight, state_pdf, init,
                  final, device) -> "SparseDenGraph":
        """From flat arc lists (each state's in-arcs in arc order) onto
        ``device`` (required), without the dense matrix."""
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        return cls._padded(num_states, np.asarray(src, np.int64)[order],
                           dst[order], np.asarray(weight, np.float32)[order],
                           state_pdf, init, final, device)

    @classmethod
    def _padded(cls, s, src, dst, w, state_pdf, init, final, device):
        counts = np.bincount(dst, minlength=s)
        k = max(1, int(counts.max(initial=0)))
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(len(dst)) - starts[dst]
        in_src = np.zeros((s, k), np.int64)
        in_w = np.zeros((s, k), np.float32)
        in_src[dst, rank] = src
        in_w[dst, rank] = w
        return cls(in_src=_index(in_src, device), in_w=_f32(in_w, device),
                   state_pdf=_index(state_pdf, device),
                   init=_f32(init, device), final=_f32(final, device))


def forward_score_sparse(
    obs_logprob: torch.Tensor,
    g: SparseDenGraph,
    leaky_coef: float = 0.0,
) -> torch.Tensor:
    """``forward_score`` over a SparseDenGraph: the same recursion with a
    K-wide gather per frame in place of the [S, S] product; the gradient
    comes from autograd, as in the reference."""
    b, t, _ = obs_logprob.shape
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_state = torch.exp(obs_norm).index_select(-1, g.state_pdf)
    init_b = g.init[None, :]
    a0 = init_b * obs_state[:, 0]
    c0 = torch.clamp(a0.sum(dim=-1), min=_TINY)
    alpha = a0 / c0[:, None]
    logcs = []
    for ti in range(1, t):
        if leaky_coef > 0.0:
            alpha = alpha + leaky_coef * init_b
        a = (alpha[:, g.in_src] * g.in_w).sum(dim=-1) * obs_state[:, ti]
        c = torch.clamp(a.sum(dim=-1), min=_TINY)
        alpha = a / c[:, None]
        logcs.append(torch.log(c))
    log_final = torch.log(torch.clamp((alpha * g.final[None, :]).sum(dim=-1),
                                      min=_TINY))
    logz = torch.log(c0)
    if logcs:
        logz = logz + torch.stack(logcs).sum(dim=0)
    return logz + log_final + offset


def _gather_obs(obs_exp: torch.Tensor, state_pdf: torch.Tensor) -> torch.Tensor:
    """obs_exp [B, T, P] -> per-state obs [B, T, S] for a shared [S] or a
    per-sequence [B, S] state_pdf."""
    if state_pdf.ndim == 1:
        return obs_exp.index_select(-1, state_pdf.long())
    b, t, _ = obs_exp.shape
    idx = state_pdf.long()[:, None, :].expand(b, t, state_pdf.shape[-1])
    return torch.gather(obs_exp, 2, idx)


def forward_score(
    obs_logprob: torch.Tensor,
    trans: torch.Tensor,
    state_pdf: torch.Tensor,
    init: torch.Tensor,
    final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    leaky_coef: float = 0.0,
) -> torch.Tensor:
    """Total (log) graph score per sequence, [B] logZ, as a plain loop over
    frames whose gradient comes from autograd:

        alpha' = ((alpha + leaky*init) @ trans) * obs[t] * mask[t]

    renormalized per frame.  obs_logprob [B, T, P] nnet log-outputs
    (exponentiated inside after the per-frame max is subtracted); trans
    [S, S] shared or [B, S, S] per sequence; state_pdf/init/final [S] or
    [B, S]; mask an optional [B, T, S] allow-mask; ``leaky_coef`` the
    leaky-HMM coefficient (denominator only).
    """
    b, t, _ = obs_logprob.shape
    obs_norm, offset = _normalized_log_obs(obs_logprob)
    obs_state = _gather_obs(torch.exp(obs_norm), state_pdf)  # [B, T, S]
    if mask is not None:
        obs_state = obs_state * mask
    init_b = init if init.ndim == 2 else init[None, :]
    final_b = final if final.ndim == 2 else final[None, :]

    a0 = init_b * obs_state[:, 0]
    c0 = torch.clamp(a0.sum(dim=-1), min=_TINY)
    alpha = a0 / c0[:, None]
    logcs = []
    for ti in range(1, t):
        if leaky_coef > 0.0:
            alpha = alpha + leaky_coef * init_b
        if trans.ndim == 2:
            a = alpha @ trans
        else:
            a = torch.bmm(alpha[:, None, :], trans)[:, 0]
        a = a * obs_state[:, ti]
        c = torch.clamp(a.sum(dim=-1), min=_TINY)
        alpha = a / c[:, None]
        logcs.append(torch.log(c))
    log_final = torch.log(torch.clamp((alpha * final_b).sum(dim=-1),
                                      min=_TINY))
    logz = torch.log(c0)
    if logcs:
        logz = logz + torch.stack(logcs).sum(dim=0)
    return logz + log_final + offset


def occupancy_posteriors(
    obs_logprob: torch.Tensor,
    trans: torch.Tensor,
    state_pdf: torch.Tensor,
    init: torch.Tensor,
    final: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    leaky_coef: float = 0.0,
):
    """(logZ [B], gamma [B, T, P]): per-frame pdf occupancy posteriors,
    gamma = d logZ / d obs_logprob (each frame's posteriors sum to 1), the
    xent head's soft targets.  Both are detached."""
    with torch.enable_grad():
        o = obs_logprob.detach().requires_grad_(True)
        scores = forward_score(o, trans, state_pdf, init, final, mask,
                               leaky_coef)
        gamma, = torch.autograd.grad(scores.sum(), o)
    return scores.detach(), gamma


def forward_score_reference(
    obs_logprob: np.ndarray,
    trans: np.ndarray,
    state_pdf: np.ndarray,
    init: np.ndarray,
    final: np.ndarray,
    mask: Optional[np.ndarray] = None,
    leaky_coef: float = 0.0,
) -> float:
    """Slow log-semiring numpy reference for one sequence (tests only)."""
    t_len = obs_logprob.shape[0]
    with np.errstate(divide="ignore"):
        log_trans = np.log(trans.astype(np.float64))
        log_init = np.log(init.astype(np.float64))
        log_final = np.log(final.astype(np.float64))
        log_mask = None if mask is None else np.log(mask.astype(np.float64))
    obs_s = obs_logprob.astype(np.float64)[:, state_pdf]  # [T, S]
    if log_mask is not None:
        obs_s = obs_s + log_mask
    log_alpha = log_init + obs_s[0]
    for t in range(1, t_len):
        if leaky_coef > 0.0:
            tot = np.logaddexp.reduce(log_alpha)
            leak = np.log(leaky_coef) + log_init + tot
            log_alpha = np.logaddexp(log_alpha, leak)
        log_alpha = (np.logaddexp.reduce(log_alpha[:, None] + log_trans, axis=0)
                     + obs_s[t])
    return float(np.logaddexp.reduce(log_alpha + log_final))


def forward_score_linear(
    obs_logprob: torch.Tensor,
    next_w: torch.Tensor,
    state_pdf: torch.Tensor,
    init: torch.Tensor,
    final: torch.Tensor,
    mask: torch.Tensor,
    self_loop_prob: float = 0.5,
) -> torch.Tensor:
    """logZ [B] of the per-sequence linear-chain numerator graphs.

    The numerator's transitions are banded (pair i -> its loop state with
    prob a; pair i -> pair i+1's enter state with next_w[i]), so the
    recursion is an O(S) two-term logaddexp band, run in log space because
    a tolerance-masked chunk's mass can underflow float32 for badly-matched
    models:

      pair[i]      = logaddexp(la[enter_i], la[loop_i])
      la'[loop_i]  = pair[i]   + log a      + logobs[loop_i]
      la'[enter_i] = pair[i-1] + log w[i-1] + logobs[enter_i]

    Args: obs_logprob [B,T,P]; next_w [B, S//2]; state_pdf/init/final
    [B, S]; mask [B, T, S] (probability space, logs taken inside).
    """
    b, t, _ = obs_logprob.shape
    s = state_pdf.shape[-1]
    n = s // 2
    obs = obs_logprob.float()
    idx = state_pdf.long()[:, None, :].expand(b, t, s)
    obs_state = torch.gather(obs, 2, idx)  # [B, T, S] log space
    neg = torch.tensor(_NEG_LOG, device=obs.device)
    log_mask = torch.where(mask > 0, 0.0, _NEG_LOG)
    obs_state = torch.maximum(obs_state + log_mask, neg)

    def safe_log(x):
        return torch.where(x > 0, torch.log(torch.clamp(x, min=_TINY)),
                           _NEG_LOG)

    log_init, log_final, log_w = safe_log(init), safe_log(final), safe_log(next_w)
    log_a = float(np.log(self_loop_prob))

    la = torch.maximum(log_init + obs_state[:, 0], neg)
    for ti in range(1, t):
        p = la.reshape(b, n, 2)
        pair = torch.logaddexp(p[..., 0], p[..., 1])  # [B, N]
        nxt_l = pair + log_a
        nxt_e = F.pad((pair + log_w)[:, :-1], (1, 0), value=_NEG_LOG)
        la_new = torch.stack([nxt_e, nxt_l], dim=-1).reshape(b, s)
        la = torch.maximum(la_new + obs_state[:, ti], neg)
    return torch.logsumexp(la + log_final, dim=-1)
