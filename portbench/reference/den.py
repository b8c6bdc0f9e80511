"""Plain LF-MMI forward scores: the denominator with the leaky HMM and
the per-chunk numerator, both from their graphs' plain arc form.

Denominator (scaled probabilities, renormalised every frame):

    alpha_0 = init * obs_0
    alpha_t = ((alpha_{t-1} + leaky * init) @ trans) * obs_t
    logZ    = sum_t log c_t + log(alpha_T . final) + sum_t max_t

with obs = exp(nnet output - its per-frame max) read at each state's pdf
and ``trans`` the dense [S, S] state transition.  A composed den given as
positions (runs of states sharing their out-arcs) and arcs from a source
position into a destination state is expanded to that dense matrix.

Numerator: a log-space forward over each chunk's own dense [S, S] graph,
with the chunk's allow-mask; no leaky term.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -1e30


def dense_from_positions(seg_bounds, arc_src_pos, arc_dst, arc_w,
                         num_states: int, device) -> torch.Tensor:
    """The [S, S] float32 transition of a position-factored den: every
    state of a position carries that position's out-arcs."""
    seg = np.asarray(seg_bounds, np.int64)
    npos = len(seg) - 1
    trans_pos = torch.zeros((npos, num_states), dtype=torch.float64,
                            device=device)
    trans_pos.index_put_(
        (torch.as_tensor(np.asarray(arc_src_pos, np.int64), device=device),
         torch.as_tensor(np.asarray(arc_dst, np.int64), device=device)),
        torch.as_tensor(np.asarray(arc_w, np.float64), device=device),
        accumulate=True)
    pos_of_state = torch.as_tensor(np.repeat(np.arange(npos), np.diff(seg)),
                                   device=device)
    return trans_pos[pos_of_state].float()


def den_logz(out: torch.Tensor, trans, state_pdf, init, final,
             leaky: float) -> torch.Tensor:
    """logZ [B] of the denominator for nnet outputs [B, T, P]."""
    mx = out.amax(dim=-1, keepdim=True).detach()
    obs = torch.exp(out - mx)[:, :, state_pdf]  # [B, T, S]
    alpha = init * obs[:, 0]
    c = alpha.sum(dim=-1)
    logz = torch.log(c)
    alpha = alpha / c[:, None]
    for t in range(1, out.shape[1]):
        alpha = ((alpha + leaky * init) @ trans) * obs[:, t]
        c = alpha.sum(dim=-1)
        logz = logz + torch.log(c)
        alpha = alpha / c[:, None]
    return logz + torch.log((alpha * final).sum(dim=-1)) + mx.sum(dim=(1, 2))


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-38)),
                       torch.full_like(x, NEG))


def num_logz(out: torch.Tensor, trans, state_pdf, init, final,
             mask) -> torch.Tensor:
    """logZ [B] of per-chunk numerator graphs: trans [B, S, S], state_pdf,
    init, final [B, S], mask [B, T, S] (nonzero = state allowed)."""
    lo = torch.gather(out, 2, state_pdf[:, None, :].expand(
        -1, out.shape[1], -1))
    lo = torch.where(mask > 0, lo, torch.full_like(lo, NEG))
    lt = _safe_log(trans)
    la = torch.clamp(_safe_log(init) + lo[:, 0], min=NEG)
    for t in range(1, out.shape[1]):
        la = torch.logsumexp(la[:, :, None] + lt, dim=1) + lo[:, t]
        la = torch.clamp(la, min=NEG)
    return torch.logsumexp(la + _safe_log(final), dim=-1)
