"""LF-MMI forward(-backward) (port of ``tdnnf_nas_tpu.ops.fwdbwd``).

Denominator, in two forms:
- class-blocked (composed n-gram graphs): ``forward_score_blocked``, whose
  forward and adjoint scans run as hand-written CUDA kernels on the card
  (``ops/blocked_den_cuda.py``);
- dense [S, S] (bigram biphone graphs, ``DenGraphArrays``): trained
  through the hand-written kernel pair behind
  ``ops/dense_den_cuda.pallas_forward_score``; the plain scaled-probability
  recursion ``forward_score`` here (the reference's XLA path, gradient from
  autograd) is the tested reference and serves ``occupancy_posteriors``.
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

    ``trans_T`` is the contiguous transpose: the adjoint's product
    ``v @ trans^T`` streams its rows as the forward streams ``trans``'s.
    """

    trans: torch.Tensor  # [S, S] f32
    trans_T: torch.Tensor  # [S, S] f32
    state_pdf: torch.Tensor  # [S] int64 (index_select)
    init: torch.Tensor  # [S] f32
    final: torch.Tensor  # [S] f32

    @classmethod
    def from_graph(cls, g, device="cpu") -> "DenGraphArrays":
        """Copy a host ``graphs.fsa.StateGraph`` to ``device``."""

        def dev(a, dtype):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)

        return cls(
            trans=dev(g.trans, torch.float32),
            trans_T=dev(g.trans.T, torch.float32),
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
