"""LF-MMI forward(-backward) (port of ``tdnnf_nas_tpu.ops.fwdbwd``).

Denominator: the class-blocked scaled-probability recursion of
``forward_score_blocked``, whose forward and adjoint scans run as
hand-written CUDA kernels on the card (``ops/blocked_den_cuda.py``).
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

from tdnnf_nas_torch.ops.blocked_den_cuda import blocked_den_score

_TINY = 1e-30
# Emission floor on max-normalized log-observations: the per-frame mass
# can never underflow (c >= e^-30 >> _TINY), so the backward's 1/c terms
# stay finite for wildly confident outputs.
_MIN_LOG_OBS = -30.0
_NEG_LOG = -1e30


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
    obs = obs_logprob.float()
    mx = obs.amax(dim=-1, keepdim=True).detach()
    floor = torch.tensor(_MIN_LOG_OBS, device=obs.device)
    obs_exp = torch.exp(torch.maximum(obs - mx, floor))
    if obs_bf16:
        obs_exp = obs_exp.to(torch.bfloat16)
    obs_virtual = obs_exp.index_select(-1, g.pdf_virtual)  # [B, T, V]
    logz = blocked_den_score(obs_virtual, g, float(leaky_coef))
    return logz + mx[:, :, 0].sum(dim=1)


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
