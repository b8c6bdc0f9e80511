"""Port of ``tdnnf_nas_tpu.decode.viterbi``: batched Viterbi decoding over
dense StateGraphs, on the tensors' device.

The diagnostic phone decode, the dense word decode and forced alignment:
a max-product recursion with backpointers over the same dense
state-emitting graphs the training objective uses, one [B,S,S] max-plus
step per frame.  The reference runs it under ``lax.scan`` outside Pallas;
here it is a plain loop over frames of torch ops (no hand-written
kernel).  Ties resolve to the lowest state index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from tdnnf_nas_torch.core.device import resolve_device

_NEG = -1e30


def viterbi_decode(
    obs_logprob: torch.Tensor,
    log_trans: torch.Tensor,
    state_pdf: torch.Tensor,
    log_init: torch.Tensor,
    log_final: torch.Tensor,
):
    """Best state path per sequence.

    Args:
      obs_logprob: [B, T, P] float32 log-outputs.
      log_trans: [S, S] log transition weights (-1e30 for absent arcs).
      state_pdf: [S] integer pdf of each state; log_init/log_final: [S].

    Returns: (scores [B] float32, paths [B, T] int32 state ids), on the
    inputs' device.
    """
    obs_s = obs_logprob.index_select(-1, state_pdf.long())  # [B,T,S]
    delta = log_init[None, :] + obs_s[:, 0]
    bps = []
    for t in range(1, obs_s.shape[1]):
        # cand[b, i, j] = delta[b, i] + log_trans[i, j]
        delta, bp = (delta[:, :, None] + log_trans[None, :, :]).max(dim=1)
        delta = delta + obs_s[:, t]
        bps.append(bp)
    score, cur = (delta + log_final[None, :]).max(dim=-1)
    path = [cur]
    for bp in reversed(bps):
        cur = bp.gather(1, cur[:, None])[:, 0]
        path.append(cur)
    return score, torch.stack(path[::-1], dim=1).to(torch.int32)


def log_weights(trans, init, final):
    """(trans, init, final) weights -> float32 numpy logs, -1e30 where a
    weight is 0.  Every decoder of the port takes its logs from here, the
    C++ ones included, so that they treat absent arcs alike."""
    with np.errstate(divide="ignore"):
        return tuple(np.where(w > 0, np.log(np.maximum(w, 1e-30)), _NEG)
                     .astype(np.float32) for w in (trans, init, final))


def graph_log_arrays(g, device):
    """StateGraph -> (log_trans, state_pdf, log_init, log_final) tensors
    on ``device`` (``log_weights``' float32 logs; int64 pdfs)."""
    dev = resolve_device(device)
    lt, li, lf = (torch.from_numpy(a).to(dev)
                  for a in log_weights(g.trans, g.init, g.final))
    return (lt, torch.tensor(np.asarray(g.state_pdf, np.int64), device=dev),
            li, lf)


def path_to_phones(path: np.ndarray, num_phones: int) -> list:
    """CI den-graph state path -> decoded phone sequence.

    Layout from graphs/den_graph.py: states [enter(0..P-1), loop(0..P-1)];
    a phone is emitted at each visit to an enter state (or at t=0 wherever
    the path starts, since chunks may begin mid-phone).
    """
    phones = []
    for t, s in enumerate(np.asarray(path)):
        s = int(s)
        if s < num_phones:  # enter state => new phone
            phones.append(s)
        elif t == 0:  # start mid-phone in a loop state
            phones.append(s - num_phones)
    return phones
