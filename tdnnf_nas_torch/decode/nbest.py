"""Numpy copy of ``tdnnf_nas_tpu.decode.nbest``: exact n-best decoding via
a backward-Viterbi heuristic and A* enumeration.

The round-1 stand-in for full lattice generation (reference:
``nnet3-latgen-faster`` lattices consumed by `steps/lmrescore_const_arpa.sh`
— SURVEY.md §3.3): with the exact cost-to-go from a backward Viterbi pass
as the A* heuristic, the first N complete hypotheses popped are exactly the
N best paths of the decoding graph, with per-path acoustic/graph score and
word sequence — everything n-gram (and later RNNLM) rescoring needs.

The backward scores and the A* enumeration both run on the host (the
enumeration touches only states on the n-best paths); the native
``data.native.nbest_decode_native`` is the same search in C++.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

from tdnnf_nas_torch.decode.viterbi import log_weights
from tdnnf_nas_torch.decode.wfst import DecodingGraph

_NEG = -1e30


def _backward_scores(obs_s: np.ndarray, log_trans: np.ndarray,
                     log_final: np.ndarray) -> np.ndarray:
    """bwd[t, s] = best score of the path suffix after being in s at t
    (excludes obs at t, includes final)."""
    t_len, s = obs_s.shape
    bwd = np.full((t_len, s), _NEG, np.float32)
    bwd[-1] = log_final
    for t in range(t_len - 2, -1, -1):
        # max over j of trans[s, j] + obs[t+1, j] + bwd[t+1, j]
        cand = log_trans + (obs_s[t + 1] + bwd[t + 1])[None, :]
        bwd[t] = cand.max(axis=1)
    return bwd


def nbest_decode(
    obs_logprob: np.ndarray,  # [T, P] one utterance
    dg: DecodingGraph,
    n: int = 10,
    acoustic_scale: float = 1.0,
) -> List[Tuple[List[int], float]]:
    """Returns up to n (word_sequence, total_score) best-first (exact)."""
    g = dg.graph
    log_trans, log_init, log_final = log_weights(g.trans, g.init, g.final)
    obs_s = np.asarray(obs_logprob, np.float32)[:, g.state_pdf] * acoustic_scale
    t_len, s = obs_s.shape
    bwd = _backward_scores(obs_s, log_trans, log_final)

    # A*: items (neg_priority, counter, t, state, score, words_tuple)
    heap = []
    counter = 0
    for st in range(s):
        if log_init[st] <= _NEG / 2:
            continue
        score = log_init[st] + obs_s[0, st]
        w = dg.word_of_state[st]
        words = (int(w),) if w >= 0 else ()
        heapq.heappush(heap, (-(score + bwd[0, st]), counter, 0, st, score, words))
        counter += 1

    results: List[Tuple[List[int], float]] = []
    seen_full = set()
    # arcs precomputed per state
    succ = [np.nonzero(log_trans[st] > _NEG / 2)[0] for st in range(s)]
    max_pops = 200000
    pops = 0
    while heap and len(results) < n and pops < max_pops:
        neg_pri, _, t, st, score, words = heapq.heappop(heap)
        pops += 1
        if t == t_len - 1:
            total = score + log_final[st]
            if total > _NEG / 2 and words not in seen_full:
                seen_full.add(words)
                results.append((list(words), float(total)))
            continue
        for nxt in succ[st]:
            ns = score + log_trans[st, nxt] + obs_s[t + 1, nxt]
            w = dg.word_of_state[nxt]
            nwords = words + ((int(w),) if w >= 0 else ())
            pri = ns + bwd[t + 1, nxt]
            if pri <= _NEG / 2:
                continue
            heapq.heappush(heap, (-pri, counter, t + 1, nxt, ns, nwords))
            counter += 1
    return results
