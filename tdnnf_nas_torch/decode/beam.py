"""Port of ``tdnnf_nas_tpu.decode.beam``: time-synchronous beam search
over sparse decoding graphs.

The ``nnet3-latgen-faster`` equivalent (SURVEY.md §3.3) for the arc-list
HCLG of decode/graph_sparse.py: Viterbi token passing with epsilon-closure
(backoff/junction chains), score-beam + max-active pruning, one-best
traceback, and pruned lattice output compatible with the lattice-rescoring
stack (decode/lattice.py).

The acoustic forward runs batched on the card
(``recipes.chain_recipes.forward_corpus``); the search runs on the host,
as in the reference (GPU forward + CPU WFST search).  ``beam_decode_sparse``
runs the C++ decoder (``native/beam_sparse.cc``, built by
``data.native.get_decoder_lib``) unless the caller asks for the numpy one
(``native=False``).  Unlike the reference's ``native="auto"``, nothing
falls back: a decoder library that cannot be built raises.
``_beam_decode_once`` is the numpy version (the tests hold the C++ decoder
to it): per frame, the arcs of all active tokens are expanded as one CSR
gather, with no per-token Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from tdnnf_nas_torch.data import native as _native
from tdnnf_nas_torch.decode.graph_sparse import SparseDecodingGraph
from tdnnf_nas_torch.decode.lattice import Lattice

_NEG = -1e30


def _expand_arcs(g: SparseDecodingGraph, states: np.ndarray):
    """All out-arc indices of ``states`` (CSR gather, no Python loop).
    Returns (arc_idx [A], src_token_idx [A])."""
    starts = g.out_start[states]
    ends = g.out_start[states + 1]
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    src_tok = np.repeat(np.arange(len(states), dtype=np.int64), counts)
    # offsets within each run: arange(total) - run_start_positions
    run_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    offs = np.arange(total, dtype=np.int64) - np.repeat(run_starts, counts)
    arc_idx = np.repeat(starts, counts) + offs
    return arc_idx, src_tok


def _recombine(dst: np.ndarray, scores: np.ndarray):
    """Per-destination max: returns (unique_dst, best_score, argmax_index
    into the input arrays)."""
    order = np.lexsort((-scores, dst))
    d = dst[order]
    first = np.ones(len(d), bool)
    first[1:] = d[1:] != d[:-1]
    sel = order[first]
    return dst[sel], scores[sel], sel



def _final_closure(g: SparseDecodingGraph, states: np.ndarray) -> np.ndarray:
    """Per-token best end-of-utterance weight: max over label-free epsilon
    paths from each state of (path weight + final_w at the junction).
    ~-1e30 where no final junction is reachable."""
    n = len(states)
    best = g.final_w[states].astype(np.float64).copy()
    cur_states = np.asarray(states, np.int64)
    cur_scores = np.zeros((n,), np.float64)
    cur_tok = np.arange(n, dtype=np.int64)
    for _depth in range(64):
        arc_idx, src_tok = _expand_arcs(g, cur_states)
        if len(arc_idx) == 0:
            break
        dst = g.arc_dst[arc_idx]
        ne = (g.state_pdf[dst] < 0) & (g.arc_word[arc_idx] < 0)
        if not ne.any():
            break
        dst = dst[ne]
        sc = cur_scores[src_tok[ne]] + g.arc_w[arc_idx][ne]
        tok = cur_tok[src_tok[ne]]
        f = sc + g.final_w[dst]
        np.maximum.at(best, tok, f)
        # recombine per (dst, tok) pair for the next hop
        key = dst.astype(np.int64) * (n + 1) + tok
        order = np.lexsort((-sc, key))
        k = key[order]
        first = np.ones(len(k), bool)
        first[1:] = k[1:] != k[:-1]
        sel = order[first]
        cur_states, cur_scores, cur_tok = dst[sel], sc[sel], tok[sel]
    return best.astype(np.float32)


@dataclasses.dataclass
class BeamDecodeResult:
    words: List[int]
    score: float
    lattice: Optional[Lattice] = None
    num_active_mean: float = 0.0


class BeamSearchDied(RuntimeError):
    """No token survived a frame advance (beam too narrow for the graph)."""


def beam_decode_sparse(
    obs_logprob: np.ndarray,  # [T, P]
    g: SparseDecodingGraph,
    acoustic_scale: float = 1.0,
    beam: float = 16.0,
    max_active: int = 7000,
    lattice: bool = False,
    lattice_beam: float = 8.0,
    retry_beam: float = 0.0,
    native: bool = True,
) -> BeamDecodeResult:
    """Time-synchronous beam search over a SparseDecodingGraph.

    ``retry_beam`` > ``beam`` enables Kaldi `decode.sh`-style adaptive
    re-decode: if the search dies (no surviving token at some frame), the
    whole utterance is re-decoded with the beam doubled, up to
    ``retry_beam`` (ref steps/nnet3/decode.sh retry semantics).

    ``native``: True (the default) runs the C++ decoder
    (native/beam_sparse.cc, parity-tested against this module) and raises
    if its library cannot be built; False runs the numpy version.
    """
    once = _beam_decode_once
    if native:
        def once(obs, g_, ac, b_, ma, lat, lb):  # noqa: E306
            words, score, l, n_active = _native.beam_decode_sparse_csr_native(
                obs, g_, acoustic_scale=ac, beam=b_, max_active=ma,
                lattice=lat, lattice_beam=lb)
            return BeamDecodeResult(words=words, score=score, lattice=l,
                                    num_active_mean=n_active)
    b = beam
    while True:
        try:
            return once(obs_logprob, g, acoustic_scale, b,
                        max_active, lattice, lattice_beam)
        except BeamSearchDied:
            if b >= retry_beam:
                raise
            b = min(b * 2.0, retry_beam)


def _beam_decode_once(
    obs_logprob: np.ndarray,
    g: SparseDecodingGraph,
    acoustic_scale: float,
    beam: float,
    max_active: int,
    lattice: bool,
    lattice_beam: float,
) -> BeamDecodeResult:
    obs = np.asarray(obs_logprob, np.float32) * acoustic_scale
    t_len = obs.shape[0]
    pdf = g.state_pdf
    emitting = pdf >= 0

    # --- per-frame token store for traceback/lattice ---
    frame_states: List[np.ndarray] = []
    frame_scores: List[np.ndarray] = []
    frame_prev: List[np.ndarray] = []  # index into previous frame's tokens
    frame_word: List[np.ndarray] = []  # word crossed on the transition
    # recorded relaxation events for the lattice (surviving arcs)
    ev_prev: List[np.ndarray] = []
    ev_dst_tok: List[np.ndarray] = []  # index into current frame tokens
    ev_word: List[np.ndarray] = []
    ev_gs: List[np.ndarray] = []  # graph part of the transition
    ev_am: List[np.ndarray] = []  # acoustic part (dst frame)

    def transition(src_states, src_scores, am_t):
        """One frame advance incl. epsilon closure.  Returns candidate
        (dst_states, scores, prev_tok, word) BEFORE recombination, where
        scores include am of the destination."""
        cand_dst, cand_sc, cand_prev, cand_word, cand_gs = [], [], [], [], []
        cur_states = src_states
        cur_scores = src_scores
        cur_prev = np.arange(len(src_states), dtype=np.int64)
        cur_word = np.full((len(src_states),), -1, np.int32)
        cur_gs = np.zeros((len(src_states),), np.float32)
        for _depth in range(64):  # backoff chains are short; hard stop
            arc_idx, src_tok = _expand_arcs(g, cur_states)
            if len(arc_idx) == 0:
                break
            dst = g.arc_dst[arc_idx]
            w = g.arc_w[arc_idx]
            sc = cur_scores[src_tok] + w
            gs = cur_gs[src_tok] + w
            word = np.where(g.arc_word[arc_idx] >= 0, g.arc_word[arc_idx],
                            cur_word[src_tok])
            prev = cur_prev[src_tok]
            is_em = emitting[dst]
            if is_em.any():
                d = dst[is_em]
                am = am_t[pdf[d]]
                cand_dst.append(d)
                cand_sc.append(sc[is_em] + am)
                cand_prev.append(prev[is_em])
                cand_word.append(word[is_em])
                cand_gs.append(gs[is_em])
            ne = ~is_em
            if not ne.any():
                break
            # recombine non-emitting frontier to bound the closure
            nd, ns, sel = _recombine(dst[ne], sc[ne])
            cur_states, cur_scores = nd, ns
            cur_prev = prev[ne][sel]
            cur_word = word[ne][sel]
            cur_gs = gs[ne][sel]
        if not cand_dst:
            return (np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                    np.zeros((0,), np.int64), np.zeros((0,), np.int32),
                    np.zeros((0,), np.float32))
        return (np.concatenate(cand_dst), np.concatenate(cand_sc),
                np.concatenate(cand_prev), np.concatenate(cand_word),
                np.concatenate(cand_gs))

    # --- t = 0: closure from the start junction ---
    states = np.asarray([g.start_state], np.int64)
    scores = np.asarray([0.0], np.float32)
    n_active_total = 0
    for t in range(t_len):
        dst, sc, prev, word, gs = transition(states, scores, obs[t])
        if len(dst) == 0:
            raise BeamSearchDied(f"beam search died at frame {t}")
        udst, usc, sel = _recombine(dst, sc)
        # beam + max-active pruning
        cutoff = usc.max() - beam
        keep = usc >= cutoff
        if keep.sum() > max_active:
            kth = np.partition(usc, len(usc) - max_active)[len(usc) - max_active]
            keep = usc >= max(kth, cutoff)
        udst, usc, sel = udst[keep], usc[keep], sel[keep]
        if lattice:
            # record ALL candidate arcs landing on surviving tokens within
            # the lattice beam of the token's best
            tok_of_state = {int(s): i for i, s in enumerate(udst)}
            land = np.asarray([tok_of_state.get(int(d), -1) for d in dst],
                              np.int64)
            ok = land >= 0
            ok &= sc >= usc[np.maximum(land, 0)] - lattice_beam
            ev_prev.append(prev[ok])
            ev_dst_tok.append(land[ok])
            ev_word.append(word[ok])
            ev_gs.append(gs[ok])
            ev_am.append(sc[ok] - gs[ok]
                         - (scores[prev[ok]] if t > 0 else 0.0))
        frame_states.append(udst)
        frame_scores.append(usc)
        frame_prev.append(prev[sel])
        frame_word.append(word[sel])
        states, scores = udst.astype(np.int64), usc
        n_active_total += len(udst)

    # --- final epsilon pass: propagate to final-weighted junctions ---
    best_tok = int(np.argmax(scores))
    fw = _final_closure(g, states)
    fin_sc = scores + fw
    best_final_tok = None
    if (fin_sc > -1e29).any():
        best_final_tok = int(np.argmax(fin_sc))
        best_final = float(fin_sc[best_final_tok])

    use_tok = best_final_tok if best_final_tok is not None else best_tok
    total = best_final if best_final_tok is not None else float(scores[best_tok])

    # --- traceback ---
    words_rev: List[int] = []
    tok = use_tok
    for t in range(t_len - 1, -1, -1):
        w = int(frame_word[t][tok])
        if w >= 0:
            words_rev.append(w)
        tok = int(frame_prev[t][tok])
    words = words_rev[::-1]

    lat = None
    if lattice:
        lat = _build_lattice(frame_states, frame_scores, ev_prev, ev_dst_tok,
                             ev_word, ev_gs, ev_am, g, lattice_beam, total)
    return BeamDecodeResult(words=words, score=total, lattice=lat,
                            num_active_mean=n_active_total / max(t_len, 1))


def _build_lattice(frame_states, frame_scores, ev_prev, ev_dst_tok, ev_word,
                   ev_gs, ev_am, g, lattice_beam, best_total) -> Lattice:
    """Exact forward/backward over the recorded beam-surviving arcs, pruned
    to lattice_beam around the best full path (the semantics Kaldi's
    lattice determinization targets — see decode/lattice.py)."""
    t_len = len(frame_states)
    # node ids: 0 = super start, then per (t, token); last = super end
    offs = [1]
    for t in range(t_len):
        offs.append(offs[-1] + len(frame_states[t]))
    n_nodes = offs[-1] + 1
    end = n_nodes - 1

    # forward best scores per token are frame_scores; backward pass over
    # recorded events
    bwd = [np.full((len(frame_states[t]),), _NEG, np.float32)
           for t in range(t_len)]
    # final arcs: last-frame tokens -> end via epsilon-final closure
    last = frame_states[-1]
    fin = _final_closure(g, last.astype(np.int64))
    if not (fin > -1e29).any():
        fin = np.zeros((len(last),), np.float32)  # no-final fallback
    bwd[t_len - 1] = fin
    for t in range(t_len - 1, 0, -1):
        prev, dtok = ev_prev[t], ev_dst_tok[t]
        w = ev_gs[t] + ev_am[t]
        cand = w + bwd[t][dtok]
        order = np.lexsort((-cand, prev))
        p = prev[order]
        first = np.ones(len(p), bool)
        first[1:] = p[1:] != p[:-1]
        upd = order[first]
        b = bwd[t - 1]
        np.maximum.at(b, prev[upd], cand[upd])

    node_time = np.full((n_nodes,), -1, np.int32)
    for t in range(t_len):
        node_time[offs[t]: offs[t + 1]] = t

    arc_src, arc_dst, arc_word, arc_am, arc_gs = [], [], [], [], []
    thresh = best_total - lattice_beam
    # start arcs (t=0 events have prev index into the virtual start)
    for t in range(t_len):
        prev, dtok = ev_prev[t], ev_dst_tok[t]
        gs_, am_, wd = ev_gs[t], ev_am[t], ev_word[t]
        if t == 0:
            fwd_prev = np.zeros((len(prev),), np.float32)
            src_nodes = np.zeros((len(prev),), np.int64)
        else:
            fwd_prev = frame_scores[t - 1][prev]
            src_nodes = offs[t - 1] + prev
        tot = fwd_prev + gs_ + am_ + bwd[t][dtok]
        ok = tot >= thresh
        arc_src.extend(src_nodes[ok].tolist())
        arc_dst.extend((offs[t] + dtok[ok]).tolist())
        arc_word.extend(wd[ok].tolist())
        arc_am.extend(am_[ok].tolist())
        arc_gs.extend(gs_[ok].tolist())
    # end arcs from last frame
    tot = frame_scores[-1] + fin
    ok = tot >= thresh
    idx = np.nonzero(ok)[0]
    arc_src.extend((offs[t_len - 1] + idx).tolist())
    arc_dst.extend([end] * len(idx))
    arc_word.extend([-1] * len(idx))
    arc_am.extend([0.0] * len(idx))
    arc_gs.extend(fin[idx].tolist())

    arc_src = np.asarray(arc_src, np.int32)
    order = np.argsort(arc_src, kind="stable")
    return Lattice(
        num_nodes=n_nodes,
        node_time=node_time,
        arc_src=arc_src[order],
        arc_dst=np.asarray(arc_dst, np.int32)[order],
        arc_word=np.asarray(arc_word, np.int32)[order],
        arc_am=np.asarray(arc_am, np.float32)[order],
        arc_gs=np.asarray(arc_gs, np.float32)[order],
    )
