"""Numpy copy of ``tdnnf_nas_tpu.decode.lattice``: pruned word lattices.

Generation, best/n-best paths, posteriors, oracle WER, n-gram
lattice rescoring and determinization.

Equivalent of the reference's lattice pipeline: ``nnet3-latgen-faster``
produces beam-pruned lattices that `steps/lmrescore_const_arpa.sh`
(4-gram G-replacement) and `local/rnnlm/run_*` (pruned RNNLM rescoring)
consume — SURVEY.md §3.3.  The n-best path (decode/nbest.py) remains as
the exact-enumeration alternative; lattices keep the full pruned
hypothesis space so rescoring is not limited to a fixed N.

Construction is exact posterior pruning: with forward/backward Viterbi
scores over the dense first-pass graph, every arc whose best completion
is within ``lattice_beam`` of the global best path survives — the same
semantics Kaldi's lattice determinization targets, computed directly.
A native C++ generator (native/lattice.cc) handles production volumes;
this module is the tested reference semantics.

Lattice form: a time-synchronous DAG.  Node 0 is the super-start, node
``num_nodes-1`` the super-end; interior nodes are surviving (t, state)
pairs.  Arcs carry (word | -1, acoustic score, graph score) separately so
rescoring can swap the LM contribution out of the graph score.

``Lattice.out_arcs`` and the rescorers cost what the arcs cost, not
what the node ids span (a native lattice numbers every token it kept,
most of them on no arc); their results are the reference's.  The
frontier-batched RNNLM rescorer (``rescore_lattices_rnnlm``) keeps its
recurrent states on the scorer's device and fetches one array of
log-probs per longest-path level.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.decode.viterbi import log_weights
from tdnnf_nas_torch.decode.wfst import DecodingGraph, WordLM
from tdnnf_nas_torch.lm.ngram import BOS, EOS, NGramLM

_NEG = -1e30
_LN10 = math.log(10.0)


@dataclasses.dataclass
class Lattice:
    """Pruned word lattice (topologically sorted DAG).

    Arcs are parallel arrays sorted by src node.  ``word`` is -1 for
    epsilon arcs.  ``am`` is the acoustic contribution (scaled obs
    log-prob of the destination frame), ``gs`` the graph contribution
    (transition/init/final log-weight, including the first-pass LM).
    """

    num_nodes: int
    node_time: np.ndarray  # [N] int32; -1 for super start/end
    arc_src: np.ndarray  # [E] int32
    arc_dst: np.ndarray  # [E] int32
    arc_word: np.ndarray  # [E] int32 (-1 = eps)
    arc_am: np.ndarray  # [E] float32
    arc_gs: np.ndarray  # [E] float32

    @property
    def start(self) -> int:
        return 0

    @property
    def end(self) -> int:
        return self.num_nodes - 1

    @property
    def num_arcs(self) -> int:
        return int(self.arc_src.shape[0])

    def arc_score(self) -> np.ndarray:
        return self.arc_am + self.arc_gs

    def out_arcs(self) -> "_ArcGroups":
        """Arc indices grouped by src node: item n is node n's arcs, in
        arc order, as in the reference's list.  Built with one sort, not
        one list per node: a native lattice numbers every token it kept,
        so most of its (up to T x 4,096) nodes have no arc."""
        order = np.argsort(self.arc_src, kind="stable")
        bounds = np.searchsorted(self.arc_src[order],
                                 np.arange(self.num_nodes + 1))
        return _ArcGroups(order, bounds)


class _ArcGroups:
    """The sequence ``Lattice.out_arcs`` returns (views into one sort)."""

    def __init__(self, order: np.ndarray, bounds: np.ndarray):
        self._order, self._bounds = order, bounds

    def __len__(self) -> int:
        return len(self._bounds) - 1

    def __getitem__(self, node: int) -> np.ndarray:
        return self._order[self._bounds[node]: self._bounds[node + 1]]


def generate_lattice(
    obs_logprob: np.ndarray,  # [T, P] one utterance
    dg: DecodingGraph,
    acoustic_scale: float = 1.0,
    beam: float = 16.0,
    lattice_beam: float = 8.0,
) -> Lattice:
    """Beam decode one utterance into a pruned lattice.

    ``beam`` prunes the forward pass per frame (decoding beam);
    ``lattice_beam`` keeps every arc whose best completion is within
    that margin of the best path (lattice depth).
    """
    g = dg.graph
    lt, li, lf = log_weights(g.trans, g.init, g.final)
    obs_s = np.asarray(obs_logprob, np.float32)[:, g.state_pdf] * acoustic_scale
    t_len, s = obs_s.shape

    # forward Viterbi with per-frame beam
    alpha = np.full((t_len, s), _NEG, np.float32)
    alpha[0] = li + obs_s[0]
    alpha[0][alpha[0] < alpha[0].max() - beam] = _NEG
    for t in range(1, t_len):
        cand = alpha[t - 1][:, None] + lt  # [S, S]
        a = cand.max(axis=0) + obs_s[t]
        a[a < a.max() - beam] = _NEG
        alpha[t] = a

    # backward Viterbi over surviving states
    beta = np.full((t_len, s), _NEG, np.float32)
    beta[-1] = lf
    for t in range(t_len - 2, -1, -1):
        nxt = obs_s[t + 1] + beta[t + 1]
        nxt = np.where(alpha[t + 1] > _NEG / 2, nxt, _NEG)
        beta[t] = (lt + nxt[None, :]).max(axis=1)

    best = float((alpha[-1] + lf).max())
    if best <= _NEG / 2:
        raise ValueError("no complete path survived the beam")
    cutoff = best - lattice_beam

    # surviving nodes
    keep = (alpha + beta) >= cutoff  # [T, S]
    node_of: Dict[Tuple[int, int], int] = {}
    node_time = [-1]
    for t in range(t_len):
        for st in np.nonzero(keep[t])[0]:
            node_of[(t, int(st))] = len(node_time)
            node_time.append(t)
    end_node = len(node_time)
    node_time.append(-1)

    src, dst, word, am, gs = [], [], [], [], []
    # start arcs
    for st in np.nonzero(keep[0])[0]:
        st = int(st)
        if li[st] <= _NEG / 2:
            continue
        if li[st] + obs_s[0, st] + beta[0, st] < cutoff:
            continue
        src.append(0)
        dst.append(node_of[(0, st)])
        word.append(int(dg.word_of_state[st]))
        am.append(float(obs_s[0, st]))
        gs.append(float(li[st]))
    # transitions
    for t in range(t_len - 1):
        srcs = np.nonzero(keep[t])[0]
        for st in srcs:
            st = int(st)
            ds = np.nonzero(lt[st] > _NEG / 2)[0]
            for d in ds:
                d = int(d)
                if not keep[t + 1][d]:
                    continue
                tot = alpha[t, st] + lt[st, d] + obs_s[t + 1, d] + beta[t + 1, d]
                if tot < cutoff:
                    continue
                src.append(node_of[(t, st)])
                dst.append(node_of[(t + 1, d)])
                word.append(int(dg.word_of_state[d]))
                am.append(float(obs_s[t + 1, d]))
                gs.append(float(lt[st, d]))
    # final arcs
    for st in np.nonzero(keep[t_len - 1])[0]:
        st = int(st)
        if lf[st] <= _NEG / 2 or alpha[t_len - 1, st] + lf[st] < cutoff:
            continue
        src.append(node_of[(t_len - 1, st)])
        dst.append(end_node)
        word.append(-1)
        am.append(0.0)
        gs.append(float(lf[st]))

    order = np.argsort(np.asarray(src), kind="stable")
    return Lattice(
        num_nodes=end_node + 1,
        node_time=np.asarray(node_time, np.int32),
        arc_src=np.asarray(src, np.int32)[order],
        arc_dst=np.asarray(dst, np.int32)[order],
        arc_word=np.asarray(word, np.int32)[order],
        arc_am=np.asarray(am, np.float32)[order],
        arc_gs=np.asarray(gs, np.float32)[order],
    )


def _node_order(lat: Lattice) -> np.ndarray:
    """Topological order of the nodes on an arc (and start and end):
    start, interior by time, end.  Nodes on no arc are left out; they
    carry no path."""
    nodes = np.unique(np.concatenate(
        [lat.arc_src, lat.arc_dst, [lat.start, lat.end]]).astype(np.int64))
    t = lat.node_time[nodes]
    key = np.where(t < 0, np.where(nodes == lat.start, -1, 2**30), t)
    return nodes[np.argsort(key, kind="stable")]


def lattice_best_path(lat: Lattice) -> Tuple[List[int], float]:
    """Viterbi over the lattice: (words, score); equals the decoder's
    best path when the lattice was generated from it."""
    score = np.full(lat.num_nodes, _NEG, np.float64)
    back: List[Optional[int]] = [None] * lat.num_nodes
    score[lat.start] = 0.0
    w = lat.arc_score()
    for e in range(lat.num_arcs):
        s, d = int(lat.arc_src[e]), int(lat.arc_dst[e])
        v = score[s] + w[e]
        if v > score[d]:
            score[d] = v
            back[d] = e
    words: List[int] = []
    node = lat.end
    while back[node] is not None:
        e = back[node]
        if lat.arc_word[e] >= 0:
            words.append(int(lat.arc_word[e]))
        node = int(lat.arc_src[e])
    words.reverse()
    return words, float(score[lat.end])


def lattice_backward_best(lat: Lattice) -> np.ndarray:
    """best[n] = best score from node n to the end (A* heuristic)."""
    best = np.full(lat.num_nodes, _NEG, np.float64)
    best[lat.end] = 0.0
    w = lat.arc_score()
    for e in range(lat.num_arcs - 1, -1, -1):
        s, d = int(lat.arc_src[e]), int(lat.arc_dst[e])
        v = w[e] + best[d]
        if v > best[s]:
            best[s] = v
    return best


def lattice_nbest(lat: Lattice, n: int = 10,
                  max_pops: int = 200000) -> List[Tuple[List[int], float]]:
    """Exact n best distinct word sequences within the lattice (A* with
    the backward-best heuristic)."""
    bwd = lattice_backward_best(lat)
    outs = lat.out_arcs()
    w = lat.arc_score()
    heap = [(-bwd[lat.start], 0, lat.start, 0.0, ())]
    counter = 1
    results: List[Tuple[List[int], float]] = []
    seen = set()
    pops = 0
    while heap and len(results) < n and pops < max_pops:
        _, _, node, sc, words = heapq.heappop(heap)
        pops += 1
        if node == lat.end:
            if words not in seen:
                seen.add(words)
                results.append((list(words), sc))
            continue
        for e in outs[node]:
            ns = sc + float(w[e])
            d = int(lat.arc_dst[e])
            pri = ns + bwd[d]
            if pri <= _NEG / 2:
                continue
            nwords = words + ((int(lat.arc_word[e]),)
                              if lat.arc_word[e] >= 0 else ())
            heapq.heappush(heap, (-pri, counter, d, ns, nwords))
            counter += 1
    return results


def lattice_arc_posteriors(lat: Lattice) -> Tuple[np.ndarray, float]:
    """Log-semiring forward-backward over the lattice.

    Returns (posteriors [E] summing to 1 over every time cut, logZ).
    Word-confidence / MBR inputs, matching Kaldi's lattice-to-post.
    """
    w = lat.arc_score().astype(np.float64)
    fwd = np.full(lat.num_nodes, -np.inf)
    fwd[lat.start] = 0.0
    for e in range(lat.num_arcs):
        s, d = int(lat.arc_src[e]), int(lat.arc_dst[e])
        fwd[d] = np.logaddexp(fwd[d], fwd[s] + w[e])
    bwd = np.full(lat.num_nodes, -np.inf)
    bwd[lat.end] = 0.0
    for e in range(lat.num_arcs - 1, -1, -1):
        s, d = int(lat.arc_src[e]), int(lat.arc_dst[e])
        bwd[s] = np.logaddexp(bwd[s], w[e] + bwd[d])
    log_z = float(fwd[lat.end])
    post = np.exp(fwd[lat.arc_src] + w + bwd[lat.arc_dst] - log_z)
    return post.astype(np.float32), log_z


def lattice_oracle_wer(lat: Lattice, ref: Sequence[int]) -> int:
    """Minimum edit distance between ``ref`` and any word sequence in the
    lattice (Kaldi ``lattice-oracle``)."""
    ref = list(ref)
    r = len(ref)
    big = 10**9
    d = np.full((lat.num_nodes, r + 1), big, np.int64)
    d[lat.start, 0] = 0
    # deletions at the start node
    for k in range(r):
        d[lat.start, k + 1] = min(d[lat.start, k + 1], d[lat.start, k] + 1)
    for e in range(lat.num_arcs):
        s, dn, wd = int(lat.arc_src[e]), int(lat.arc_dst[e]), int(lat.arc_word[e])
        if wd < 0:
            np.minimum(d[dn], d[s], out=d[dn])
        else:
            # insertion: hyp word, no ref consumed
            np.minimum(d[dn], d[s] + 1, out=d[dn])
            # match / substitution: consume one ref word
            cost = d[s, :r] + (np.asarray(ref) != wd)
            np.minimum(d[dn, 1:], cost, out=d[dn, 1:])
        # deletions: consume ref words in place at dn
        for k in range(r):
            if d[dn, k] + 1 < d[dn, k + 1]:
                d[dn, k + 1] = d[dn, k] + 1
    return int(d[lat.end, r])


def _old_lm_logprob(wlm, prev, word: int, word_to_token=str) -> float:
    """ln first-pass LM prob to REMOVE.  ``wlm`` is the dense builders'
    bigram WordLM (prev = last word id) or an lm.ngram.NGramLM — the G of
    the sparse HCLG (prev = tuple of last order-1 word tokens)."""
    if isinstance(prev, tuple):  # NGramLM old LM
        return wlm.log_prob_word(prev, word_to_token(word)) * _LN10
    return math.log(max(float(wlm.probs[prev + 1, word]), 1e-30))


def _old_lm_final(wlm, prev, word_to_token=str) -> float:
    if isinstance(prev, tuple):
        return wlm.log_prob_word(prev, EOS) * _LN10
    return math.log(max(float(wlm.final[prev + 1]), 1e-30))


def _old_ctx_init(old_lm):
    return (BOS,) if isinstance(old_lm, NGramLM) else -1


def _old_ctx_next(old_lm, prev, word: int, word_to_token=str):
    if isinstance(prev, tuple):
        return (prev + (word_to_token(word),))[-(old_lm.order - 1):] \
            if old_lm.order > 1 else ()
    return word


def _n_best_distinct(finals, n: int) -> List[Tuple[List[int], float]]:
    """Up to n (words, score) of distinct word sequences, best first."""
    finals = sorted(finals, key=lambda x: -x[0])
    seen = set()
    out = []
    for sc, words in finals:
        if words in seen:
            continue
        seen.add(words)
        out.append((list(words), sc))
        if len(out) >= n:
            break
    return out


def rescore_lattice(
    lat: Lattice,
    old_lm: WordLM,
    new_lm,
    lm_scale: float = 1.0,
    word_to_token=str,
    n: int = 1,
    beam: float = 20.0,
    max_states_per_node: int = 64,
) -> List[Tuple[List[int], float]]:
    """Lattice LM rescoring by G replacement (const-arpa semantics,
    `steps/lmrescore_const_arpa.sh`).

    Expands the lattice over new-LM histories: each search state is
    (lattice node, last order-1 words); on a word arc the first-pass
    bigram's contribution is removed from the graph score and the new
    LM's (log10, ARPA) conditional — scaled by ``lm_scale`` — is added.
    Exact up to the per-node ``beam`` / ``max_states_per_node`` pruning
    of expansion states.

    Returns up to ``n`` (words, score) best-first.
    """
    ctx_len = max(new_lm.order - 1, 0)
    outs = lat.out_arcs()
    order = _node_order(lat)
    # states[node]: {(prev_word, new-LM history) : (score, words)}.  prev_word
    # (the first-pass bigram context to remove) is tracked separately from
    # the new-LM history — the history is truncated to order-1 words, which
    # for low-order new LMs (unigram: ctx_len 0) would otherwise lose the
    # old-LM context and remove the BOS bigram on every arc.
    # (keyed by node: only nodes a path reaches get an entry)
    states: Dict[int, Dict[Tuple, Tuple[float, Tuple[int, ...]]]] = {
        lat.start: {(_old_ctx_init(old_lm), ()): (0.0, ())}}
    finals: List[Tuple[float, Tuple[int, ...]]] = []
    for node in order:
        node = int(node)
        if not states.get(node):
            continue
        # prune expansion states at this node
        items = sorted(states[node].items(), key=lambda kv: -kv[1][0])
        best_here = items[0][1][0]
        items = [(h, sw) for h, sw in items
                 if sw[0] >= best_here - beam][:max_states_per_node]
        for (prev, hist), (sc, words) in items:
            if node == lat.end:
                finals.append((sc, words))
                continue
            for e in outs[node]:
                d = int(lat.arc_dst[e])
                wd = int(lat.arc_word[e])
                base = float(lat.arc_am[e]) + float(lat.arc_gs[e])
                nprev, nhist, nwords, nsc = prev, hist, words, sc + base
                if wd >= 0:
                    ctx = [BOS] + [word_to_token(h) for h in hist]
                    lp_new = new_lm.log_prob_word(ctx, word_to_token(wd)) * _LN10
                    nsc += lm_scale * lp_new - _old_lm_logprob(
                        old_lm, prev, wd, word_to_token)
                    nhist = (hist + (wd,))[-ctx_len:] if ctx_len else ()
                    nprev = _old_ctx_next(old_lm, prev, wd, word_to_token)
                    nwords = words + (wd,)
                elif d == lat.end:
                    # final arc: swap the old LM's end-of-sentence prob
                    ctx = [BOS] + [word_to_token(h) for h in hist]
                    lp_new = new_lm.log_prob_word(ctx, EOS) * _LN10
                    nsc += lm_scale * lp_new - _old_lm_final(old_lm, prev,
                                                             word_to_token)
                key = (nprev, nhist)
                dst = states.setdefault(d, {})
                cur = dst.get(key)
                if cur is None or nsc > cur[0]:
                    dst[key] = (nsc, nwords)
    return _n_best_distinct(finals, n)


def _rnn_old_prev(old_lm, hist: Tuple[int, ...], word_to_token=str):
    """The first-pass LM's context of an RNNLM expansion state: the last
    order-1 tokens after <s> for an NGramLM, else the last word id."""
    if isinstance(old_lm, NGramLM):
        return ((BOS,) + tuple(word_to_token(h) for h in hist))[
            -(max(old_lm.order - 1, 1)):]
    return hist[-1] if hist else -1


def _mixer(interp_weight: float):
    """lp(lp_rnn, lp_old): the RNNLM alone at w >= 1, the old LM at w <= 0,
    else ln(w P_rnn + (1 - w) P_old) (Kaldi's `lmrescore_pruned.sh
    --weight`), clamped as ``rescore_nbest_rnnlm_batched`` does."""
    lw = math.log(max(interp_weight, 1e-30))
    lnw = math.log(max(1.0 - interp_weight, 1e-30))

    def mix(lp_rnn: float, lp_old: float) -> float:
        if interp_weight >= 1.0:
            return lp_rnn
        if interp_weight <= 0.0:
            return lp_old
        return float(np.logaddexp(lw + lp_rnn, lnw + lp_old))

    return mix


def rescore_lattice_rnnlm(
    lat: Lattice,
    old_lm: WordLM,
    scorer,
    lm_scale: float = 1.0,
    hist_len: int = 3,
    n: int = 1,
    beam: float = 20.0,
    max_states_per_node: int = 32,
    word_to_token=str,
    interp_weight: float = 1.0,
) -> List[Tuple[List[int], float]]:
    """Pruned RNNLM lattice rescoring with n-gram history clustering, the
    Kaldi `rnnlm/lmrescore_pruned.sh` approximation: expansion states
    sharing a lattice node and the last ``hist_len`` words are merged
    (best kept), each carrying its own recurrent state.

    ``scorer`` provides ``initial_state()``, ``advance(state, word) ->
    (ln p, new_state)`` and ``final_logprob(state)``
    (``lm/rnnlm.RnnLMScorer``): one device step and one host fetch per
    expansion.  ``interp_weight`` < 1 interpolates with the first-pass LM
    in probability space; 1.0 replaces it.
    """
    mix = _mixer(interp_weight)
    outs = lat.out_arcs()
    # states[node]: {hist: (score, words, rnn_state)}, for nodes reached
    states: Dict[int, Dict[Tuple[int, ...], Tuple[float, Tuple[int, ...],
                                                  object]]] = {
        lat.start: {(): (0.0, (), scorer.initial_state())}}
    finals: List[Tuple[float, Tuple[int, ...]]] = []
    for node in _node_order(lat):
        node = int(node)
        if not states.get(node):
            continue
        items = sorted(states[node].items(), key=lambda kv: -kv[1][0])
        best_here = items[0][1][0]
        items = [(h, v) for h, v in items
                 if v[0] >= best_here - beam][:max_states_per_node]
        for hist, (sc, words, rstate) in items:
            if node == lat.end:
                finals.append((sc, words))
                continue
            prev = _rnn_old_prev(old_lm, hist, word_to_token)
            for e in outs[node]:
                d = int(lat.arc_dst[e])
                wd = int(lat.arc_word[e])
                base = float(lat.arc_am[e]) + float(lat.arc_gs[e])
                if wd >= 0:
                    lp, nstate = scorer.advance(rstate, wd)
                    lp_old = _old_lm_logprob(old_lm, prev, wd, word_to_token)
                    nsc = sc + base + lm_scale * mix(lp, lp_old) - lp_old
                    nhist = (hist + (wd,))[-hist_len:]
                    nwords = words + (wd,)
                elif d == lat.end:
                    lp_old = _old_lm_final(old_lm, prev, word_to_token)
                    nsc = (sc + base - lp_old + lm_scale
                           * mix(scorer.final_logprob(rstate), lp_old))
                    nstate, nhist, nwords = rstate, hist, words
                else:
                    nsc, nstate, nhist, nwords = sc + base, rstate, hist, words
                dst = states.setdefault(d, {})
                cur = dst.get(nhist)
                if cur is None or nsc > cur[0]:
                    dst[nhist] = (nsc, nwords, nstate)
    return _n_best_distinct(finals, n)


class _StatePool:
    """The frontier rescorer's recurrent rows (h, c, px) on the device,
    each addressed by one global row index (row 0: <s>).  Each level's
    new rows are appended in place; capacity doubles when full."""

    def __init__(self, rows):
        self.bufs = list(rows)
        self.n = rows[0].shape[0]

    def append(self, rows) -> int:
        """Store rows [N, ...]; returns the index of the first."""
        k = rows[0].shape[0]
        if self.n + k > self.bufs[0].shape[0]:
            cap = max(2 * self.bufs[0].shape[0], self.n + k)
            grown = []
            for b in self.bufs:
                g = b.new_empty((cap,) + tuple(b.shape[1:]))
                g[: self.n] = b[: self.n]
                grown.append(g)
            self.bufs = grown
        for b, r in zip(self.bufs, rows):
            b[self.n: self.n + k] = r
        self.n += k
        return self.n - k

    def gather(self, idx):
        """Rows ``idx`` (a device index tensor) of every buffer."""
        return [b.index_select(0, idx) for b in self.bufs]


def _longest_path_levels(lat: Lattice, outs: "_ArcGroups"):
    """{node: level} over the nodes on an arc (and start and end), in
    ascending node id: the longest arc path from the start, so every arc
    raises the level.  Relaxed in ``_node_order`` (start, by time, end)."""
    active = np.unique(np.concatenate(
        [lat.arc_src, lat.arc_dst, [lat.start, lat.end]]))
    lev = {int(v): 0 for v in active}
    for node in _node_order(lat):
        node = int(node)
        nxt = lev[node] + 1
        for d in lat.arc_dst[outs[node]]:
            d = int(d)
            if lev[d] < nxt:
                lev[d] = nxt
    return lev


def rescore_lattices_rnnlm(
    lats: List[Lattice],
    old_lm: WordLM,
    scorer,
    lm_scale: float = 1.0,
    hist_len: int = 3,
    n: int = 1,
    beam: float = 20.0,
    max_states_per_node: int = 32,
    word_to_token=str,
    interp_weight: float = 1.0,
) -> List[List[Tuple[List[int], float]]]:
    """Frontier-batched pruned RNNLM lattice rescoring: the results of
    :func:`rescore_lattice_rnnlm` on each lattice (tested), with one
    device call per longest-path level for all lattices together.

    Nodes are grouped into longest-path levels (every arc raises the
    level, so a level's states are final when it is expanded), and every
    word or final expansion of a level, across all lattices, advances in
    one ``scorer.advance_batch`` (``lm/rnnlm.RnnLMScorer``).  Recurrent
    states stay on the device in one pool; a level uploads one [2, N]
    index array (pool rows, words) and fetches one [2, N] array of
    log-probs.  Returns one n-best list per lattice.
    """
    mix = _mixer(interp_weight)
    # the old LM's lookups repeat heavily across hypotheses and lattices
    prev_cache: Dict[tuple, object] = {}
    lp_cache: Dict[tuple, float] = {}
    fin_cache: Dict[object, float] = {}

    def old_prev(hist):
        v = prev_cache.get(hist)
        if v is None:
            v = prev_cache[hist] = _rnn_old_prev(old_lm, hist, word_to_token)
        return v

    def old_lp(prev, wd):
        v = lp_cache.get((prev, wd))
        if v is None:
            v = lp_cache[(prev, wd)] = _old_lm_logprob(old_lm, prev, wd,
                                                       word_to_token)
        return v

    def old_fin(prev):
        v = fin_cache.get(prev)
        if v is None:
            v = fin_cache[prev] = _old_lm_final(old_lm, prev, word_to_token)
        return v

    outs_all = [lat.out_arcs() for lat in lats]
    by_level: Dict[int, List[Tuple[int, int]]] = {}
    for li, (lat, outs) in enumerate(zip(lats, outs_all)):
        for node, lv in _longest_path_levels(lat, outs).items():
            by_level.setdefault(lv, []).append((li, node))

    pool = _StatePool(scorer.initial_state_batch())
    # states[li][node]: hist -> (score, words, pool row)
    states: List[Dict[int, Dict[tuple, tuple]]] = [
        {lat.start: {(): (0.0, (), 0)}} for lat in lats]
    finals: List[List[Tuple[float, tuple]]] = [[] for _ in lats]

    for level in sorted(by_level):
        rows: List[int] = []
        words_in: List[int] = []
        meta: List[tuple] = []  # (li, dst, base, hist, score, words)
        for li, node in by_level[level]:
            lat = lats[li]
            here = states[li].get(node)
            if not here:
                continue
            items = sorted(here.items(), key=lambda kv: -kv[1][0])
            best_here = items[0][1][0]
            items = [(h, v) for h, v in items
                     if v[0] >= best_here - beam][:max_states_per_node]
            for hist, (sc, words, row) in items:
                if node == lat.end:
                    finals[li].append((sc, words))
                    continue
                for e in outs_all[li][node]:
                    d = int(lat.arc_dst[e])
                    wd = int(lat.arc_word[e])
                    base = float(lat.arc_am[e]) + float(lat.arc_gs[e])
                    if wd >= 0 or d == lat.end:
                        rows.append(row)
                        words_in.append(wd)
                        meta.append((li, d, base, hist, sc, words))
                    else:  # epsilon: pass the state through
                        dd = states[li].setdefault(d, {})
                        cur = dd.get(hist)
                        if cur is None or sc + base > cur[0]:
                            dd[hist] = (sc + base, words, row)
        if not rows:
            continue
        idx = torch.as_tensor(np.asarray([rows, words_in], np.int64),
                              device=pool.bufs[0].device)
        h, c, px = pool.gather(idx[0])
        h2, c2, px2, lp_w, lp_eos = scorer.advance_batch(h, c, px, idx[1])
        first = pool.append((h2, c2, px2))
        for i, (li, d, base, hist, sc, words) in enumerate(meta):
            wd = words_in[i]
            prev = old_prev(hist)
            dd = states[li].setdefault(d, {})
            if wd < 0:  # final arc: swap the old LM's </s> for the mix
                lp_old = old_fin(prev)
                nsc = (sc + base - lp_old
                       + lm_scale * mix(float(lp_eos[i]), lp_old))
                cur = dd.get(hist)
                if cur is None or nsc > cur[0]:
                    dd[hist] = (nsc, words, rows[i])
                continue
            lp_old = old_lp(prev, wd)
            nsc = sc + base + lm_scale * mix(float(lp_w[i]), lp_old) - lp_old
            nhist = (hist + (wd,))[-hist_len:]
            cur = dd.get(nhist)
            if cur is None or nsc > cur[0]:
                dd[nhist] = (nsc, words + (wd,), first + i)
    return [_n_best_distinct(f, n) for f in finals]


def determinize_lattice(lat: Lattice, max_states: int = 200000) -> Lattice:
    """Word-level lattice determinization (tropical semiring).

    Equivalent of Kaldi's `lattice-determinize` (run before LM rescoring by
    `steps/lmrescore_const_arpa.sh`): the result contains each word
    sequence AT MOST once, with the score of its best path; epsilon arcs
    are removed.  Implemented as weighted subset construction over the
    max-tropical semiring: a determinized state is a set of
    (lattice-node, residual-score) pairs normalized so max residual = 0.

    Output arcs carry the merged score in ``gs`` (``am`` zeroed — per-frame
    alignment is intentionally collapsed, as in word-level determinization);
    ``node_time`` is -1 (times merge).  Raises if the construction exceeds
    ``max_states`` (can be exponential on adversarial inputs; beam-pruned
    lattices are fine).
    """
    outs = lat.out_arcs()
    end = lat.end

    def closure(pairs):
        """Follow epsilon arcs, max-accumulating scores.  pairs: {node: w}."""
        best = dict(pairs)
        stack = list(pairs.items())
        while stack:
            n, w = stack.pop()
            if n == end:
                continue
            for e in outs[n]:
                if int(lat.arc_word[e]) >= 0:
                    continue
                d = int(lat.arc_dst[e])
                nw = w + float(lat.arc_am[e]) + float(lat.arc_gs[e])
                if nw > best.get(d, -np.inf):
                    best[d] = nw
                    stack.append((d, nw))
        return best

    def key_of(pairs):
        return tuple(sorted((n, round(w, 6)) for n, w in pairs.items()))

    start_pairs = closure({lat.start: 0.0})
    m0 = max(start_pairs.values())
    start_pairs = {n: w - m0 for n, w in start_pairs.items()}

    state_ids = {key_of(start_pairs): 0}
    state_pairs = [start_pairs]
    queue = [0]
    # det arcs: (src, dst, word, weight); final weights per det state
    arcs = []
    finals = {}
    if end in start_pairs:
        finals[0] = m0 + start_pairs[end]

    while queue:
        s = queue.pop()
        pairs = state_pairs[s]
        # group outgoing word arcs by word
        by_word = {}
        for n, w in pairs.items():
            if n == end:
                continue
            for e in outs[n]:
                v = int(lat.arc_word[e])
                if v < 0:
                    continue
                d = int(lat.arc_dst[e])
                nw = w + float(lat.arc_am[e]) + float(lat.arc_gs[e])
                cur = by_word.setdefault(v, {})
                if nw > cur.get(d, -np.inf):
                    cur[d] = nw
        for v, dsts in sorted(by_word.items()):
            dsts = closure(dsts)
            m = max(dsts.values())
            norm = {n: w - m for n, w in dsts.items()}
            k = key_of(norm)
            t = state_ids.get(k)
            if t is None:
                t = len(state_pairs)
                if t >= max_states:
                    raise RuntimeError("determinization exceeded max_states")
                state_ids[k] = t
                state_pairs.append(norm)
                queue.append(t)
                if end in norm:
                    finals[t] = norm[end]
            arcs.append((s, t, v, m))

    # assemble: extra super-end node; final weights become eps arcs to it
    n_det = len(state_pairs)
    for s, wf in sorted(finals.items()):
        arcs.append((s, n_det, -1, wf))

    # topologically renumber (downstream consumers index arcs by src order
    # == topo order); subset-construction ids are discovery order, not topo
    n_all = n_det + 1
    adj = [[] for _ in range(n_all)]
    indeg = np.zeros(n_all, np.int64)
    for s, t, _, _ in arcs:
        adj[s].append(t)
        indeg[t] += 1
    order = []
    stack = [i for i in range(n_all) if indeg[i] == 0]
    while stack:
        u = stack.pop()
        order.append(u)
        for t in adj[u]:
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(t)
    assert len(order) == n_all, "determinized lattice not acyclic"
    remap = np.empty(n_all, np.int64)
    # keep start first and super-end last
    order = [u for u in order if u not in (0, n_det)]
    remap[0] = 0
    for i, u in enumerate(order):
        remap[u] = i + 1
    remap[n_det] = n_all - 1
    arcs = sorted(((int(remap[s]), int(remap[t]), v, w)
                   for s, t, v, w in arcs), key=lambda a: a[0])
    return Lattice(
        num_nodes=n_all,
        node_time=np.full(n_all, -1, np.int32),
        arc_src=np.asarray([a[0] for a in arcs], np.int32),
        arc_dst=np.asarray([a[1] for a in arcs], np.int32),
        arc_word=np.asarray([a[2] for a in arcs], np.int32),
        arc_am=np.zeros(len(arcs), np.float32),
        arc_gs=np.asarray([a[3] for a in arcs], np.float32),
    )
