"""Numpy copy of ``tdnnf_nas_tpu.graphs.phone_lm`` (phone LMs).

Equivalent of Kaldi's ``chain-est-phone-lm``.  Two models, both exposed
through one FSA-walk interface (``walk_init``, ``walk``, ``final_prob``):

* ``PhoneLM``: interpolated bigram (dense [P+1, P] matrix), the LM of the
  dense biphone denominator (``graphs/den_graph.build_denominator_graph``);
* ``NGramPhoneLM``: higher-order with kept-state pruning (all bigram
  contexts kept; longer contexts grown best-first by training-data
  log-likelihood gain up to ``num_extra_lm_states``), an FSA over kept
  histories, the LM of the composed denominator.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

BOS = -1  # beginning-of-sequence context


@dataclasses.dataclass
class PhoneLM:
    """Bigram phone LM.

    probs[p+1, q] = P(q | p), with row 0 the BOS context.  Rows sum to
    P(end | p) + sum_q P(q | p) = 1 where ``final[p+1] = P(end | p)``.
    """

    probs: np.ndarray  # [P+1, P] float32
    final: np.ndarray  # [P+1] float32
    num_phones: int

    def log_prob(self, seq: Sequence[int]) -> float:
        lp = 0.0
        prev = BOS
        for p in seq:
            lp += float(np.log(self.probs[prev + 1, p]))
            prev = p
        return lp + float(np.log(self.final[prev + 1]))

    # --- uniform FSA-walk interface (shared with NGramPhoneLM) ---
    @property
    def order(self) -> int:
        return 2

    def walk_init(self) -> int:
        """Context handle at beginning-of-sequence."""
        return BOS

    def walk(self, ctx: int, q: int) -> Tuple[float, int]:
        """(P(q | ctx), next context): for a bigram, ctx is the prev phone."""
        return float(self.probs[ctx + 1, q]), q

    def final_prob(self, ctx: int) -> float:
        return float(self.final[ctx + 1])


def estimate_phone_lm(
    phone_seqs: Iterable[Sequence[int]],
    num_phones: int,
    interp: float = 0.1,
) -> PhoneLM:
    """Count-based interpolated bigram over training phone sequences.

    ``interp`` interpolates with the unigram distribution so every phone
    pair has nonzero probability (keeps the denominator graph fully
    connected, the property Kaldi gets from its un-pruned phone LM).
    """
    counts = np.zeros((num_phones + 1, num_phones), dtype=np.float64)
    final_counts = np.zeros((num_phones + 1,), dtype=np.float64)
    uni = np.zeros((num_phones,), dtype=np.float64)
    n_seqs = 0
    for seq in phone_seqs:
        n_seqs += 1
        prev = BOS
        for p in seq:
            counts[prev + 1, p] += 1.0
            uni[p] += 1.0
            prev = p
        final_counts[prev + 1] += 1.0
    if n_seqs == 0:
        raise ValueError("no phone sequences")
    uni = (uni + 1.0) / (uni.sum() + num_phones)
    tot = counts.sum(axis=1) + final_counts
    # final prob: fraction of times the context ended a sequence (floored)
    final = (final_counts + 0.5) / (tot + 1.0)
    row = counts.sum(axis=1)
    cond = counts / np.maximum(row[:, None], 1.0)
    cond = np.where(row[:, None] > 0, cond, uni[None, :])
    probs = (1.0 - interp) * cond + interp * uni[None, :]
    # renormalize so probs-row + final == 1
    probs = probs * (1.0 - final[:, None]) / probs.sum(axis=1, keepdims=True)
    return PhoneLM(
        probs=probs.astype(np.float32),
        final=final.astype(np.float32),
        num_phones=num_phones,
    )

History = Tuple[int, ...]  # most-recent phone last; BOS (-1) may lead


@dataclasses.dataclass
class NGramPhoneLM:
    """Pruned n-gram phone LM as an FSA over kept histories.

    States are kept context histories (all length-1 contexts incl. BOS,
    plus up to ``num_extra_lm_states`` longer ones).  ``probs[s, q]`` is the
    interpolated conditional, ``next_state[s, q]`` the longest-kept-suffix
    destination, ``final[s]`` the end-of-sequence probability; rows satisfy
    ``probs[s].sum() + final[s] == 1``.  Equivalent of the FST written by
    Kaldi's ``chain-est-phone-lm`` (upstream `src/chain/language-model.cc`,
    invoked at `steps/nnet3/chain/train.py:332`).
    """

    order: int
    num_phones: int
    hists: List[History]  # state id -> history
    probs: np.ndarray  # [NS, P] float64
    final: np.ndarray  # [NS] float64
    next_state: np.ndarray  # [NS, P] int32
    _state_of: Dict[History, int] = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        if self._state_of is None:
            self._state_of = {h: i for i, h in enumerate(self.hists)}

    @property
    def num_states(self) -> int:
        return len(self.hists)

    # --- uniform FSA-walk interface (shared with PhoneLM) ---
    def walk_init(self) -> int:
        return self._state_of[(BOS,)]

    def walk(self, ctx: int, q: int) -> Tuple[float, int]:
        return float(self.probs[ctx, q]), int(self.next_state[ctx, q])

    def final_prob(self, ctx: int) -> float:
        return float(self.final[ctx])


def estimate_ngram_phone_lm(
    phone_seqs: Iterable[Sequence[int]],
    num_phones: int,
    order: int = 4,
    num_extra_lm_states: int = 2000,
    interp: float = 0.1,
) -> NGramPhoneLM:
    """Estimate a pruned n-gram phone LM (``chain-est-phone-lm`` equivalent).

    All length-1 contexts (incl. BOS) become states; longer observed contexts
    are grown **best-first by log-likelihood gain** over their kept parent
    (Kaldi ranks candidate LM states the same way when honoring
    ``--num-extra-lm-states``) until the budget is spent.  Kept-state
    conditionals are recursively interpolated with the parent state
    (``interp`` mass to the backoff) so every transition stays nonzero —
    the property that keeps the denominator graph fully connected.
    """
    if order < 2:
        raise ValueError("order must be >= 2")
    seqs = [list(s) for s in phone_seqs]
    if not seqs:
        raise ValueError("no phone sequences")

    # --- count contexts of length 1..order-1 ---
    counts: Dict[History, np.ndarray] = {}
    finals: Dict[History, float] = {}
    uni = np.zeros((num_phones,), np.float64)

    def bump(h: History, q: int):
        c = counts.get(h)
        if c is None:
            c = counts[h] = np.zeros((num_phones,), np.float64)
        c[q] += 1.0

    for seq in seqs:
        hist: List[int] = [BOS]
        for q in seq:
            uni[q] += 1.0
            for k in range(1, min(len(hist), order - 1) + 1):
                bump(tuple(hist[-k:]), q)
            hist.append(q)
            if len(hist) > order - 1:
                hist = hist[-(order - 1):]
        for k in range(1, min(len(hist), order - 1) + 1):
            h = tuple(hist[-k:])
            finals[h] = finals.get(h, 0.0) + 1.0

    uni_smooth = (uni + 1.0) / (uni.sum() + num_phones)

    # --- kept states: all length-1 contexts, then best-first growth ---
    kept: Dict[History, int] = {}
    for p in range(-1, num_phones):
        kept[(p,)] = len(kept)

    def ctx_total(h: History) -> float:
        return float(counts.get(h, np.zeros(1)).sum()) + finals.get(h, 0.0)

    def smoothed(h: History) -> Tuple[np.ndarray, float]:
        """Interpolated conditional dist + final prob for context h,
        recursing through suffixes regardless of kept-ness (used for gain
        scoring; final table below recurses through kept parents only —
        identical when the parent chain is kept)."""
        if len(h) == 0:
            return uni_smooth.copy(), 1.0 / (len(seqs) + 1.0)
        pp, pf = smoothed(h[1:])
        c = counts.get(h)
        tot = ctx_total(h)
        if c is None or tot <= 0.0:
            return pp, pf
        ml = c / tot
        mlf = finals.get(h, 0.0) / tot
        return (1.0 - interp) * ml + interp * pp, (1.0 - interp) * mlf + interp * pf

    if order > 2 and num_extra_lm_states > 0:
        # gain(h) = sum_q c(h,q) log( p(q|h) / p(q|parent) ) + final term
        def gain(h: History) -> float:
            c = counts.get(h)
            if c is None:
                return -np.inf
            ph, fh = smoothed(h)
            pp, fp = smoothed(h[1:])
            g = float(np.sum(c * (np.log(ph) - np.log(pp))))
            fcnt = finals.get(h, 0.0)
            if fcnt > 0:
                g += fcnt * (np.log(max(fh, 1e-30)) - np.log(max(fp, 1e-30)))
            return g

        # best-first: heap seeded with all length-2 contexts; keeping a
        # state unlocks its observed length+1 extensions
        by_parent: Dict[History, List[History]] = {}
        for h in counts:
            if len(h) >= 2:
                by_parent.setdefault(h[1:], []).append(h)
        heap: List[Tuple[float, History]] = []
        for h in counts:
            if len(h) == 2:
                heapq.heappush(heap, (-gain(h), h))
        budget = num_extra_lm_states
        while budget > 0 and heap:
            negg, h = heapq.heappop(heap)
            if h in kept or negg >= 0.0:
                continue
            kept[h] = len(kept)
            budget -= 1
            for child in by_parent.get(h, []):
                if len(child) < order and child not in kept:
                    heapq.heappush(heap, (-gain(child), child))

    hists = [None] * len(kept)
    for h, i in kept.items():
        hists[i] = h
    ns = len(hists)

    # --- interpolated probs per kept state (parents are kept by constr.) ---
    probs = np.zeros((ns, num_phones), np.float64)
    final = np.zeros((ns,), np.float64)
    for h in sorted(kept, key=len):  # parents before children
        i = kept[h]
        if len(h) == 1:
            pp, pf = uni_smooth, 1.0 / (len(seqs) + 1.0)
        else:
            j = kept[h[1:]]
            pp, pf = probs[j], final[j]
        c = counts.get(h)
        tot = ctx_total(h)
        if c is None or tot <= 0.0:
            probs[i], final[i] = pp, pf
        else:
            ml = c / tot
            mlf = finals.get(h, 0.0) / tot
            probs[i] = (1.0 - interp) * ml + interp * pp
            final[i] = (1.0 - interp) * mlf + interp * pf
    final = np.maximum(final, 1e-4)
    probs = probs * (1.0 - final[:, None]) / probs.sum(axis=1, keepdims=True)

    # --- FSA transitions: longest kept suffix of (h, q) ---
    next_state = np.zeros((ns, num_phones), np.int32)
    for h, i in kept.items():
        for q in range(num_phones):
            ext = (h + (q,))[-(order - 1):]
            dst = None
            for k in range(len(ext), 0, -1):
                dst = kept.get(ext[-k:])
                if dst is not None:
                    break
            next_state[i, q] = dst
    return NGramPhoneLM(
        order=order,
        num_phones=num_phones,
        hists=hists,
        probs=probs,
        final=final,
        next_state=next_state,
    )
