"""Copy of ``tdnnf_nas_tpu.lm.ngram``: backoff n-gram language models.

Equivalent of the reference pipeline's SRILM-trained 3/4-gram LMs and
const-arpa rescoring (`run.sh:24-79` sw1_tg/sw1_fsh_fg,
`steps/lmrescore_const_arpa.sh` used at
`run_tdnn_7q_fbk_40_manual.sh:226-228`): estimation with interpolated
(Witten-Bell) smoothing and backoff, ARPA text serialization, and
sequence scoring with full backoff semantics.  Pure Python.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

BOS = "<s>"
EOS = "</s>"

LOG10 = math.log(10.0)


class NGramLM:
    """Backoff n-gram LM over string tokens.

    logprobs: {ngram tuple: log10 prob}; backoffs: {context tuple: log10 bow}.
    Scoring follows ARPA semantics: P(w|h) = p(h+w) if seen, else
    bow(h) * P(w|h[1:]).
    """

    def __init__(self, order: int,
                 logprobs: Dict[Tuple[str, ...], float],
                 backoffs: Dict[Tuple[str, ...], float]):
        self.order = order
        self.logprobs = logprobs
        self.backoffs = backoffs

    def log_prob_word(self, context: Sequence[str], word: str) -> float:
        """log10 P(word | context), with backoff."""
        ctx = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        while True:
            ng = ctx + (word,)
            if ng in self.logprobs:
                return self.logprobs[ng]
            if not ctx:
                return self.logprobs.get((word,), -99.0)
            bow = self.backoffs.get(ctx, 0.0)
            ctx = ctx[1:]
            # accumulate backoff weights down the chain
            return bow + self.log_prob_word(ctx, word)

    def score(self, words: Sequence[str], bos: bool = True, eos: bool = True) -> float:
        """Total log10 probability of a sentence."""
        ctx: Tuple[str, ...] = (BOS,) if bos else ()
        total = 0.0
        seq = list(words) + ([EOS] if eos else [])
        for w in seq:
            total += self.log_prob_word(ctx, w)
            ctx = (ctx + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total

    # ---- ARPA serialization ----

    def to_arpa(self) -> str:
        by_order = defaultdict(list)
        for ng, lp in self.logprobs.items():
            by_order[len(ng)].append((ng, lp))
        lines = ["\\data\\"]
        for n in range(1, self.order + 1):
            lines.append(f"ngram {n}={len(by_order[n])}")
        for n in range(1, self.order + 1):
            lines.append("")
            lines.append(f"\\{n}-grams:")
            for ng, lp in sorted(by_order[n]):
                bow = self.backoffs.get(ng) if n < self.order else None
                tail = f"\t{bow:.6f}" if bow is not None else ""
                lines.append(f"{lp:.6f}\t{' '.join(ng)}{tail}")
        lines.append("")
        lines.append("\\end\\")
        return "\n".join(lines)

    @classmethod
    def from_arpa(cls, text: str) -> "NGramLM":
        logprobs: Dict[Tuple[str, ...], float] = {}
        backoffs: Dict[Tuple[str, ...], float] = {}
        order = 0
        cur_n = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("\\data") or line.startswith("ngram "):
                continue
            if line.startswith("\\") and line.endswith("-grams:"):
                cur_n = int(line[1:].split("-")[0])
                order = max(order, cur_n)
                continue
            if line.startswith("\\end"):
                break
            if cur_n is None:
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            lp = float(parts[0])
            if "\t" in line:
                toks = tuple(parts[1].split())
                bow = float(parts[2]) if len(parts) > 2 else None
            else:
                toks = tuple(parts[1 : 1 + cur_n])
                bow = float(parts[1 + cur_n]) if len(parts) > 1 + cur_n else None
            logprobs[toks] = lp
            if bow is not None:
                backoffs[toks] = bow
        return cls(order, logprobs, backoffs)


def estimate_ngram_lm(
    sentences: Iterable[Sequence[str]], order: int = 3
) -> NGramLM:
    """Interpolated Witten-Bell n-gram estimation with backoff weights."""
    counts: List[Dict[Tuple[str, ...], float]] = [defaultdict(float)
                                                 for _ in range(order + 1)]
    for sent in sentences:
        toks = [BOS] + list(sent) + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                ng = tuple(toks[i : i + n])
                if n == 1 and ng == (BOS,):
                    continue  # BOS has no unigram prob
                counts[n][ng] += 1.0

    vocab = {w for (w,) in counts[1]}
    v = max(len(vocab), 1)

    # precomputed per-context totals/uniques (keeps estimation linear in the
    # number of distinct n-grams — required at real-LM scale)
    ctx_count: List[Dict[Tuple[str, ...], float]] = [defaultdict(float)
                                                     for _ in range(order + 1)]
    ctx_uniq: List[Dict[Tuple[str, ...], int]] = [defaultdict(int)
                                                  for _ in range(order + 1)]
    for n in range(2, order + 1):
        for ng, c in counts[n].items():
            ctx_count[n][ng[:-1]] += c
            ctx_uniq[n][ng[:-1]] += 1

    # interpolated WB probabilities
    probs: Dict[Tuple[str, ...], float] = {}
    uni_tot = sum(counts[1].values())

    def p_interp(ng: Tuple[str, ...]) -> float:
        n = len(ng)
        if n == 1:
            return (counts[1].get(ng, 0.0) + 1.0) / (uni_tot + v)
        cached = probs.get(ng)
        if cached is not None:
            return cached
        ctx = ng[:-1]
        cc = ctx_count[n].get(ctx, 0.0)
        if cc <= 0:
            return p_interp(ng[1:])
        lam = cc / (cc + ctx_uniq[n][ctx])
        return lam * counts[n].get(ng, 0.0) / cc + (1 - lam) * p_interp(ng[1:])

    for n in range(1, order + 1):  # low orders first so p_interp cache hits
        for ng in counts[n]:
            probs[ng] = p_interp(ng)

    # backoff weights so that sum_w P(w|ctx) == 1: accumulate the seen-mass
    # sums per context in one linear pass
    logprobs = {ng: math.log10(max(p, 1e-12)) for ng, p in probs.items()}
    seen_hi: Dict[Tuple[str, ...], float] = defaultdict(float)
    seen_lo: Dict[Tuple[str, ...], float] = defaultdict(float)
    for n in range(2, order + 1):
        for ng in counts[n]:
            ctx = ng[:-1]
            seen_hi[ctx] += probs[ng]
            seen_lo[ctx] += probs.get(ng[1:], probs.get((ng[-1],), 1e-12))
    backoffs: Dict[Tuple[str, ...], float] = {}
    for ctx, hi in seen_hi.items():
        num = max(1.0 - hi, 1e-12)
        den = max(1.0 - seen_lo[ctx], 1e-12)
        backoffs[ctx] = math.log10(num / den)
    return NGramLM(order, logprobs, backoffs)
