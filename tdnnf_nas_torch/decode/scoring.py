"""Numpy copy of ``tdnnf_nas_tpu.decode.scoring`` (sclite-equivalent WER).

The reference scores decodes with sclite against stm/glm references
(`run_TDNN_DARTSV3_fbk_stride_cvupdate.sh:224-239`); this module gives
the same alignment-based WER: a Levenshtein alignment per utterance,
substitutions, insertions and deletions pooled over the corpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """Levenshtein alignment counts: {sub, ins, del, hits, ref_len}."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels)
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[:, 0] = np.arange(n + 1)
    dp[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub_cost = dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dp[i, j] = min(sub_cost, dp[i - 1, j] + 1, dp[i, j - 1] + 1)
    # backtrace for counts
    i, j = n, m
    subs = ins = dels = hits = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] == hyp[j - 1]:
                hits += 1
            else:
                subs += 1
            i, j = i - 1, j - 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            ins += 1
            j -= 1
        else:
            dels += 1
            i -= 1
    return {"sub": subs, "ins": ins, "del": dels, "hits": hits, "ref_len": n}


def wer(ref: Sequence, hyp: Sequence) -> float:
    c = edit_distance(ref, hyp)
    return 100.0 * (c["sub"] + c["ins"] + c["del"]) / max(c["ref_len"], 1)


def score_corpus(
    refs: List[Sequence], hyps: List[Sequence]
) -> Dict[str, float]:
    """Corpus-level WER (error counts pooled over utterances, as sclite)."""
    tot = {"sub": 0, "ins": 0, "del": 0, "hits": 0, "ref_len": 0}
    for r, h in zip(refs, hyps):
        c = edit_distance(r, h)
        for k in tot:
            tot[k] += c[k]
    errs = tot["sub"] + tot["ins"] + tot["del"]
    return {
        "wer": 100.0 * errs / max(tot["ref_len"], 1),
        "sub": tot["sub"], "ins": tot["ins"], "del": tot["del"],
        "ref_len": tot["ref_len"],
    }
