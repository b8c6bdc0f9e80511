"""Copy of ``tdnnf_nas_tpu.decode.rescore``: n-best LM rescoring, swapping
the first-pass graph LM's scores for a bigger LM's.

Equivalent of the reference's lattice rescoring stages
(`steps/lmrescore_const_arpa.sh` 4-gram rescore at
`run_tdnn_7q_fbk_40_manual.sh:226-228`): for each hypothesis,

    new_score = (total - lm_scale_old * logP_G(words))
                + lm_scale_new * logP_big(words)

i.e. remove the decoding graph's word-LM contribution and add the
higher-order LM's, the G-replacement semantics of lattice rescoring.
``rescore_nbest_rnnlm_batched`` does the same with an RNNLM, every
hypothesis scored in a few padded batches on the scorer's device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from tdnnf_nas_torch.decode.wfst import WordLM
from tdnnf_nas_torch.lm.ngram import BOS, EOS, NGramLM
from tdnnf_nas_torch.lm.rnnlm import _pad_batch

_LN10 = math.log(10.0)


def graph_lm_logprob(words: Sequence[int], wlm: WordLM) -> float:
    """Natural-log score the decoding graph's bigram assigned to `words`
    (init + transitions + final), matching build_decoding_graph weights."""
    lp = 0.0
    prev = -1
    for w in words:
        lp += math.log(max(float(wlm.probs[prev + 1, w]), 1e-30))
        prev = w
    lp += math.log(max(float(wlm.final[prev + 1]), 1e-30))
    return lp


def rescore_nbest(
    nbest: List[Tuple[List[int], float]],
    old_lm: WordLM,
    new_lm: NGramLM,
    lm_scale: float = 1.0,
    word_to_token=str,
) -> List[Tuple[List[int], float]]:
    """Re-rank (words, score) hypotheses with `new_lm`; best first.

    new_lm scores are log10 (ARPA convention) over string tokens;
    word_to_token maps int word ids to those tokens.
    """
    out = []
    for words, total in nbest:
        am = total - graph_lm_logprob(words, old_lm)
        lm_new = new_lm.score([word_to_token(w) for w in words]) * _LN10
        out.append((words, am + lm_scale * lm_new))
    out.sort(key=lambda h: -h[1])
    return out


def _old_lm_token_logprobs(words, old_lm, word_to_token=str):
    """Per-token (incl. EOS) natural-log first-pass LM scores of `words`."""
    if isinstance(old_lm, NGramLM):
        out = []
        ctx = (BOS,)
        for w in words:
            tok = word_to_token(w)
            out.append(old_lm.log_prob_word(ctx, tok) * _LN10)
            ctx = ((ctx + (tok,))[-(old_lm.order - 1):]
                   if old_lm.order > 1 else ())
        out.append(old_lm.log_prob_word(ctx, EOS) * _LN10)
        return out
    out = []
    prev = -1
    for w in words:
        out.append(math.log(max(float(old_lm.probs[prev + 1, w]), 1e-30)))
        prev = w
    out.append(math.log(max(float(old_lm.final[prev + 1]), 1e-30)))
    return out


def rescore_nbest_rnnlm_batched(
    nbests,
    old_lm,
    scorer,
    lm_scale: float = 1.0,
    interp_weight: float = 1.0,
    word_to_token=str,
    batch_size: int = 128,
):
    """Batched RNNLM n-best rescoring with per-word old/new interpolation.

    ``nbests``: one [(words, total)] list per utterance (from
    ``decode.lattice.lattice_nbest``; ``total`` includes the first-pass
    LM).  Every hypothesis of every utterance goes through
    ``scorer.token_logprobs`` in batches of ``batch_size``, each padded
    to the longest hypothesis, one host fetch a batch.

    ``interp_weight`` w: per-token ln P = logaddexp(ln w + lp_rnn,
    ln(1 - w) + lp_old), Kaldi's `rnnlm/lmrescore_pruned.sh --weight`
    probability-space interpolation.

    Returns [(best_words, best_score)] per utterance (([], 0.0) for an
    empty list).
    """
    flat = [(u, list(words), float(total))
            for u, hyps in enumerate(nbests) for words, total in hyps]
    if not flat:
        return [([], 0.0)] * len(nbests)
    eos = scorer.cfg.eos
    max_len = max(len(f[1]) for f in flat)
    tok_lp = []
    for lo in range(0, len(flat), batch_size):
        chunk = flat[lo: lo + batch_size]
        inp, tgt = _pad_batch([w + [0] * (max_len - len(w))
                               for _, w, _ in chunk], scorer.cfg)
        # targets end at each hypothesis's own EOS, not the padded one
        for i, (_, w, _) in enumerate(chunk):
            tgt[i, len(w)] = eos
            tgt[i, len(w) + 1:] = -1
        lp = scorer.token_logprobs(inp, tgt).cpu().numpy()
        tok_lp += [lp[i, : len(w) + 1] for i, (_, w, _) in enumerate(chunk)]

    lw = math.log(max(interp_weight, 1e-30))
    lnw = math.log(max(1.0 - interp_weight, 1e-30))
    best = [None] * len(nbests)
    for (u, words, total), rnn in zip(flat, tok_lp):
        old = _old_lm_token_logprobs(words, old_lm, word_to_token)
        if interp_weight >= 1.0:
            mixed = float(np.sum(rnn))
        else:
            mixed = float(np.sum(np.logaddexp(lw + rnn,
                                              lnw + np.asarray(old))))
        new_total = total - float(np.sum(old)) + lm_scale * mixed
        if best[u] is None or new_total > best[u][1]:
            best[u] = (words, new_total)
    return [(b if b is not None else ([], 0.0)) for b in best]
