"""Copy of ``tdnnf_nas_tpu.decode.rescore``: n-best LM rescoring, swapping
the first-pass graph LM's scores for a bigger LM's.

Equivalent of the reference's lattice rescoring stages
(`steps/lmrescore_const_arpa.sh` 4-gram rescore at
`run_tdnn_7q_fbk_40_manual.sh:226-228`): for each hypothesis,

    new_score = (total - lm_scale_old * logP_G(words))
                + lm_scale_new * logP_big(words)

i.e. remove the decoding graph's word-LM contribution and add the
higher-order LM's, the G-replacement semantics of lattice rescoring.
The batched RNNLM rescorer (``rescore_nbest_rnnlm_batched``) waits for
``lm/rnnlm``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from tdnnf_nas_torch.decode.wfst import WordLM
from tdnnf_nas_torch.lm.ngram import BOS, EOS, NGramLM

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
