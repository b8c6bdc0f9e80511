"""Port of ``tdnnf_nas_tpu.decode.wfst``: the word-level decoding graph,
lexicon x word LM x chain topology x tree.

The dense-array equivalent of the reference's HCLG construction + decode
(`utils/mkgraph.sh` -> ``nnet3-latgen-faster``, SURVEY.md §3.3): H (chain
topology), C (context), L (lexicon), G (word bigram) are composed directly
into the state-emitting StateGraph form the training objective uses, so
batched Viterbi word decoding (``decode_words``) runs on the card with one
[B,S,S] max-plus step per frame (``decode.viterbi.viterbi_decode``).  The
graph builders are numpy copies.

States: per word w with pronunciation p_1..p_K, interleaved
[enter(w,1), loop(w,1), ..., enter(w,K), loop(w,K)].
Cross-word arcs carry the bigram probability; word identity is emitted on
entering enter(w,1).  Within-word left phone context feeds the tree's
forward pdfs (cross-word context approximated by BOS, the
word-position-dependent simplification; ``build_decoding_graph_crossword``
and the sparse graph give the exact biphone crossing).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.decode.viterbi import graph_log_arrays, viterbi_decode
from tdnnf_nas_torch.graphs.fsa import StateGraph
from tdnnf_nas_torch.graphs.phone_lm import estimate_phone_lm
from tdnnf_nas_torch.graphs.topology import ChainTopology


@dataclasses.dataclass
class Lexicon:
    """word id -> phone sequence(s).

    ``prons`` holds each word's PRIMARY pronunciation (what the dense
    legacy builders and cross-word-left-context heuristics use).  ``alt``
    optionally maps a word to its full list of (pronunciation, prob)
    variants — Kaldi's lexiconp.txt (`utils/prepare_lang.sh` consumes
    pronunciation probabilities); the sparse HCLG expands one shared chain
    per variant with ln(prob) folded into the entry arc.  Wrapping an
    existing Lexicon (``Lexicon(lex)``) is allowed so call sites can stay
    ``Lexicon(prons)`` whether ``prons`` is a dict or a built lexicon.
    """

    prons: Dict[int, Tuple[int, ...]]
    alt: Dict[int, Sequence[Tuple[Tuple[int, ...], float]]] = None

    def __post_init__(self):
        if isinstance(self.prons, Lexicon):
            inner = self.prons
            self.prons = inner.prons
            if self.alt is None:
                self.alt = inner.alt

    @property
    def num_words(self) -> int:
        return len(self.prons)

    def variants(self, w: int):
        """[(pron, ln_prob)] — singleton [(primary, 0.0)] without alts.

        Pronunciation probabilities are MAX-normalized per word (the most
        likely variant costs 0), matching Kaldi's lexiconp.txt convention
        (`utils/dict_dir_add_pronprobs.sh` normalizes so max prob = 1)
        rather than sum-normalizing.  Cached per word — the HCLG build
        loop calls this once per (word, arc source)."""
        import math as _math

        if self.alt and w in self.alt:
            cache = self.__dict__.setdefault("_var_cache", {})
            got = cache.get(w)
            if got is None:
                vs = self.alt[w]
                mx = max(p for _, p in vs)
                got = cache[w] = [
                    (tuple(pr), _math.log(max(p / mx, 1e-10)))
                    for pr, p in vs]
            return got
        return [(tuple(self.prons[w]), 0.0)]


@dataclasses.dataclass
class WordLM:
    """Bigram over words: probs[w+1, v] = P(v | w) (row 0 = BOS),
    final[w+1] = P(end | w)."""

    probs: np.ndarray
    final: np.ndarray
    num_words: int


def estimate_word_lm(word_seqs, num_words: int, interp: float = 0.1) -> WordLM:
    lm = estimate_phone_lm(word_seqs, num_words, interp=interp)
    return WordLM(probs=lm.probs, final=lm.final, num_words=num_words)


@dataclasses.dataclass
class DecodingGraph:
    graph: StateGraph
    word_of_state: np.ndarray  # [S] int32; word emitted on entry, else -1


def build_decoding_graph(
    lexicon: Lexicon,
    word_lm: WordLM,
    topo: ChainTopology,
    tree,
    lm_scale: float = 1.0,
) -> DecodingGraph:
    a = topo.self_loop_prob
    # state layout
    offsets = {}
    s = 0
    for w in sorted(lexicon.prons):
        offsets[w] = s
        s += 2 * len(lexicon.prons[w])
    trans = np.zeros((s, s), dtype=np.float64)
    state_pdf = np.zeros((s,), np.int32)
    init = np.zeros((s,), np.float64)
    final = np.zeros((s,), np.float64)
    word_of_state = np.full((s,), -1, np.int32)

    probs = word_lm.probs.astype(np.float64) ** lm_scale
    finals = word_lm.final.astype(np.float64) ** lm_scale

    for w in sorted(lexicon.prons):
        pron = lexicon.prons[w]
        base = offsets[w]
        word_of_state[base] = w
        prev_ph = -1
        for i, p in enumerate(pron):
            e, l = base + 2 * i, base + 2 * i + 1
            state_pdf[e] = tree.forward_pdf(p, prev_ph)
            state_pdf[l] = tree.self_loop_pdf(p)
            for src in (e, l):
                trans[src, l] += a
                if i + 1 < len(pron):
                    trans[src, base + 2 * (i + 1)] += 1.0 - a
                else:
                    # word end: bigram arcs to every successor + final
                    for v in sorted(lexicon.prons):
                        trans[src, offsets[v]] += (1.0 - a) * probs[w + 1, v]
                    final[src] = (1.0 - a) * finals[w + 1] + a * 0.0
            prev_ph = p
        init[base] = probs[0, w]

    g = StateGraph(
        trans=trans.astype(np.float32),
        state_pdf=state_pdf,
        init=(init / max(init.sum(), 1e-30)).astype(np.float32),
        final=final.astype(np.float32),
        num_pdfs=tree.num_pdfs,
    )
    return DecodingGraph(graph=g, word_of_state=word_of_state)


def path_to_words(path: np.ndarray, word_of_state: np.ndarray) -> List[int]:
    words = []
    for s in np.asarray(path):
        w = int(word_of_state[int(s)])
        if w >= 0:
            words.append(w)
    return words


def decode_words(
    obs_logprob,
    dg: DecodingGraph,
    acoustic_scale: float = 1.0,
    device=DEFAULT_DEVICE,
):
    """Batched Viterbi word decode on ``device``.  obs_logprob: [B, T, P]
    (numpy or tensor) -> (list of word sequences, scores [B] numpy)."""
    dev = resolve_device(device)
    lt, spdf, li, lf = graph_log_arrays(dg.graph, dev)
    obs = torch.as_tensor(obs_logprob, dtype=torch.float32, device=dev)
    scores, paths = viterbi_decode(obs * acoustic_scale, lt, spdf, li, lf)
    paths = paths.cpu().numpy()
    hyps = [path_to_words(p, dg.word_of_state) for p in paths]
    return hyps, scores.cpu().numpy()


def build_decoding_graph_crossword(
    lexicon: Lexicon,
    word_lm: WordLM,
    topo: ChainTopology,
    tree,
    lm_scale: float = 1.0,
) -> DecodingGraph:
    """Cross-word biphone decoding graph.

    Like build_decoding_graph, but each word's FIRST phone gets one enter
    variant per possible left context (BOS + every predecessor word's final
    phone), so word-initial forward pdfs see the TRUE cross-word left phone
    — the exact-C composition the reference gets from `utils/mkgraph.sh`'s
    context FST, rather than the word-position-dependent approximation.

    State layout per word w (pron p_1..p_K), contexts c_0=-1 < c_1 < ...:
      [enter(w,1|c_0), ..., enter(w,1|c_V), loop(w,1),
       enter(w,2), loop(w,2), ..., enter(w,K), loop(w,K)]
    """
    a = topo.self_loop_prob
    words = sorted(lexicon.prons)
    final_phone = {w: lexicon.prons[w][-1] for w in words}
    contexts = [-1] + sorted({final_phone[w] for w in words})
    ctx_idx = {c: i for i, c in enumerate(contexts)}
    v = len(contexts)

    offsets = {}
    s = 0
    for w in words:
        offsets[w] = s
        s += v + 1 + 2 * (len(lexicon.prons[w]) - 1)
    trans = np.zeros((s, s), dtype=np.float64)
    state_pdf = np.zeros((s,), np.int32)
    init = np.zeros((s,), np.float64)
    final = np.zeros((s,), np.float64)
    word_of_state = np.full((s,), -1, np.int32)

    probs = word_lm.probs.astype(np.float64) ** lm_scale
    finals = word_lm.final.astype(np.float64) ** lm_scale

    def enter_state(w, phone_idx, ctx=-1):
        base = offsets[w]
        if phone_idx == 0:
            return base + ctx_idx[ctx]
        return base + v + 1 + 2 * (phone_idx - 1)

    def loop_state(w, phone_idx):
        base = offsets[w]
        if phone_idx == 0:
            return base + v
        return base + v + 2 + 2 * (phone_idx - 1)

    for w in words:
        pron = lexicon.prons[w]
        base = offsets[w]
        # first-phone enter variants + its loop
        for c in contexts:
            e = enter_state(w, 0, c)
            state_pdf[e] = tree.forward_pdf(pron[0], c)
            word_of_state[e] = w
        state_pdf[loop_state(w, 0)] = tree.self_loop_pdf(pron[0])
        # later phones: within-word left context
        for i in range(1, len(pron)):
            state_pdf[enter_state(w, i)] = tree.forward_pdf(pron[i], pron[i - 1])
            state_pdf[loop_state(w, i)] = tree.self_loop_pdf(pron[i])

        k = len(pron)
        for i in range(k):
            srcs = ([enter_state(w, 0, c) for c in contexts] if i == 0
                    else [enter_state(w, i)])
            srcs.append(loop_state(w, i))
            for src in srcs:
                trans[src, loop_state(w, i)] += a
                if i + 1 < k:
                    trans[src, enter_state(w, i + 1)] += 1.0 - a
                else:
                    for vv in words:
                        trans[src, enter_state(vv, 0, final_phone[w])] += (
                            (1.0 - a) * probs[w + 1, vv])
                    final[src] = (1.0 - a) * finals[w + 1]
        init[enter_state(w, 0, -1)] = probs[0, w]

    g = StateGraph(
        trans=trans.astype(np.float32),
        state_pdf=state_pdf,
        init=(init / max(init.sum(), 1e-30)).astype(np.float32),
        final=final.astype(np.float32),
        num_pdfs=tree.num_pdfs,
    )
    return DecodingGraph(graph=g, word_of_state=word_of_state)
