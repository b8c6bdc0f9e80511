"""Numpy copy of ``tdnnf_nas_tpu.data.synthetic`` (HMM-generated corpora).

Utterances are sampled from a random phone Markov chain with per-pdf
Gaussian emissions, at the input frame rate (frame_subsampling_factor
frames per output frame).  The phone corpus (``make_synthetic_corpus``)
feeds training; the word corpus (``make_word_corpus``: a random lexicon,
a word bigram or Zipf/topic source, optional silence, pronunciation
variants, speakers, LM text and planted lookahead) feeds the decode path.
The same seed gives the reference's corpus array for array.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.graphs.topology import ChainTopology, ContextIndependentTree

@dataclasses.dataclass(frozen=True)
class SyntheticCorpusConfig(Config):
    num_phones: int = 8
    feat_dim: int = 20
    num_utts: int = 64
    min_phones: int = 4
    max_phones: int = 12
    mean_dur: float = 4.0  # output frames per phone (geometric-ish)
    frame_subsampling_factor: int = 3
    emission_noise: float = 0.5
    # left-context coloring: emission mean += context_shift * shift[l1]
    # (makes context-dependent trees acoustically learnable — the analogue
    # of real speech coarticulation that triphone trees exist to model)
    context_shift: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Utterance:
    feats: np.ndarray  # [T_in, F]
    phones: List[int]
    begins: List[int]  # output-frame phone starts
    ends: List[int]  # output-frame phone ends (inclusive)
    pdf_align: np.ndarray  # [T_out] int32
    words: List[int] = dataclasses.field(default_factory=list)
    speaker: int = 0


def make_synthetic_corpus(cfg: SyntheticCorpusConfig):
    """Returns (utterances, phone_seqs, tree, topo)."""
    rng = np.random.RandomState(cfg.seed)
    tree = ContextIndependentTree(cfg.num_phones)
    topo = ChainTopology(cfg.num_phones)
    # random (peaky) phone bigram for generation
    gen_lm = rng.dirichlet(np.ones(cfg.num_phones) * 0.5, size=cfg.num_phones)
    # well-separated pdf emission means
    means = rng.randn(tree.num_pdfs, cfg.feat_dim) * 2.0
    ctx_shift = rng.randn(cfg.num_phones + 1, cfg.feat_dim)  # [l1+1, D]
    fs = cfg.frame_subsampling_factor

    utts: List[Utterance] = []
    for _ in range(cfg.num_utts):
        n = rng.randint(cfg.min_phones, cfg.max_phones + 1)
        phones = [rng.randint(cfg.num_phones)]
        for _ in range(n - 1):
            phones.append(rng.choice(cfg.num_phones, p=gen_lm[phones[-1]]))
        begins, ends, pdfs, lctx = [], [], [], []
        t = 0
        prev = -1
        for p in phones:
            dur = 1 + rng.geometric(1.0 / cfg.mean_dur)
            begins.append(t)
            ends.append(t + dur - 1)
            pdfs.append(tree.forward_pdf(p))
            pdfs.extend([tree.self_loop_pdf(p)] * (dur - 1))
            lctx.extend([prev] * dur)
            t += dur
            prev = p
        pdf_align = np.asarray(pdfs, np.int32)
        t_out = len(pdf_align)
        feats = (
            means[np.repeat(pdf_align, fs)]
            + rng.randn(t_out * fs, cfg.feat_dim) * cfg.emission_noise
        )
        if cfg.context_shift > 0.0:
            feats = feats + cfg.context_shift * ctx_shift[
                np.repeat(np.asarray(lctx) + 1, fs)]
        utts.append(Utterance(feats.astype(np.float32), phones, begins, ends,
                              pdf_align))
    phone_seqs = [u.phones for u in utts]
    return utts, phone_seqs, tree, topo


@dataclasses.dataclass(frozen=True)
class WordCorpusConfig(Config):
    """Word-level corpus: random lexicon + word bigram -> phone/feature
    stream, for exercising the full decode + WER path."""

    vocab_size: int = 12
    num_phones: int = 8
    min_pron: int = 2
    max_pron: int = 4
    feat_dim: int = 16
    num_utts: int = 48
    min_words: int = 2
    max_words: int = 6
    mean_dur: float = 3.0
    frame_subsampling_factor: int = 3
    emission_noise: float = 0.5
    # left-context coloring (coarticulation analogue, see
    # SyntheticCorpusConfig.context_shift)
    context_shift: float = 0.0
    # RIGHT-neighbor coloring (anticipatory coarticulation): emission mean
    # += right_context_shift * rshift[next_phone]; makes +-1 trees
    # acoustically advantaged over left-only windows (the property real
    # speech has that motivates Kaldi's l/p/r tri5_7d window)
    right_context_shift: float = 0.0
    # per-speaker affine corruption of the features (what fMLLR/SAT adapt
    # away); 0 speakers = off
    num_speakers: int = 0
    speaker_shift: float = 0.0
    # extra word-only sentences from the same bigram source (no audio) for
    # LM training — the analogue of the reference's Fisher text, which
    # gives the word LM far more data than the acoustic corpus
    # (`run.sh:24-79` SRILM training; rnnlm recipes use SWBD+Fisher text)
    num_text_sents: int = 0
    # >1 gives each sentence a latent TOPIC that permutes the unigram
    # fallback distribution (big-vocab source only): topical coherence is
    # long-range structure a recurrent LM can exploit but an n-gram
    # cannot — the property of real conversational text that lets the
    # reference's RNNLM rescoring beat its 4-gram (15.9 -> 14.4,
    # `local/rnnlm/run_tdnn_lstm_...e40.sh:15-21`)
    num_topics: int = 0
    # with num_topics > 1, ALSO give each topic its own successor table
    # (big-vocab source only).  The round-4/5 topic mixture only permuted
    # the 30% unigram-fallback draws, so 70% of tokens kept topic-free
    # bigram structure that backoff counts capture outright (measured:
    # 4-gram held-out ppl 375 vs RNNLM 756 — a tie at rescoring).  With
    # topic-dependent successors the next-word distribution given any
    # finite n-gram context is a K-way mixture, while a recurrent model
    # that has inferred the sentence topic from the earlier tokens
    # narrows it to one table — the long-range-dependency property of
    # real conversational text that the reference's RNNLM win rides
    # (eval2000 15.9 -> 14.4, `local/rnnlm/run_tdnn_lstm_..._e40.sh:15-21`)
    topic_successors: bool = False
    # fraction of words that get a SECOND pronunciation (lexiconp.txt
    # semantics; primary used with prob 0.7, the variant 0.3); the corpus
    # then returns a decode.wfst.Lexicon (with .alt) in the prons slot
    pron_variant_prob: float = 0.0
    # optional silence (prepare_lang semantics): phone num_phones-1 is
    # reserved as silence, inserted with this probability at utterance
    # start and after every word (never in word_seqs/refs — it is not a
    # word); 0 = off.  Decode handles it via the optional-silence chains
    # of decode/graph_sparse.build_hclg_sparse(sil_phone=..., sil_prob=...)
    silence_prob: float = 0.0
    # --- planted temporal heterogeneity (per-phone-class lookahead) ---
    # When nonempty, word phones are grouped in pairs (2i, 2i+1) that share
    # IDENTICAL instantaneous emissions; the disambiguating phone identity
    # is written into the last `lookahead_dim` feature dims DELAYED by the
    # pair's lag = lookahead_lags[pair % len(lookahead_lags)] output
    # frames.  Resolving a pair therefore requires model lookahead >= its
    # lag (lda splice +1, plus the sum of affine strides, plus the +-2
    # numerator tolerance) — so per-layer context-offset choice genuinely
    # matters, with a graded ladder of lags giving a dense improvement
    # signal at every stride margin.  This is the corpus analogue of the
    # anticipatory coarticulation that makes the reference's offset search
    # pay on real speech (searched PipeGumbel Avg 14.8 < manual 15.5,
    # `img/search_result.png`), generalizing the single-lag positive
    # control of scripts/search_sanity_planted.py.
    lookahead_lags: Tuple[int, ...] = ()
    lookahead_dim: int = 8
    lookahead_scale: float = 2.0
    # word-boundary allophony: emission mean += boundary_shift *
    # bshift[position] with position in {begin, internal, end, single} —
    # the acoustic effect Kaldi's _B/_E/_I/_S word-position-dependent
    # phones (prepare_lang) exist to model; see graphs/wpd.py and
    # scripts/wpd_compare.py
    boundary_shift: float = 0.0
    seed: int = 0

    @property
    def silence_phone(self) -> int:
        return self.num_phones - 1 if self.silence_prob > 0 else -1


def make_word_corpus(cfg: WordCorpusConfig, extra_text_sents: int = 0):
    """Returns (utterances-with-words, lexicon_prons, word_seqs, phone_seqs,
    tree, topo)."""
    rng = np.random.RandomState(cfg.seed)
    tree = ContextIndependentTree(cfg.num_phones)
    topo = ChainTopology(cfg.num_phones)
    # unique random pronunciations
    prons = {}
    seen = set()
    # with optional silence, the last phone id is reserved for it and
    # pronunciations draw from the rest
    n_word_phones = (cfg.num_phones - 1 if cfg.silence_prob > 0
                     else cfg.num_phones)
    sil = cfg.silence_phone
    w = 0
    while w < cfg.vocab_size:
        n = rng.randint(cfg.min_pron, cfg.max_pron + 1)
        pron = tuple(rng.randint(0, n_word_phones, size=n).tolist())
        if pron in seen:
            continue
        seen.add(pron)
        prons[w] = pron
        w += 1
    alt_prons = None
    if cfg.pron_variant_prob > 0:
        alt_prons = {}
        for wd in range(cfg.vocab_size):
            if rng.rand() >= cfg.pron_variant_prob:
                continue
            for _try in range(20):
                pron = list(prons[wd])
                pron[rng.randint(len(pron))] = rng.randint(0, n_word_phones)
                pron = tuple(pron)
                if pron not in seen:
                    seen.add(pron)
                    alt_prons[wd] = [(prons[wd], 0.7), (pron, 0.3)]
                    break
    # word source: dense Dirichlet bigram for small vocabularies (kept
    # verbatim so seeded tests reproduce); Zipf unigram + sparse random
    # successor sets at real-vocabulary scale (a [V,V] Dirichlet at 30k
    # words is 7 GB and O(V) per token)
    big_vocab = cfg.vocab_size > 2000
    if big_vocab:
        zipf = 1.0 / np.arange(1, cfg.vocab_size + 1)
        zipf_cdf = np.cumsum(zipf / zipf.sum())
        succ = rng.randint(0, cfg.vocab_size, size=(cfg.vocab_size, 20))
        topic_perm = (np.stack([rng.permutation(cfg.vocab_size)
                                for _ in range(cfg.num_topics)])
                      if cfg.num_topics > 1 else None)
        # flag-gated extra rng draws, AFTER the shared ones: the
        # flag-off corpus stays bit-identical for every seed
        topic_succ = (rng.randint(0, cfg.vocab_size,
                                  size=(cfg.num_topics, cfg.vocab_size, 20))
                      if cfg.topic_successors and cfg.num_topics > 1
                      else None)

        def sample_words(n_words):
            k = rng.randint(cfg.num_topics) if topic_perm is not None else 0
            perm = topic_perm[k] if topic_perm is not None else None
            suc = topic_succ[k] if topic_succ is not None else succ

            def uni():
                r = int(np.searchsorted(zipf_cdf, rng.rand()))
                return int(perm[r]) if perm is not None else r

            ws = [uni()]
            for _ in range(n_words - 1):
                if rng.rand() < 0.7:
                    ws.append(int(suc[ws[-1], rng.randint(20)]))
                else:
                    ws.append(uni())
            return ws
    else:
        word_bigram = rng.dirichlet(np.ones(cfg.vocab_size) * 0.5,
                                    size=cfg.vocab_size)

        def sample_words(n_words):
            ws = [rng.randint(cfg.vocab_size)]
            for _ in range(n_words - 1):
                ws.append(rng.choice(cfg.vocab_size, p=word_bigram[ws[-1]]))
            return ws

    means = rng.randn(tree.num_pdfs, cfg.feat_dim) * 2.0
    ctx_shift = rng.randn(cfg.num_phones + 1, cfg.feat_dim)
    rctx_shift = rng.randn(cfg.num_phones + 1, cfg.feat_dim)
    bnd_shift = rng.randn(4, cfg.feat_dim)
    lag_of = ident = None
    la_dim = 0
    if cfg.lookahead_lags:
        la_dim = cfg.lookahead_dim
        base_dim = cfg.feat_dim - la_dim
        assert base_dim > 0
        # pair-collapse: mates share all instantaneous emission stats;
        # identity lives only in the delayed lookahead block
        for p in range(0, n_word_phones - 1, 2):
            means[tree.forward_pdf(p + 1)] = means[tree.forward_pdf(p)]
            means[tree.self_loop_pdf(p + 1)] = means[tree.self_loop_pdf(p)]
        means[:, base_dim:] = 0.0
        ident = rng.randn(cfg.num_phones, la_dim).astype(np.float32) \
            * cfg.lookahead_scale
        lag_of = np.asarray(
            [cfg.lookahead_lags[(p // 2) % len(cfg.lookahead_lags)]
             for p in range(cfg.num_phones)], np.int64)
    spk_a = spk_b = None
    if cfg.num_speakers > 0:
        # per-speaker mild affine corruption: scale near 1, random shift
        spk_a = 1.0 + cfg.speaker_shift * 0.2 * rng.randn(
            cfg.num_speakers, cfg.feat_dim)
        spk_b = cfg.speaker_shift * rng.randn(cfg.num_speakers, cfg.feat_dim)
    fs = cfg.frame_subsampling_factor

    utts = []
    speakers = []
    for ui in range(cfg.num_utts):
        n_words = rng.randint(cfg.min_words, cfg.max_words + 1)
        words = sample_words(n_words)
        def pron_of(wd):
            if alt_prons and wd in alt_prons and rng.rand() < 0.3:
                return alt_prons[wd][1][0]
            return prons[wd]

        wpos = []  # per-phone word-position class (wpd.POS_*)
        if cfg.silence_prob > 0:
            phones = [sil] if rng.rand() < cfg.silence_prob else []
            wpos = [1] * len(phones)
            for wd in words:
                pr = pron_of(wd)
                phones.extend(pr)
                wpos.extend([3] if len(pr) == 1 else
                            [0] + [1] * (len(pr) - 2) + [2])
                if rng.rand() < cfg.silence_prob:
                    phones.append(sil)
                    wpos.append(1)
        else:
            phones = []
            for wd in words:
                pr = pron_of(wd)
                phones.extend(pr)
                wpos.extend([3] if len(pr) == 1 else
                            [0] + [1] * (len(pr) - 2) + [2])
        begins, ends, pdfs, lctx, rctx, fphone = [], [], [], [], [], []
        fpos = []
        t = 0
        prev = -1
        for j, p in enumerate(phones):
            # silence runs longer than speech phones (pauses)
            md = 2.0 * cfg.mean_dur if p == sil else cfg.mean_dur
            dur = 1 + rng.geometric(1.0 / md)
            begins.append(t)
            ends.append(t + dur - 1)
            pdfs.append(tree.forward_pdf(p))
            pdfs.extend([tree.self_loop_pdf(p)] * (dur - 1))
            lctx.extend([prev] * dur)
            fphone.extend([p] * dur)
            fpos.extend([wpos[j] if j < len(wpos) else 1] * dur)
            nxt = phones[j + 1] if j + 1 < len(phones) else -1
            rctx.extend([nxt] * dur)
            t += dur
            prev = p
        pdf_align = np.asarray(pdfs, np.int32)
        feats = (
            means[np.repeat(pdf_align, fs)]
            + rng.randn(len(pdf_align) * fs, cfg.feat_dim) * cfg.emission_noise
        )
        if lag_of is not None:
            # delayed identity: phone at output frame t is revealed in the
            # lookahead block at frame t + lag(pair-class of the phone)
            t_out = len(pdf_align)
            fp = np.asarray(fphone)
            la = np.zeros((t_out, la_dim), np.float32)
            tgt = np.arange(t_out) + lag_of[fp]
            ok = tgt < t_out
            if sil >= 0:
                ok &= fp != sil
            np.add.at(la, tgt[ok], ident[fp[ok]])
            feats[:, cfg.feat_dim - la_dim:] += np.repeat(la, fs, axis=0)
        if cfg.context_shift > 0.0:
            feats = feats + cfg.context_shift * ctx_shift[
                np.repeat(np.asarray(lctx) + 1, fs)]
        if cfg.right_context_shift > 0.0:
            feats = feats + cfg.right_context_shift * rctx_shift[
                np.repeat(np.asarray(rctx) + 1, fs)]
        if cfg.boundary_shift > 0.0:
            feats = feats + cfg.boundary_shift * bnd_shift[
                np.repeat(np.asarray(fpos), fs)]
        spk = ui % max(cfg.num_speakers, 1)
        if spk_a is not None:
            feats = feats * spk_a[spk] + spk_b[spk]
        speakers.append(spk)
        utts.append(Utterance(feats.astype(np.float32), phones, begins, ends,
                              pdf_align, words=words, speaker=spk))
    word_seqs = [u.words for u in utts]
    phone_seqs = [u.phones for u in utts]
    prons_out = prons
    if alt_prons:
        from tdnnf_nas_torch.decode.wfst import Lexicon

        prons_out = Lexicon(prons, alt=alt_prons)
    if cfg.num_text_sents > 0:
        text = [sample_words(rng.randint(cfg.min_words, cfg.max_words + 1))
                for _ in range(cfg.num_text_sents)]
        if extra_text_sents > 0:
            # Fisher-analogue extra LM text: same topic/successor source,
            # sampled AFTER everything else so the corpus (and any cache
            # keyed on it) is bit-identical with or without the extras
            extra = [sample_words(rng.randint(cfg.min_words,
                                              cfg.max_words + 1))
                     for _ in range(extra_text_sents)]
            return (utts, prons_out, word_seqs, phone_seqs, tree, topo,
                    text, extra)
        return utts, prons_out, word_seqs, phone_seqs, tree, topo, text
    return utts, prons_out, word_seqs, phone_seqs, tree, topo
