"""The decode slice's host copies and its Viterbi against the JAX package
(CPU): the word corpus, the lexicon, the word and n-gram LMs (with the
ARPA round trip), the dense and sparse decoding graphs, the den's dense
export, scoring, and the Viterbi recursion."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.decode import graph_sparse as jgs
from tdnnf_nas_tpu.decode import scoring as jsc
from tdnnf_nas_tpu.decode import viterbi as jvit
from tdnnf_nas_tpu.decode import wfst as jwfst
from tdnnf_nas_tpu.graphs import den_graph as jden
from tdnnf_nas_tpu.graphs import phone_lm as jplm
from tdnnf_nas_tpu.graphs import topology as jtopo
from tdnnf_nas_tpu.graphs import tree_cluster as jtc
from tdnnf_nas_tpu.lm import ngram as jng
from tdnnf_nas_tpu.recipes import chain_recipes as jrec
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.decode import graph_sparse as tgs
from tdnnf_nas_torch.decode import scoring as tsc
from tdnnf_nas_torch.decode import viterbi as tvit
from tdnnf_nas_torch.decode import wfst as twfst
from tdnnf_nas_torch.graphs import den_graph as tden
from tdnnf_nas_torch.graphs import phone_lm as tplm
from tdnnf_nas_torch.graphs import topology as ttopo
from tdnnf_nas_torch.graphs import tree_cluster as ttc
from tdnnf_nas_torch.lm import ngram as tng
from tdnnf_nas_torch.recipes import chain_recipes as trec

torch.set_num_threads(1)

_CORPORA = {
    "bigram": dict(vocab_size=14, num_phones=8, feat_dim=16, num_utts=20,
                   min_words=2, max_words=5, seed=5),
    "variants_silence": dict(vocab_size=20, num_phones=10, feat_dim=16,
                             num_utts=16, pron_variant_prob=0.4,
                             silence_prob=0.3, seed=2),
    "shifts_speakers_text_lookahead": dict(
        vocab_size=12, num_phones=8, feat_dim=20, num_utts=12,
        num_speakers=3, speaker_shift=1.0, num_text_sents=30,
        context_shift=1.0, right_context_shift=0.5, boundary_shift=0.5,
        lookahead_lags=(1, 2), lookahead_dim=4, seed=1),
    "zipf_topics": dict(vocab_size=2100, num_phones=12, feat_dim=16,
                        num_utts=6, num_topics=3, topic_successors=True,
                        num_text_sents=20, min_pron=3, max_pron=5, seed=4),
}


def _prons(lex):
    return (lex.prons, lex.alt) if hasattr(lex, "prons") else (lex, None)


@pytest.mark.parametrize("name", sorted(_CORPORA))
def test_word_corpus_matches_jax(name):
    """The same seed gives the same corpus, array for array, and the same
    6/7/8-tuple (extra LM text when the caller asks for it)."""
    kw = _CORPORA[name]
    extra = 7 if kw.get("num_text_sents") else 0
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw), extra)
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw), extra)
    assert len(t) == len(j) == (8 if extra else 6)
    assert tsyn.WordCorpusConfig(**kw).silence_phone == \
        jsyn.WordCorpusConfig(**kw).silence_phone
    for ju, tu in zip(j[0], t[0]):
        np.testing.assert_array_equal(tu.feats, ju.feats)
        np.testing.assert_array_equal(tu.pdf_align, ju.pdf_align)
        assert (tu.phones, tu.begins, tu.ends, tu.words, tu.speaker) == (
            ju.phones, ju.begins, ju.ends, ju.words, ju.speaker)
    assert _prons(t[1]) == _prons(j[1])
    assert t[2] == j[2] and t[3] == j[3]
    assert t[4].num_pdfs == j[4].num_pdfs
    assert (t[5].num_phones, t[5].self_loop_prob) == (
        j[5].num_phones, j[5].self_loop_prob)
    assert t[6:] == j[6:]


def test_lexicon_variants_match_jax():
    kw = _CORPORA["variants_silence"]
    jl = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw))[1]
    tl = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw))[1]
    assert isinstance(tl, twfst.Lexicon) and tl.alt
    wrapped = twfst.Lexicon(tl)
    assert wrapped.prons is tl.prons and wrapped.alt is tl.alt
    assert tl.num_words == jl.num_words
    for w in range(kw["vocab_size"]):
        assert tl.variants(w) == jl.variants(w)


@pytest.fixture(scope="module")
def small():
    kw = _CORPORA["bigram"]
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw))
    return kw, j, t


def test_word_lm_matches_jax(small):
    kw, j, t = small
    jl = jwfst.estimate_word_lm(j[2], kw["vocab_size"])
    tl = twfst.estimate_word_lm(t[2], kw["vocab_size"])
    np.testing.assert_array_equal(tl.probs, jl.probs)
    np.testing.assert_array_equal(tl.final, jl.final)
    assert tl.num_words == jl.num_words


@pytest.mark.parametrize("order", [1, 3, 4])
def test_ngram_lm_and_arpa_round_trip_match_jax(small, order):
    kw, j, _ = small
    sents = [[f"w{w}" for w in ws] for ws in j[2]]
    jl = jng.estimate_ngram_lm(sents, order=order)
    tl = tng.estimate_ngram_lm(sents, order=order)
    assert tl.order == jl.order
    assert tl.logprobs == jl.logprobs and tl.backoffs == jl.backoffs
    arpa = tl.to_arpa()
    assert arpa == jl.to_arpa()
    back = tng.NGramLM.from_arpa(arpa)
    jback = jng.NGramLM.from_arpa(arpa)
    assert back.order == jback.order == order
    assert back.logprobs == jback.logprobs
    assert back.backoffs == jback.backoffs
    # the whitespace-separated ARPA form parses too
    spaced = tng.NGramLM.from_arpa(arpa.replace("\t", " "))
    assert spaced.logprobs == jng.NGramLM.from_arpa(
        arpa.replace("\t", " ")).logprobs
    for s in sents[:6] + [["w0", "unseen"]]:
        assert tl.score(s) == jl.score(s)
        assert back.score(s) == pytest.approx(tl.score(s), abs=1e-4)
    assert (tng.BOS, tng.EOS) == (jng.BOS, jng.EOS)


def _biphone(pkg_topo, num_phones):
    return pkg_topo.BiphoneTree(num_phones, num_leaves=num_phones + 5)


@pytest.mark.parametrize("builder", ["build_decoding_graph",
                                     "build_decoding_graph_crossword"])
@pytest.mark.parametrize("tree_kind", ["ci", "biphone"])
def test_dense_decoding_graphs_match_jax(small, builder, tree_kind):
    kw, j, t = small
    p = kw["num_phones"]
    jtree = j[4] if tree_kind == "ci" else _biphone(jtopo, p)
    ttree = t[4] if tree_kind == "ci" else _biphone(ttopo, p)
    jg = getattr(jwfst, builder)(
        jwfst.Lexicon(j[1]), jwfst.estimate_word_lm(j[2], kw["vocab_size"]),
        j[5], jtree, lm_scale=0.8)
    tg = getattr(twfst, builder)(
        twfst.Lexicon(t[1]), twfst.estimate_word_lm(t[2], kw["vocab_size"]),
        t[5], ttree, lm_scale=0.8)
    for f in ("trans", "state_pdf", "init", "final"):
        np.testing.assert_array_equal(getattr(tg.graph, f),
                                      getattr(jg.graph, f), err_msg=f)
    assert tg.graph.num_pdfs == jg.graph.num_pdfs
    np.testing.assert_array_equal(tg.word_of_state, jg.word_of_state)


def _left2_trees(kw, j, t):
    """The clustered left-2 tree of each package on the same corpus."""
    p, fs = kw["num_phones"], 3
    trees = []
    for mod, corpus in ((jtc, j), (ttc, t)):
        utts = corpus[0]
        stats = mod.accumulate_triphone_stats(
            [u.feats for u in utts], [u.phones for u in utts],
            [u.begins for u in utts], p, fs)
        trees.append(mod.build_clustered_triphone_tree(stats,
                                                       num_leaves=3 * p))
    return trees


_SPARSE_GRAPHS = {
    "ci": ("bigram", "ci", False),
    "left2": ("bigram", "left2", False),
    "left2_silence_variants": ("variants_silence", "left2", True),
    "ci_silence_variants": ("variants_silence", "ci", True),
}


@pytest.mark.parametrize("split_unigram", [True, False])
@pytest.mark.parametrize("name", sorted(_SPARSE_GRAPHS))
def test_hclg_sparse_matches_jax(name, split_unigram):
    corpus, tree_kind, sil = _SPARSE_GRAPHS[name]
    kw = _CORPORA[corpus]
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw))
    jtree, ttree = ((j[4], t[4]) if tree_kind == "ci"
                    else _left2_trees(kw, j, t))
    assert ttree.num_pdfs == jtree.num_pdfs
    sym = [f"w{w}" for w in range(kw["vocab_size"])]
    sents = [[sym[w] for w in ws] for ws in j[2]]
    extra = dict(split_unigram=split_unigram, lm_scale=0.9)
    if sil:
        extra.update(sil_phone=jsyn.WordCorpusConfig(**kw).silence_phone,
                     sil_prob=0.2)
    jg = jgs.build_hclg_sparse(jwfst.Lexicon(j[1]),
                               jng.estimate_ngram_lm(sents, order=3), sym,
                               j[5], jtree, **extra)
    tg = tgs.build_hclg_sparse(twfst.Lexicon(t[1]),
                               tng.estimate_ngram_lm(sents, order=3), sym,
                               t[5], ttree, **extra)
    assert (tg.num_states, tg.num_pdfs, tg.start_state) == (
        jg.num_states, jg.num_pdfs, jg.start_state)
    assert tg.num_arcs == jg.num_arcs > 0
    for f in ("out_start", "arc_dst", "arc_w", "arc_word", "state_pdf",
              "final_w"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f),
                                      err_msg=f)


def _phone_lm_pair(num_phones=6, order=3):
    rng = np.random.RandomState(0)
    seqs = [list(rng.randint(0, num_phones, size=rng.randint(4, 12)))
            for _ in range(40)]
    return (jplm.estimate_ngram_phone_lm(seqs, num_phones, order=order,
                                         num_extra_lm_states=20),
            tplm.estimate_ngram_phone_lm(seqs, num_phones, order=order,
                                         num_extra_lm_states=20), seqs)


def test_to_state_graph_matches_jax():
    p = 6
    jlm, tlm, _ = _phone_lm_pair(p)
    jg = jden.compile_denominator_fsa(
        jlm, jtopo.ChainTopology(p), jtopo.BiphoneTree(p)).to_state_graph()
    tg = tden.compile_denominator_fsa(
        tlm, ttopo.ChainTopology(p), ttopo.BiphoneTree(p)).to_state_graph()
    for f in ("trans", "state_pdf", "init", "final"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f),
                                      err_msg=f)
    assert tg.num_pdfs == jg.num_pdfs


@pytest.mark.parametrize("max_dense", [4096, 10])
def test_prepare_data_keeps_a_small_dense_den(max_dense):
    """A composed bundle carries its dense den when S <= max_dense_states
    (default 4,096), as the reference's does; above it, None."""
    p = 6
    _, _, seqs = _phone_lm_pair(p)
    utts = tsyn.make_synthetic_corpus(tsyn.SyntheticCorpusConfig(
        num_phones=p, num_utts=20, seed=1))[0]
    jutts = jsyn.make_synthetic_corpus(jsyn.SyntheticCorpusConfig(
        num_phones=p, num_utts=20, seed=1))[0]
    tb = trec.prepare_data(utts, seqs, ttopo.BiphoneTree(p),
                           ttopo.ChainTopology(p), p, phone_lm_order=3,
                           num_extra_lm_states=20, max_dense_states=max_dense)
    jb = jrec.prepare_data(jutts, seqs, jtopo.BiphoneTree(p),
                           jtopo.ChainTopology(p), p, phone_lm_order=3,
                           num_extra_lm_states=20, max_dense_states=max_dense)
    if jb.den is None:
        assert tb.den is None and tb.den_fsa.num_states > max_dense
        return
    assert tb.den_fsa.num_states <= max_dense
    for f in ("trans", "state_pdf", "init", "final"):
        np.testing.assert_array_equal(getattr(tb.den, f), getattr(jb.den, f),
                                      err_msg=f)


def test_scoring_matches_jax():
    rng = np.random.RandomState(3)
    refs = [list(rng.randint(0, 6, size=rng.randint(0, 9))) for _ in range(30)]
    hyps = [list(rng.randint(0, 6, size=rng.randint(0, 9))) for _ in range(30)]
    for r, h in zip(refs, hyps):
        assert tsc.edit_distance(r, h) == jsc.edit_distance(r, h)
        assert tsc.wer(r, h) == jsc.wer(r, h)
    assert tsc.score_corpus(refs, hyps) == jsc.score_corpus(refs, hyps)


def _dens():
    """A CI bigram den, a biphone bigram den and a composed 3-gram den's
    dense export, each in both packages."""
    p = 6
    jlm_n, tlm_n, seqs = _phone_lm_pair(p)
    jlm = jplm.estimate_phone_lm(seqs, p)
    tlm = tplm.estimate_phone_lm(seqs, p)
    return {
        "ci": (jden.build_denominator_graph(
                   jlm, jtopo.ChainTopology(p),
                   jtopo.ContextIndependentTree(p)),
               tden.build_denominator_graph(
                   tlm, ttopo.ChainTopology(p),
                   ttopo.ContextIndependentTree(p))),
        "biphone": (jden.build_denominator_graph(
                        jlm, jtopo.ChainTopology(p), jtopo.BiphoneTree(p)),
                    tden.build_denominator_graph(
                        tlm, ttopo.ChainTopology(p), ttopo.BiphoneTree(p))),
        "composed": (jden.compile_denominator_fsa(
                         jlm_n, jtopo.ChainTopology(p),
                         jtopo.BiphoneTree(p)).to_state_graph(),
                     tden.compile_denominator_fsa(
                         tlm_n, ttopo.ChainTopology(p),
                         ttopo.BiphoneTree(p)).to_state_graph()),
    }


@pytest.mark.parametrize("den", ["ci", "biphone", "composed"])
@pytest.mark.parametrize("t_len", [1, 23])
def test_viterbi_matches_jax(den, t_len):
    """Scores within rtol 1e-6 / atol 1e-4 and equal paths, on random obs
    over a den StateGraph (the recursion's float32 adds and maxes are
    exact, and ties go to the lowest state in both)."""
    jg, tg = _dens()[den]
    rng = np.random.RandomState(7)
    obs = (rng.randn(3, t_len, jg.num_pdfs) * 2.0).astype(np.float32)
    js, jp = jvit.viterbi_decode(jnp.asarray(obs), *jvit.graph_log_arrays(jg))
    arrays = tvit.graph_log_arrays(tg, "cpu")
    for a, b in zip(arrays, jvit.graph_log_arrays(jg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, tp = tvit.viterbi_decode(torch.tensor(obs), *arrays)
    assert tp.dtype == torch.int32 and tuple(tp.shape) == (3, t_len)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for path in tp.numpy():
        assert tvit.path_to_phones(path, 6) == jvit.path_to_phones(path, 6)


def test_decode_words_matches_jax(small):
    """Batched dense word decode of planted obs: the same words and scores,
    and the true words recovered."""
    kw, j, t = small
    jdg = jwfst.build_decoding_graph(
        jwfst.Lexicon(j[1]), jwfst.estimate_word_lm(j[2], kw["vocab_size"]),
        j[5], j[4])
    tdg = twfst.build_decoding_graph(
        twfst.Lexicon(t[1]), twfst.estimate_word_lm(t[2], kw["vocab_size"]),
        t[5], t[4])
    utts = t[0][:3]
    t_len = max(len(u.pdf_align) for u in utts)
    obs = np.full((3, t_len, t[4].num_pdfs), -10.0, np.float32)
    for b, u in enumerate(utts):
        obs[b, np.arange(len(u.pdf_align)), u.pdf_align] = 0.0
        obs[b, len(u.pdf_align):] = 0.0
    jh, js = jwfst.decode_words(obs, jdg, acoustic_scale=0.7)
    th, ts = twfst.decode_words(obs, tdg, acoustic_scale=0.7, device="cpu")
    assert th == jh
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-6, atol=1e-4)
    obs1 = obs[:1, :len(utts[0].pdf_align)]
    assert twfst.decode_words(obs1, tdg, device="cpu")[0][0] == utts[0].words
