"""The port's RNNLM rescorers against the JAX package's (CPU, float32):
batched n-best rescoring and both lattice rescorers on the lattices of
tests/test_lattice.py's world (the same best words, scores within
1e-4), and the port's frontier-batched rescorer against its incremental
one, with an n-gram and a bigram first-pass LM, with and without
interpolation."""

import jax
import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.decode import lattice as jlat
from tdnnf_nas_tpu.decode import rescore as jres
from tdnnf_nas_tpu.decode import wfst as jwfst
from tdnnf_nas_tpu.lm import ngram as jng
from tdnnf_nas_tpu.lm import rnnlm as jrnn
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.decode import lattice as tlat
from tdnnf_nas_torch.decode import rescore as tres
from tdnnf_nas_torch.decode import wfst as twfst
from tdnnf_nas_torch.lm import ngram as tng
from tdnnf_nas_torch.lm import rnnlm as trnn

torch.set_num_threads(1)

_WTT = lambda w: f"w{w}"


def _planted_obs(utt, num_pdfs):
    t = len(utt.pdf_align)
    obs = np.full((t, num_pdfs), -4.0, np.float32)
    obs[np.arange(t), utt.pdf_align] = 0.0
    return obs


@pytest.fixture(scope="module")
def world():
    """Each package's lattices of the first 3 utterances of the world of
    tests/test_lattice.py, first-pass LMs and an LSTMP + splice RNNLM
    (JAX's init, converted)."""
    cfg = dict(num_utts=10)
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**cfg))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**cfg))
    vocab = jsyn.WordCorpusConfig(**cfg).vocab_size
    jwlm = jwfst.estimate_word_lm(j[2], vocab)
    twlm = twfst.estimate_word_lm(t[2], vocab)
    jdg = jwfst.build_decoding_graph(jwfst.Lexicon(j[1]), jwlm, j[5], j[4])
    tdg = twfst.build_decoding_graph(twfst.Lexicon(t[1]), twlm, t[5], t[4])
    texts = [[_WTT(w) for w in u.words] for u in t[0]]
    kw = dict(beam=1e9, lattice_beam=12.0)
    jlats = [jlat.generate_lattice(_planted_obs(u, j[4].num_pdfs), jdg, **kw)
             for u in j[0][:3]]
    tlats = [tlat.generate_lattice(_planted_obs(u, t[4].num_pdfs), tdg, **kw)
             for u in t[0][:3]]
    rcfg = dict(vocab_size=vocab, embed_dim=12, hidden_dim=24, proj_dim=16,
                tdnn_splice=True, dropout=0.0)
    jcfg, tcfg = jrnn.RnnLMConfig(**rcfg), trnn.RnnLMConfig(**rcfg)
    p = jax.tree.map(np.asarray, jrnn.init_rnnlm(jcfg, jax.random.PRNGKey(0)))
    return dict(
        jlats=jlats, tlats=tlats,
        old={"ngram": (jng.estimate_ngram_lm(texts, order=2),
                       tng.estimate_ngram_lm(texts, order=2)),
             "bigram": (jwlm, twlm)},
        js=jrnn.RnnLMScorer(jcfg, p),
        ts=trnn.RnnLMScorer(tcfg, convert.rnnlm_params_from_numpy(p, "cpu")))


def _assert_same(got, ref, atol=1e-4):
    assert [g[0] for g in got] == [r[0] for r in ref]
    np.testing.assert_allclose([g[1] for g in got], [r[1] for r in ref],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("old", ["ngram", "bigram"])
@pytest.mark.parametrize("interp", [1.0, 0.4])
def test_nbest_rnnlm_rescoring_matches_jax(world, old, interp):
    """n-best lists of 6 per lattice (one empty list too), batches of 4."""
    jold, told = world["old"][old]
    wtt = _WTT if old == "ngram" else str
    jn = [jlat.lattice_nbest(lat, n=6) for lat in world["jlats"]] + [[]]
    tn = [tlat.lattice_nbest(lat, n=6) for lat in world["tlats"]] + [[]]
    kw = dict(lm_scale=0.8, interp_weight=interp, word_to_token=wtt,
              batch_size=4)
    jb = jres.rescore_nbest_rnnlm_batched(jn, jold, world["js"], **kw)
    tb = tres.rescore_nbest_rnnlm_batched(tn, told, world["ts"], **kw)
    _assert_same(tb, jb)
    assert tb[-1] == ([], 0.0)
    assert tres.rescore_nbest_rnnlm_batched([[], []], told, world["ts"]) == [
        ([], 0.0), ([], 0.0)]


@pytest.mark.parametrize("old", ["ngram", "bigram"])
@pytest.mark.parametrize("interp", [1.0, 0.4])
def test_lattice_rnnlm_rescorers_match_jax(world, old, interp):
    """Both lattice rescorers against JAX's (3-best), and the port's
    frontier-batched one against its incremental one."""
    jold, told = world["old"][old]
    wtt = _WTT if old == "ngram" else str
    kw = dict(lm_scale=1.0, n=3, word_to_token=wtt, interp_weight=interp)
    jbatch = jlat.rescore_lattices_rnnlm(world["jlats"], jold, world["js"],
                                         **kw)
    tbatch = tlat.rescore_lattices_rnnlm(world["tlats"], told, world["ts"],
                                         **kw)
    for jl, tl, jb, tb in zip(world["jlats"], world["tlats"], jbatch,
                              tbatch):
        ji = jlat.rescore_lattice_rnnlm(jl, jold, world["js"], **kw)
        ti = tlat.rescore_lattice_rnnlm(tl, told, world["ts"], **kw)
        assert ti
        _assert_same(ti, ji)
        _assert_same(tb, jb)
        _assert_same(tb, ti)


def test_frontier_pool_grows_and_gathers():
    """The device pool keeps every appended row at its index across a
    capacity doubling."""
    rows = [torch.arange(2.0)[:, None] * torch.ones(1, 3)]
    pool = tlat._StatePool(rows)
    for k in range(1, 6):
        first = pool.append([torch.full((k, 3), float(10 * k))])
        assert first == pool.n - k
    idx = torch.tensor([0, 1, 2, 3, 5, pool.n - 1])
    got = pool.gather(idx)[0][:, 0].tolist()
    assert got == [0.0, 1.0, 10.0, 20.0, 30.0, 50.0]


def test_rescorers_on_native_lattices_match_jax():
    """On the C++ beam search's lattices, whose node ids span every kept
    token (most on no arc), as the decode path makes them: the port's
    sparse walk gives JAX's results on the same lattices."""
    from tdnnf_nas_torch.decode import beam as tbeam
    from tdnnf_nas_torch.decode import graph_sparse as tgs

    cfg = dict(vocab_size=40, num_phones=10, feat_dim=16, num_utts=24,
               min_words=2, max_words=6, seed=3)
    sym = [f"w{w}" for w in range(cfg["vocab_size"])]
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**cfg))
    sents = [[sym[w] for w in ws] for ws in t[2]]
    tlm, jlm = (tng.estimate_ngram_lm(sents, order=3),
                jng.estimate_ngram_lm(sents, order=3))
    g = tgs.build_hclg_sparse(twfst.Lexicon(t[1]), tlm, sym, t[5], t[4])
    rng = np.random.RandomState(0)
    tlats = []
    for u in t[0][:3]:
        obs = _planted_obs(u, t[4].num_pdfs)
        obs += rng.randn(*obs.shape).astype(np.float32) * 0.5
        tlats.append(tbeam.beam_decode_sparse(obs, g, beam=16.0, lattice=True,
                                              lattice_beam=8.0).lattice)
    jlats = [jlat.Lattice(**{f: getattr(lat, f) for f in (
        "num_nodes", "node_time", "arc_src", "arc_dst", "arc_word", "arc_am",
        "arc_gs")}) for lat in tlats]
    assert tlats[0].num_nodes > 2 * len(np.unique(tlats[0].arc_src))
    rcfg = dict(vocab_size=40, embed_dim=12, hidden_dim=24, dropout=0.0)
    p = jax.tree.map(np.asarray, jrnn.init_rnnlm(jrnn.RnnLMConfig(**rcfg),
                                                 jax.random.PRNGKey(1)))
    js = jrnn.RnnLMScorer(jrnn.RnnLMConfig(**rcfg), p)
    ts = trnn.RnnLMScorer(trnn.RnnLMConfig(**rcfg),
                          convert.rnnlm_params_from_numpy(p, "cpu"))
    wtt = lambda w: sym[w]
    kw = dict(n=2, word_to_token=wtt, interp_weight=0.5)
    jb = jlat.rescore_lattices_rnnlm(jlats, jlm, js, **kw)
    tb = tlat.rescore_lattices_rnnlm(tlats, tlm, ts, **kw)
    for tl, jo, to in zip(tlats, jb, tb):
        _assert_same(to, jo)
        _assert_same(tlat.rescore_lattice_rnnlm(tl, tlm, ts, **kw), to)
