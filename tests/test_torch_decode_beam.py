"""The decode slice's search side against the JAX package (CPU): the
sparse-HCLG beam search (numpy and C++), dense lattices and n-best lists
(numpy and C++), the lattice operations, n-gram lattice and n-best
rescoring, determinization, and the decoder library's build."""

import multiprocessing as mp
import stat

import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.decode import beam as jbeam
from tdnnf_nas_tpu.decode import graph_sparse as jgs
from tdnnf_nas_tpu.decode import lattice as jlat
from tdnnf_nas_tpu.decode import nbest as jnb
from tdnnf_nas_tpu.decode import rescore as jres
from tdnnf_nas_tpu.decode import wfst as jwfst
from tdnnf_nas_tpu.lm import ngram as jng
from tdnnf_nas_torch.data import native
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.decode import beam as tbeam
from tdnnf_nas_torch.decode import graph_sparse as tgs
from tdnnf_nas_torch.decode import lattice as tlat
from tdnnf_nas_torch.decode import nbest as tnb
from tdnnf_nas_torch.decode import rescore as tres
from tdnnf_nas_torch.decode import wfst as twfst
from tdnnf_nas_torch.lm import ngram as tng
from tdnnf_nas_torch.recipes import chain_recipes as trec

torch.set_num_threads(1)

_CFG = dict(vocab_size=40, num_phones=10, feat_dim=16, num_utts=24,
            min_words=2, max_words=6, seed=3)
_SYM = [f"w{w}" for w in range(_CFG["vocab_size"])]


def _noisy_obs(utt, num_pdfs, rng, noise=0.5):
    t = len(utt.pdf_align)
    obs = np.full((t, num_pdfs), -5.0, np.float32)
    obs[np.arange(t), utt.pdf_align] = 0.0
    return obs + rng.randn(t, num_pdfs).astype(np.float32) * noise


@pytest.fixture(scope="module")
def sparse():
    """Each package's 3-gram HCLG on the same corpus, and noisy planted
    obs for 6 utterances."""
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**_CFG))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**_CFG))
    sents = [[_SYM[w] for w in ws] for ws in t[2]]
    jlm, tlm = (jng.estimate_ngram_lm(sents, order=3),
                tng.estimate_ngram_lm(sents, order=3))
    jg = jgs.build_hclg_sparse(jwfst.Lexicon(j[1]), jlm, _SYM, j[5], j[4])
    tg = tgs.build_hclg_sparse(twfst.Lexicon(t[1]), tlm, _SYM, t[5], t[4])
    rng = np.random.RandomState(0)
    obs = [_noisy_obs(u, t[4].num_pdfs, rng) for u in t[0][:6]]
    return dict(utts=t[0], jg=jg, tg=tg, jlm=jlm, tlm=tlm, obs=obs)


def _assert_lattices_equal(a, b, exact=True):
    assert a.num_nodes == b.num_nodes and a.num_arcs == b.num_arcs
    for f in ("node_time", "arc_src", "arc_dst", "arc_word"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("arc_am", "arc_gs"):
        if exact:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        else:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=1e-4, err_msg=f)


_BEAMS = {"wide": dict(beam=16.0, max_active=7000, lattice_beam=8.0),
          "narrow_retry": dict(beam=6.0, max_active=40, retry_beam=48.0,
                               lattice_beam=4.0)}


@pytest.mark.parametrize("setting", sorted(_BEAMS))
def test_numpy_beam_search_matches_jax(sparse, setting):
    """The port's numpy decoder against JAX's: the same words, scores
    within 1e-4, lattices array for array."""
    kw = dict(_BEAMS[setting], lattice=True, acoustic_scale=0.9)
    for obs in sparse["obs"]:
        jr = jbeam.beam_decode_sparse(obs, sparse["jg"], native="never", **kw)
        tr = tbeam.beam_decode_sparse(obs, sparse["tg"], native=False, **kw)
        assert tr.words == jr.words
        assert abs(tr.score - jr.score) <= 1e-4
        assert tr.num_active_mean == jr.num_active_mean
        _assert_lattices_equal(tr.lattice, jr.lattice)


@pytest.mark.parametrize("setting", sorted(_BEAMS))
def test_native_beam_search_matches_numpy(sparse, setting):
    """The C++ decoder (the default) against the port's numpy one, as
    tests/test_native.py holds the reference's: words, score, lattice
    best path and arc count; the narrow beam dies and retries."""
    kw = dict(_BEAMS[setting], lattice=True)
    for obs, utt in zip(sparse["obs"], sparse["utts"]):
        py = tbeam.beam_decode_sparse(obs, sparse["tg"], native=False, **kw)
        nat = tbeam.beam_decode_sparse(obs, sparse["tg"], **kw)
        assert nat.words == py.words
        assert abs(nat.score - py.score) < 1e-3
        pw, ps = tlat.lattice_best_path(py.lattice)
        nw, ns = tlat.lattice_best_path(nat.lattice)
        assert nw == pw and abs(ns - ps) < 1e-3
        assert nat.lattice.num_arcs == py.lattice.num_arcs
    wide = tbeam.beam_decode_sparse(sparse["obs"][0], sparse["tg"])
    assert wide.lattice is None and wide.words == sparse["utts"][0].words


def test_adaptive_beam_retry(sparse, monkeypatch):
    """retry_beam re-decodes with a doubled beam on search death (Kaldi
    decode.sh retry semantics); without it the death propagates."""
    obs = sparse["obs"][0]
    calls = []
    real = tbeam._beam_decode_once

    def flaky(o, gg, ac, beam, *a, **k):
        calls.append(beam)
        if beam < 30.0:
            raise tbeam.BeamSearchDied("forced death")
        return real(o, gg, ac, beam, *a, **k)

    monkeypatch.setattr(tbeam, "_beam_decode_once", flaky)
    res = tbeam.beam_decode_sparse(obs, sparse["tg"], beam=8.0,
                                   retry_beam=32.0, native=False)
    assert calls == [8.0, 16.0, 32.0]
    assert res.words == sparse["utts"][0].words
    calls.clear()
    with pytest.raises(tbeam.BeamSearchDied):
        tbeam.beam_decode_sparse(obs, sparse["tg"], beam=8.0, native=False)
    assert calls == [8.0]


def test_native_search_death_raises(sparse):
    """The C++ decoder's death is the same BeamSearchDied."""
    obs = np.full_like(sparse["obs"][0], -1e30)
    with pytest.raises(tbeam.BeamSearchDied):
        tbeam.beam_decode_sparse(obs, sparse["tg"], beam=8.0)


def test_forked_workers_match_serial(sparse):
    """Forked per-utterance decode workers (decode.sh --nj) return exactly
    the serial results."""
    kw = dict(acoustic_scale=1.0, beam=14.0, max_active=7000, lattice=True,
              lattice_beam=7.0, retry_beam=56.0)
    native.get_decoder_lib()
    trec._DECODE_SHARED = (sparse["tg"], sparse["obs"], kw)
    try:
        with mp.get_context("fork").Pool(2) as pool:
            res = pool.map(trec._decode_worker, range(len(sparse["obs"])),
                           chunksize=1)
    finally:
        trec._DECODE_SHARED = None
    res.sort(key=lambda r: r[0])
    for i, words, lat in res:
        ser = tbeam.beam_decode_sparse(sparse["obs"][i], sparse["tg"], **kw)
        assert words == ser.words
        _assert_lattices_equal(lat, ser.lattice)


@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_decoder_build_failure_raises(sparse, tmp_path, monkeypatch,
                                      compiler):
    """A decoder library that cannot be built raises with the compiler's
    output from the default (native) search; nothing falls back to numpy,
    and no library is left behind."""
    if compiler == "fails":
        cxx = tmp_path / "cxx"
        cxx.write_text("#!/bin/sh\necho 'beam_sparse.cc:1: fake compiler "
                       "error' >&2\nexit 3\n")
        cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
        match = "fake compiler error"
    else:
        cxx = tmp_path / "no-such-compiler"
        match = "cannot run"
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    native.get_decoder_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            tbeam.beam_decode_sparse(sparse["obs"][0], sparse["tg"])
        with pytest.raises(RuntimeError, match=match):
            native.build(native.DECODER_SOURCES, "decoders")
    finally:
        native.get_decoder_lib.cache_clear()
    assert not list(build_dir.glob("*.so"))


def test_decoder_library_is_keyed_and_standalone():
    """decoder.cc, lattice.cc and beam_sparse.cc build into one library of
    the port's build directory, keyed on the three sources and the flags,
    apart from the loader's; the JAX package's libegs.so is never
    loaded."""
    lib = native.get_decoder_lib()
    so = native.library_path(native.DECODER_SOURCES, "decoders")
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("decoders_") and lib._name == str(so)
    assert so != native.library_path()
    assert [s.name for s in native.DECODER_SOURCES] == [
        "decoder.cc", "lattice.cc", "beam_sparse.cc"]
    for name in ("decode_nbest", "generate_lattice",
                 "beam_decode_sparse_native"):
        assert getattr(lib, name).argtypes is not None, name


@pytest.fixture(scope="module")
def dense():
    """Each package's dense bigram decoding graph and noisy planted obs of
    three utterances (the world of tests/test_lattice.py)."""
    kw = dict(num_utts=10, num_phones=8, feat_dim=16, seed=0)
    j = jsyn.make_word_corpus(jsyn.WordCorpusConfig(**kw))
    t = tsyn.make_word_corpus(tsyn.WordCorpusConfig(**kw))
    jdg = jwfst.build_decoding_graph(
        jwfst.Lexicon(j[1]), jwfst.estimate_word_lm(j[2], 12), j[5], j[4])
    tdg = twfst.build_decoding_graph(
        twfst.Lexicon(t[1]), twfst.estimate_word_lm(t[2], 12), t[5], t[4])
    rng = np.random.RandomState(1)
    obs = [_noisy_obs(u, t[4].num_pdfs, rng, noise=0.3) for u in t[0][:3]]
    return dict(utts=t[0], jdg=jdg, tdg=tdg, obs=obs,
                jwlm=jwfst.estimate_word_lm(j[2], 12),
                twlm=twfst.estimate_word_lm(t[2], 12),
                text=[[str(w) for w in ws] for ws in t[2]])


@pytest.mark.parametrize("lattice_beam", [3.0, 12.0])
def test_generate_lattice_matches_jax_and_native(dense, lattice_beam):
    for obs in dense["obs"]:
        jl = jlat.generate_lattice(obs, dense["jdg"], beam=14.0,
                                   lattice_beam=lattice_beam)
        tl = tlat.generate_lattice(obs, dense["tdg"], beam=14.0,
                                   lattice_beam=lattice_beam)
        _assert_lattices_equal(tl, jl)
        nat = native.generate_lattice_native(obs, dense["tdg"], beam=14.0,
                                             lattice_beam=lattice_beam)
        _assert_lattices_equal(nat, tl, exact=False)


def test_nbest_matches_jax_and_native(dense):
    for obs in dense["obs"]:
        jn = jnb.nbest_decode(obs, dense["jdg"], n=5, acoustic_scale=0.8)
        tn = tnb.nbest_decode(obs, dense["tdg"], n=5, acoustic_scale=0.8)
        assert [w for w, _ in tn] == [w for w, _ in jn]
        np.testing.assert_allclose([s for _, s in tn], [s for _, s in jn],
                                   rtol=0, atol=1e-4)
        nat = native.nbest_decode_native(obs, dense["tdg"], n=5,
                                         acoustic_scale=0.8)
        assert [w for w, _ in nat] == [w for w, _ in tn]
        np.testing.assert_allclose([s for _, s in nat], [s for _, s in tn],
                                   rtol=1e-4, atol=1e-3)


def _lattice_pair(dense, i, lattice_beam=15.0):
    obs = dense["obs"][i]
    return (jlat.generate_lattice(obs, dense["jdg"], beam=1e9,
                                  lattice_beam=lattice_beam),
            tlat.generate_lattice(obs, dense["tdg"], beam=1e9,
                                  lattice_beam=lattice_beam))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_lattice_operations_match_jax(dense, i):
    """Best path, backward best, n-best, arc posteriors and oracle WER."""
    jl, tl = _lattice_pair(dense, i)
    assert tlat.lattice_best_path(tl) == jlat.lattice_best_path(jl)
    np.testing.assert_array_equal(tlat.lattice_backward_best(tl),
                                  jlat.lattice_backward_best(jl))
    jn, tn = jlat.lattice_nbest(jl, n=8), tlat.lattice_nbest(tl, n=8)
    assert [w for w, _ in tn] == [w for w, _ in jn]
    np.testing.assert_allclose([s for _, s in tn], [s for _, s in jn],
                               rtol=0, atol=1e-4)
    jp, jz = jlat.lattice_arc_posteriors(jl)
    tp, tz = tlat.lattice_arc_posteriors(tl)
    np.testing.assert_array_equal(tp, jp)
    assert tz == jz
    ref = list(dense["utts"][i].words)
    for r in (ref, ref[1:], ref + [3], []):
        assert tlat.lattice_oracle_wer(tl, r) == jlat.lattice_oracle_wer(jl, r)
    assert tlat.lattice_oracle_wer(tl, ref) == 0


@pytest.mark.parametrize("order", [1, 3])
def test_rescoring_matches_jax(dense, order):
    """n-gram lattice rescoring (old LM: the dense graph's bigram) and
    n-best rescoring, and the per-token old-LM scores."""
    jbig = jng.estimate_ngram_lm(dense["text"], order=order)
    tbig = tng.estimate_ngram_lm(dense["text"], order=order)
    for i in range(3):
        jl, tl = _lattice_pair(dense, i, lattice_beam=20.0)
        jo = jlat.rescore_lattice(jl, dense["jwlm"], jbig, lm_scale=0.7, n=4)
        to = tlat.rescore_lattice(tl, dense["twlm"], tbig, lm_scale=0.7, n=4)
        assert [w for w, _ in to] == [w for w, _ in jo]
        np.testing.assert_allclose([s for _, s in to], [s for _, s in jo],
                                   rtol=0, atol=1e-4)
        obs = dense["obs"][i]
        jn = jres.rescore_nbest(jnb.nbest_decode(obs, dense["jdg"], n=6),
                                dense["jwlm"], jbig, lm_scale=0.7)
        tn = tres.rescore_nbest(tnb.nbest_decode(obs, dense["tdg"], n=6),
                                dense["twlm"], tbig, lm_scale=0.7)
        assert [w for w, _ in tn] == [w for w, _ in jn]
        np.testing.assert_allclose([s for _, s in tn], [s for _, s in jn],
                                   rtol=0, atol=1e-4)
        for words, _ in tn:
            assert (tres.graph_lm_logprob(words, dense["twlm"])
                    == jres.graph_lm_logprob(words, dense["jwlm"]))
            for old_t, old_j in ((dense["twlm"], dense["jwlm"]),
                                 (tbig, jbig)):
                assert (tres._old_lm_token_logprobs(words, old_t)
                        == jres._old_lm_token_logprobs(words, old_j))


def test_sparse_lattice_rescoring_matches_jax(sparse):
    """4-gram rescoring of the beam search's lattices, the first-pass LM
    an NGramLM (the G of the sparse HCLG), as the decode path runs it."""
    sents = [[_SYM[w] for w in u.words] for u in sparse["utts"]]
    jbig = jng.estimate_ngram_lm(sents, order=4)
    tbig = tng.estimate_ngram_lm(sents, order=4)
    wtt = lambda w: _SYM[w]
    kw = dict(beam=16.0, lattice=True, lattice_beam=8.0)
    for obs in sparse["obs"][:3]:
        jl = jbeam.beam_decode_sparse(obs, sparse["jg"], native="never",
                                      **kw).lattice
        tl = tbeam.beam_decode_sparse(obs, sparse["tg"], **kw).lattice
        jo = jlat.rescore_lattice(jl, sparse["jlm"], jbig, word_to_token=wtt,
                                  n=3)
        to = tlat.rescore_lattice(tl, sparse["tlm"], tbig, word_to_token=wtt,
                                  n=3)
        assert [w for w, _ in to] == [w for w, _ in jo]
        np.testing.assert_allclose([s for _, s in to], [s for _, s in jo],
                                   rtol=0, atol=1e-3)


def _to_jax(lat):
    return jlat.Lattice(**{f: getattr(lat, f) for f in (
        "num_nodes", "node_time", "arc_src", "arc_dst", "arc_word", "arc_am",
        "arc_gs")})


def test_native_lattice_rescoring_and_out_arcs_match_jax(sparse):
    """On the C++ decoder's lattices, whose node ids span every kept token
    (most on no arc): the same out-arc groups as the reference's list,
    and the same 4-gram rescoring on the same lattice."""
    sents = [[_SYM[w] for w in u.words] for u in sparse["utts"]]
    jbig = jng.estimate_ngram_lm(sents, order=4)
    tbig = tng.estimate_ngram_lm(sents, order=4)
    wtt = lambda w: _SYM[w]
    for obs in sparse["obs"][:3]:
        tl = tbeam.beam_decode_sparse(obs, sparse["tg"], beam=16.0,
                                      lattice=True, lattice_beam=8.0).lattice
        jl = _to_jax(tl)
        assert tl.num_nodes > 2 * len(np.unique(tl.arc_src))
        touts, jouts = tl.out_arcs(), jl.out_arcs()
        assert len(touts) == len(jouts) == tl.num_nodes
        for node in range(tl.num_nodes):
            np.testing.assert_array_equal(touts[node], jouts[node])
        jo = jlat.rescore_lattice(jl, sparse["jlm"], jbig, word_to_token=wtt,
                                  n=3)
        to = tlat.rescore_lattice(tl, sparse["tlm"], tbig, word_to_token=wtt,
                                  n=3)
        assert to == jo


@pytest.mark.parametrize("i", [0, 1, 2])
def test_determinize_matches_jax(dense, i):
    jl, tl = _lattice_pair(dense, i, lattice_beam=20.0)
    jd, td = jlat.determinize_lattice(jl), tlat.determinize_lattice(tl)
    _assert_lattices_equal(td, jd)
    assert tlat.lattice_best_path(td)[0] == tlat.lattice_best_path(tl)[0]
    with pytest.raises(RuntimeError, match="max_states"):
        tlat.determinize_lattice(tl, max_states=1)
