"""The port's tree comparisons (``tools/context_compare``,
``tools/wpd_compare``) on the CPU:
each mode's corpus config and each table, run by the reference script's
own code and by the port's on the same small corpus with the same
stand-ins for training, valid steps and decoding (so every host figure,
the clustering log-likelihood, the den's and the HCLG's sizes, is held to
the reference's); the word-position-marked corpus bit for bit; three
float32 steps of a ``pm1`` contender on its wildcard den against JAX's;
one small ``main`` of each; and the resume that raises where the
reference went on."""

import contextlib
import dataclasses
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdnnf_nas_torch.data.synthetic as tsyn
import tdnnf_nas_tpu.data.synthetic as jsyn
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.tools import context_compare as tcc
from tdnnf_nas_torch.tools import wpd_compare as twpd
from tests.test_torch_search_experiments import (NARROW, _Captured, _World,
                                                 _doc, _drop_seconds,
                                                 _jax_standins,
                                                 _port_standins, _reference,
                                                 _rounded, _small_decodes)

torch.set_num_threads(2)

_MAKE_WORD_CORPUS = {"jax": jsyn.make_word_corpus,
                     "torch": tsyn.make_word_corpus}
_SWITCHES = {"default": dict(MODE="", SYM=False, HARD=False),
             "sym": dict(MODE="sym", SYM=True, HARD=False),
             "symhard": dict(MODE="symhard", SYM=True, HARD=True)}


def _no_files(ref):
    """The reference's ``os`` with no file on disk (its resume reads
    ``docs/``, which holds the reference's own runs) and no directory
    made; each ``open(path, "w")`` writes a fresh buffer: {path: the last
    one}."""
    ref.os = types.SimpleNamespace(
        path=types.SimpleNamespace(exists=lambda p: False),
        makedirs=lambda *a, **k: None)
    bufs = {}

    def fake_open(path, mode="r", *a, **k):
        assert mode == "w", (path, mode)
        bufs[path] = io.StringIO()
        return contextlib.nullcontext(bufs[path])

    ref.open = fake_open
    return bufs


def _small_world(num_utts):
    """make_word_corpus stand-ins for both packages: the config each side
    asks for, with ``num_utts`` utterances; records the configs."""
    seen = {}

    def side(pkg):
        def make(cfg, *a, **k):
            seen[pkg] = dataclasses.asdict(cfg)
            syn = {"jax": jsyn, "torch": tsyn}[pkg]
            return _MAKE_WORD_CORPUS[pkg](syn.WordCorpusConfig(
                **dict(dataclasses.asdict(cfg), num_utts=num_utts)))
        return make
    return seen, side


# ---- context_compare ----

@pytest.mark.parametrize("mode", tcc.MODES)
def test_context_corpus_configs_equal_the_reference(mode, monkeypatch):
    """Each mode's corpus config is the reference's (its MODE, SYM and
    HARD switches set on the module), and its file name and corpus
    string the reference's."""
    seen = {}

    def capture(side):
        def make(cfg, *a, **k):
            seen[side] = dataclasses.asdict(cfg)
            raise _Captured
        return make

    ref = _reference("context_compare", **_SWITCHES[mode])
    monkeypatch.setattr(jsyn, "make_word_corpus", capture("jax"))
    with pytest.raises(_Captured):
        ref.main()
    monkeypatch.setattr(tcc, "make_word_corpus", capture("torch"))
    with pytest.raises(_Captured):
        tcc.main(["--mode", mode, "--out", ""], device="cpu")
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["num_utts"] == 720
    assert tcc.FILES[mode] in os.listdir(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs"))
    assert tcc.corpus_note(mode) == _doc(tcc.FILES[mode])["corpus"]
    full = tcc.CompareSizes.full()
    assert (full.leaves, full.steps) == (ref.LEAVES, ref.STEPS)


def test_context_table_equals_the_reference(monkeypatch):
    """``symhard`` on a 300-utterance corpus of its config, training,
    valid steps and decodes stood in for: the same train_model calls and
    decodes, and the same file but its seconds, every host figure
    included (pdfs, cluster_ll_per_frame, den states and arcs, HCLG
    states); the pm1 den carries the wildcard term."""
    seen, side = _small_world(300)
    ref = _reference("context_compare", **_SWITCHES["symhard"])
    bufs = _no_files(ref)
    jw = _World({}, torch_side=False)
    _jax_standins(monkeypatch, jw)
    monkeypatch.setattr(jsyn, "make_word_corpus", side("jax"))
    ref.main()
    want = json.loads(bufs["docs/context_compare_symhard.json"].getvalue())

    tw = _World({}, torch_side=True)
    _port_standins(monkeypatch, tw, tcc)
    monkeypatch.setattr(tcc, "make_word_corpus", side("torch"))
    res = tcc.main(["--mode", "symhard", "--out", ""], device="cpu")
    assert seen["torch"] == seen["jax"]
    assert tw.calls == jw.calls and len(tw.calls) == 3
    assert [c[2] for c in tw.calls] == [800] * 3
    assert tw.decodes == jw.decodes and tw.decodes[0][0] == 60
    got = res.report.search
    assert set(got["table"]) == set(tcc.CONTENDERS)
    assert {k: _drop_seconds(v) for k, v in got["table"].items()} == {
        k: _drop_seconds(v) for k, v in want["table"].items()}
    assert _drop_seconds({**got, "table": None}) == _drop_seconds(
        {**want, "table": None})
    assert res.report.valid_batches == 6 * 3
    dens = {k: h.bundle.den_arrays for k, h in res.world.hosts.items()}
    assert [k for k, d in dens.items() if d.bcast_sel is not None] == ["pm1"]


def test_context_resume_keeps_rows_and_raises_on_a_broken_file(tmp_path,
                                                                monkeypatch):
    """A file in --out with every row: nothing is trained or built but the
    corpus; a file there that cannot be read raises (the reference
    ignores it, ``:127-133``)."""
    tw = _World({}, torch_side=True)
    _port_standins(monkeypatch, tw, tcc)
    rows = {k: {"wer": 1.0} for k in tcc.CONTENDERS}
    path = tmp_path / tcc.FILES["sym"]
    path.write_text(json.dumps({"table": rows}))
    res = tcc.main(["--mode", "sym", "--out", str(tmp_path)], device="cpu")
    assert tw.calls == [] and res.world.hosts == {}
    assert res.report.search["table"] == rows
    path.write_text("{not json")
    with pytest.raises(json.JSONDecodeError):
        tcc.main(["--mode", "sym", "--out", str(tmp_path)], device="cpu")


def test_context_main_writes_the_reference_file(tmp_path, monkeypatch):
    """One small symhard run: the reference file's keys and rounding, the
    steps and valid batches counted, the dens blocked."""
    _small_decodes(monkeypatch, tcc)
    sizes = tcc.CompareSizes(num_utts=240, n_test=3, leaves=40, steps=1,
                             model_overrides=NARROW)
    res = tcc.main(["--mode", "symhard", "--out", str(tmp_path)],
                   device="cpu", sizes=sizes)
    with open(tmp_path / tcc.FILES["symhard"]) as f:
        got = json.load(f)
    ref = _doc("context_compare_symhard.json")
    assert set(got) == set(ref) and set(got["table"]) == set(ref["table"])
    for row in got["table"].values():
        assert list(row) == list(ref["table"]["left1"])
        assert _rounded(row["cluster_ll_per_frame"], 4)
        assert _rounded(row["dev_objf"], 4) and np.isfinite(row["dev_objf"])
        assert _rounded(row["wer"], 2) and row["wer"] >= 0
    assert res.report.steps == {k: 1 for k in tcc.CONTENDERS}
    assert res.report.valid_batches == 6 * 3


# ---- wpd_compare ----

def test_marked_corpus_equals_the_reference_bit_for_bit():
    """The word-position-marked twin of the full corpus: the marked
    phones, the audio and alignments untouched, the marked lexicon, the
    phone count and the topology, as ``scripts/wpd_compare.py:259-266``
    builds them."""
    from tdnnf_nas_tpu.graphs.topology import ChainTopology
    from tdnnf_nas_tpu.graphs.wpd import (mark_lexicon, mark_word_stream,
                                          num_marked_phones)

    cfg = twpd.corpus_config(360)
    j_utts, j_prons = jsyn.make_word_corpus(
        jsyn.WordCorpusConfig(**dataclasses.asdict(cfg)))[:2]
    t_utts, t_prons = tsyn.make_word_corpus(cfg)[:2]
    j_m = [dataclasses.replace(u, phones=mark_word_stream(u.words, j_prons))
           for u in j_utts]
    t_m, t_prons_m, t_p, t_topo = twpd.marked_corpus(t_utts, t_prons, 14)
    assert t_prons_m == mark_lexicon(j_prons)
    assert t_p == num_marked_phones(14) == 56
    assert t_topo.num_phones == ChainTopology(56).num_phones
    assert len(t_m) == len(j_m) == 360
    for a, b in zip(t_m, j_m):
        assert list(a.phones) == list(b.phones)
        np.testing.assert_array_equal(a.feats, b.feats)
        np.testing.assert_array_equal(a.pdf_align, b.pdf_align)
        assert (a.words, a.begins, a.ends) == (b.words, b.begins, b.ends)
    assert any(max(u.phones) >= 14 for u in t_m)


def test_wpd_table_equals_the_reference(monkeypatch):
    """The three contenders on a 160-utterance corpus of the reference's
    config, training, valid steps and decodes stood in for: the same calls
    and decodes, and the same file but its seconds (pdfs and den states
    included), its corpus string verbatim."""
    seen, side = _small_world(160)
    ref = _reference("wpd_compare")
    bufs = _no_files(ref)
    jw = _World({}, torch_side=False)
    _jax_standins(monkeypatch, jw)
    monkeypatch.setattr(jsyn, "make_word_corpus", side("jax"))
    ref.main()
    want = json.loads(bufs["docs/wpd_compare.json"].getvalue())

    tw = _World({}, torch_side=True)
    _port_standins(monkeypatch, tw, twpd, tcc)
    monkeypatch.setattr(twpd, "make_word_corpus", side("torch"))
    res = twpd.main(["--out", ""], device="cpu")
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]["boundary_shift"] == 1.5
    assert tw.calls == jw.calls and [c[2] for c in tw.calls] == [500] * 3
    assert tw.decodes == jw.decodes and tw.decodes[0][0] == 50
    got = res.report.search
    assert {k: _drop_seconds(v) for k, v in got["table"].items()} == {
        k: _drop_seconds(v) for k, v in want["table"].items()}
    assert got["corpus"] == want["corpus"] == _doc("wpd_compare.json")[
        "corpus"]
    assert set(got) == set(_doc("wpd_compare.json"))
    assert res.report.valid_batches == 4 * 3


def test_wpd_main_writes_the_reference_file(tmp_path, monkeypatch):
    _small_decodes(monkeypatch, tcc)
    sizes = twpd.WpdSizes(num_utts=160, n_test=3, leaves=30, steps=1,
                          model_overrides=NARROW)
    res = twpd.main(["--out", str(tmp_path)], device="cpu", sizes=sizes)
    with open(tmp_path / twpd.FILE) as f:
        got = json.load(f)
    ref = _doc("wpd_compare.json")
    assert set(got) == set(ref) and set(got["table"]) == set(ref["table"])
    for row in got["table"].values():
        assert list(row) == list(ref["table"]["left1"])
        assert _rounded(row["train_objf"], 4) and np.isfinite(row["dev_objf"])
    assert res.report.steps == {k: 1 for k in twpd.CONTENDERS}
    assert res.world.hosts["left1_wpd"].bundle.num_phones == 56


# ---- three float32 steps of a pm1 contender ----

def test_pm1_contender_three_f32_steps_match_jax():
    """A ``pm1`` contender of ``context_compare`` (symhard, narrow model in
    float32) on its committed den with the wildcard term, the den equal
    to the JAX package's: three steps from JAX's initial state on the
    same batches, the port's plain scan against JAX's XLA
    ``_blocked_score_core`` (the Pallas kernel has no wildcard term),
    objf within the blocked den's atol 2e-5
    (tests/test_pallas_fwdbwd.py:102) at every step."""
    import tdnnf_nas_tpu.data.egs as jegs
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec
    import tdnnf_nas_tpu.train as jtrain
    from tdnnf_nas_torch.ops import fwdbwd as tfwd
    from tdnnf_nas_torch.train import make_train_step

    from tdnnf_nas_torch.data.egs import batch_iterator

    cfg = tcc.corpus_config("symhard", 160)
    utts, prons, word_seqs, _, _, topo = tsyn.make_word_corpus(cfg)
    train = utts[4:]
    word_sym, lm3 = tcc.word_trigram(cfg, word_seqs[4:])
    host = tcc.contender_host("pm1", train, prons, topo, 30, 3, lm3,
                              word_sym, tcc.plan(tcc.CompareSizes(
                                  num_utts=160, n_test=4, leaves=40,
                                  steps=3)))
    j_utts, _, _, _, _, j_topo = jsyn.make_word_corpus(
        jsyn.WordCorpusConfig(**dataclasses.asdict(cfg)))
    j_train = j_utts[4:]
    stats = jgraphs.accumulate_cross_triphone_stats(
        [u.feats for u in j_train], [u.phones for u in j_train],
        [u.begins for u in j_train], 30, 3)
    jtree = jgraphs.build_clustered_cross_triphone_tree(stats, num_leaves=40)
    jb = jrec.prepare_data(j_train, [u.phones for u in j_train], jtree,
                           j_topo, 30, dev_fraction=0.05, phone_lm_order=3,
                           num_extra_lm_states=300)
    tb = host.bundle
    assert tb.den_fsa.num_states == jb.den_fsa.num_states
    assert tb.den_arrays.bcast_sel is not None
    mc = tcc.model_config(host.tree.num_pdfs, NARROW + (
        ("compute_dtype", "float32"),))
    jmc = jmodels.TdnnfModelConfig(**dataclasses.asdict(mc))
    tc = tcc.trainer_config(800)
    jtc = jtrain.TrainerConfig(
        objective=jtrain.ChainObjectiveConfig(),
        optimizer=jtrain.OptimizerConfig(**dataclasses.asdict(
            tc.optimizer)))
    assert tc.to_json() == jtc.to_json()
    it = jegs.batch_iterator(jb.egs(jmc, chunk_width=40), 8,
                             np.random.RandomState(5))
    jbatches = [next(it) for _ in range(3)]
    it = batch_iterator(tb.egs(mc, chunk_width=40), 8,
                        np.random.RandomState(5))
    tbatches = [next(it) for _ in range(3)]
    for a, b in zip(jbatches, tbatches):
        np.testing.assert_array_equal(a["feats"], b["feats"])

    g = tfwd.BlockedDenGraph.from_host(tb.den_arrays, "cpu")
    jst = jtrain.init_train_state(jmc, jtc, jax.random.PRNGKey(0))
    jstep = jtrain.make_train_step(jmc, jtc, jb.den_arrays, donate=False)
    tst = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst.params),
        jax.tree.map(np.asarray, jst.bn_state),
        jax.tree.map(np.asarray, jst.opt_state), int(jst.step),
        device="cpu")
    tstep = make_train_step(mc, tc, g)
    jtraj, ttraj = [], []
    for jbatch, tbatch in zip(jbatches, tbatches):
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, jbatch),
                        jax.random.PRNGKey(1))
        tst, tm = tstep(tst, convert.batch_to_torch(tbatch, device="cpu"))
        jtraj.append(float(jm["objf_mmi"]))
        ttraj.append(float(tm["objf_mmi"]))
    assert all(np.isfinite(ttraj)), ttraj
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 2e-5, (delta, jtraj, ttraj)
