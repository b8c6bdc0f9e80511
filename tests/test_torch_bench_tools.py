"""The port's profile and bench tools (``tools/profile_components``,
``profile_den``, ``bench_triphone_den``, ``bench_sparse_decode``,
``bench_scaling``, ``bench_dense_den``) on the CPU at tiny sizes: each
writes the reference's keys, and its host figures equal the reference's
code at the same sizes (the den's states, pdfs, positions and in-degree,
the phone LM's states, the decode graph, WER and hypotheses, the scaling
world's chunks); two gloo ranks match one process on ``sgd``; the dense
pair's plain logZ equals the reference's XLA scan; and the reference's
``profile_den.py`` and ``bench_triphone_den.py``, which read a factored
den that ``prepare_data`` no longer exports, stop where the port's
docstrings say."""

import contextlib
import importlib.util
import io
import json
import os

import jax  # noqa: F401  (the reference runs in this process, on the CPU)
import numpy as np
import pytest
import torch

from tdnnf_nas_torch.tools import (bench_dense_den, bench_scaling,
                                   bench_sparse_decode, bench_triphone_den,
                                   profile_components, profile_den)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = (("hidden_dim", 32), ("bottleneck_dim", 8),
          ("time_strides", (1, 0, 3)), ("prefinal_big", 32),
          ("prefinal_small", 16))
# the production set-up cut to the CPU: utterances, tree leaves, extra
# LM states
CUT = (120, 60, 20)


def _reference(name: str):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timing_keys(res: dict, keys) -> None:
    for k in keys:
        assert np.isfinite(res[k]) and res[k] > 0, k
        assert len(res["rounds"][k]) == 2
    assert res["device"] == "cpu"


# ---- profile_components ----

def test_profile_components_keys_and_den_equal_the_reference():
    """The five timings under the reference's labels, and its den at its
    own sizes: 8 utterances and a tree asked for 6,034 - 46 leaves, which
    caps at the 2,208 biphone pdfs; S = 2,208."""
    import tdnnf_nas_tpu.data as jdata
    import tdnnf_nas_tpu.graphs as jgraphs
    from tdnnf_nas_tpu.graphs.topology import BiphoneTree

    res = profile_components.run(batch=2, width=5, model_overrides=NARROW,
                                 n=1, rounds=2, device="cpu")
    _timing_keys(res, profile_components.KEYS)
    _, phone_seqs, _, topo = jdata.make_synthetic_corpus(
        jdata.SyntheticCorpusConfig(num_utts=8, num_phones=46, feat_dim=40,
                                    min_phones=10, max_phones=30))
    tree = BiphoneTree(46, num_leaves=6034 - 46)
    den = jgraphs.build_denominator_graph(
        jgraphs.estimate_phone_lm(phone_seqs, 46), topo, tree)
    assert (res["den_states"], res["num_pdfs"]) == (den.num_states,
                                                    den.num_pdfs)
    assert res["tree_pdfs"] == tree.num_pdfs == den.num_states == 2208
    num = profile_components.numerator_graphs(2, 5, tree.num_pdfs)
    assert num[1].shape == (2, 80) and num[4].shape == (2, 5, 80)


# ---- the production set-up: profile_den and bench_triphone_den ----

@pytest.fixture(scope="module")
def production():
    """The port's production set-up at CUT, and the reference's chain
    (``scripts/bench_triphone_den.py:39-60``) at the same cut, with the
    factored export its scripts read."""
    import tdnnf_nas_tpu.data as jdata
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    n_utts, leaves, extra = CUT
    tree, bundle, _ = profile_den.production_setup(n_utts, leaves, extra)
    utts, phone_seqs, _, topo = jdata.make_synthetic_corpus(
        jdata.SyntheticCorpusConfig(
            num_utts=n_utts, num_phones=46, feat_dim=40, min_phones=10,
            max_phones=30, mean_dur=4.0, context_shift=1.0, seed=0))
    stats = jgraphs.accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts], 46, 3)
    jtree = jgraphs.build_clustered_triphone_tree(stats, num_leaves=leaves)
    jbundle = jrec.prepare_data(utts, phone_seqs, jtree, topo, 46,
                                phone_lm_order=4, num_extra_lm_states=extra)
    return tree, bundle, jtree, jbundle, jbundle.den_fsa.to_factored()


def test_production_den_figures_equal_the_reference(production):
    """pdfs, den states, positions, the in-degree K the reference's
    factored export pads to, and the phone LM's states."""
    tree, bundle, jtree, jbundle, fac = production
    want = {"den_states": int(fac.num_states),
            "den_positions": int(fac.seg_bounds.shape[0]) - 1,
            "den_in_degree_K": int(fac.in_pos.shape[1]),
            "phone_lm_states": int(jbundle.lm.num_states)}
    assert bench_triphone_den.den_figures(bundle) == want
    assert tree.num_pdfs == jtree.num_pdfs
    assert type(jbundle.den_arrays).__name__ == "BlockedDenGraph"
    assert type(bundle.den_arrays).__name__ == "BlockedDenGraph"


def _cut_reference(monkeypatch, name):
    """``scripts/<name>.py`` with its set-up cut to CUT and its model to
    NARROW's widths."""
    import tdnnf_nas_tpu.data as jdata
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.models as jmodels
    import tdnnf_nas_tpu.recipes.chain_recipes as jrec

    n_utts, leaves, extra = CUT
    corpus, build = jdata.SyntheticCorpusConfig, jgraphs.build_clustered_triphone_tree
    prep, model = jrec.prepare_data, jmodels.TdnnfModelConfig
    monkeypatch.setattr(jdata, "SyntheticCorpusConfig", lambda **kw: corpus(
        **{**kw, "num_utts": n_utts}))
    monkeypatch.setattr(jgraphs, "build_clustered_triphone_tree",
                        lambda stats, num_leaves: build(stats, leaves))
    monkeypatch.setattr(jrec, "prepare_data", lambda *a, **kw: prep(
        *a, **{**kw, "num_extra_lm_states": extra}))
    monkeypatch.setattr(jmodels, "TdnnfModelConfig", lambda **kw: model(
        **kw).replace(**dict(NARROW)))
    return _reference(name)


@pytest.mark.parametrize("name, missing", [
    ("profile_den", "seg_bounds"), ("bench_triphone_den", "in_pos")])
def test_reference_script_stops_at_the_blocked_den(name, missing,
                                                   monkeypatch):
    """Both scripts read a FactoredDenGraph's fields from
    ``bundle.den_arrays``, and ``prepare_data`` hands them a
    BlockedDenGraph: ``profile_den.py`` stops at its den timing
    (``:124-130``), ``bench_triphone_den.py`` right after the den build
    (``:59``)."""
    ref = _cut_reference(monkeypatch, name)
    with pytest.raises(AttributeError, match=missing):
        ref.main() if name == "profile_den" else ref.main(1)


def test_profile_den_keys(production, tmp_path):
    tree, bundle, *_ = production
    res = profile_den.run(str(tmp_path), bundle=bundle, tree=tree, batch=4,
                          chunk_width=10, model_overrides=NARROW, n=1,
                          rounds=2, device="cpu")
    _timing_keys(res, profile_den.KEYS)
    with open(tmp_path / "profile_den.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert res["den_type"] == "BlockedDenGraph"
    assert res["den_states"] == bundle.den_arrays.num_states


def test_bench_triphone_den_keys_and_figures(production, tmp_path):
    tree, bundle, _, jbundle, fac = production
    res = bench_triphone_den.run(str(tmp_path), 2, bundle=bundle, tree=tree,
                                 batch=4, chunk_width=10,
                                 model_overrides=NARROW, rounds=2, reps=1,
                                 device="cpu")
    assert set(bench_triphone_den.KEYS) <= set(res)
    assert res["den_states"] == fac.num_states
    assert res["den_in_degree_K"] == fac.in_pos.shape[1]
    assert res["num_pdfs"] == tree.num_pdfs
    assert res["tree_build_s"] is None and res["backend"] == "cpu"
    assert np.isfinite(res["objf_mmi"]) and res["train_step_ms"] > 0
    assert (tmp_path / "triphone_bench.json").exists()


# ---- bench_sparse_decode ----

SPARSE_SMALL = dict(vocab_size=200, n_train_sents=500, n_test=3)
# the figures that follow from the data alone (the rest are seconds)
_SPARSE_HOST = ("vocab", "lm_ngrams", "graph_states", "graph_arcs", "wer",
                "obs_noise", "beam", "mean_active", "lattice_bestpath_match",
                "utterances")


def test_sparse_decode_equals_the_reference(monkeypatch, tmp_path):
    """The reference's main at a 200-word vocabulary: the same keys, the
    same graph, LM, WER, active tokens and lattice matches, and the same
    hypotheses utterance by utterance."""
    import tdnnf_nas_tpu.decode.beam as jbeam

    ref = _reference("bench_sparse_decode")
    bufs = {}
    ref.open = lambda path, mode="r", *a, **k: contextlib.nullcontext(
        bufs.setdefault(path, io.StringIO()))
    monkeypatch.setattr(ref.os, "makedirs", lambda *a, **k: None)
    hyps = []
    real = jbeam.beam_decode_sparse

    def recording(obs, g, **kw):
        res = real(obs, g, **kw)
        if kw.get("native") != "never":
            hyps.append(res.words)
        return res

    monkeypatch.setattr(jbeam, "beam_decode_sparse", recording)
    ref.main(**SPARSE_SMALL)
    want = json.loads(bufs[os.path.join("docs", "sparse_decode_bench.json")]
                      .getvalue())
    got, got_hyps = bench_sparse_decode.run(str(tmp_path), **SPARSE_SMALL)
    assert set(want) <= set(got)
    assert {k: got[k] for k in _SPARSE_HOST} == {k: want[k]
                                                 for k in _SPARSE_HOST}
    assert got_hyps == hyps and len(hyps) == SPARSE_SMALL["n_test"]
    assert got["native_python_mismatches"] == 0
    with open(tmp_path / "sparse_decode_bench.json") as f:
        assert json.load(f) == got


def test_sparse_decode_presets_are_the_reference_runs():
    """The 5k default and the 30k variant are the reference's arguments
    (``scripts/bench_sparse_decode.py:24-26``, ``:146-148``)."""
    import ast
    import inspect

    ref = _reference("bench_sparse_decode")
    defaults = {k: v.default for k, v in
                inspect.signature(ref.main).parameters.items()}
    assert bench_sparse_decode.PRESETS["5k"] == defaults
    calls = [n for n in ast.walk(ast.parse(inspect.getsource(ref)))
             if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "main"
             and n.keywords]
    assert len(calls) == 1
    variant = {k.arg: ast.literal_eval(k.value) for k in calls[0].keywords}
    assert bench_sparse_decode.PRESETS["30k"] == {**defaults, **variant}


# ---- bench_scaling ----

def test_scaling_world_equals_the_reference():
    """The reference's world: its chunks and den, cut from the same
    corpus."""
    import tdnnf_nas_tpu.data as jdata
    import tdnnf_nas_tpu.graphs as jgraphs
    import tdnnf_nas_tpu.models as jmodels

    chunks, den, cfg = bench_scaling.world()
    utts, phone_seqs, tree, topo = jdata.make_synthetic_corpus(
        jdata.SyntheticCorpusConfig(num_utts=96, num_phones=6, feat_dim=12))
    jden = jgraphs.build_denominator_graph(
        jgraphs.estimate_phone_lm(phone_seqs, 6), topo, tree)
    jcfg = jmodels.TdnnfModelConfig.from_json(cfg.to_json())
    left, right = jmodels.model_context(jcfg)
    jchunks = jdata.make_egs(
        utts, jgraphs.estimate_phone_lm(phone_seqs, 6), topo, tree,
        jdata.EgsConfig(chunk_width=16, left_context=left,
                        right_context=right, max_phones_per_chunk=12),
        den_init_fn=jgraphs.den_init_lookup(jden, 6))
    assert den.num_states == jden.num_states
    np.testing.assert_array_equal(den.trans, jden.trans)
    assert len(chunks) == len(jchunks)
    for a, b in zip(chunks[:5], jchunks[:5]):
        np.testing.assert_array_equal(a.feats, b.feats)


def test_two_gloo_ranks_match_one_process_on_sgd(tmp_path):
    """Weak scaling over 1 and 2 gloo ranks (the reference's keys), and
    the 10-step trajectory of 2 ranks on one global batch within float32
    noise of one rank's; no process group is left in this process."""
    res = bench_scaling.run(str(tmp_path), max_ranks=2, kind="sgd",
                            device="cpu")
    assert set(res["throughput"]) == {"1", "2"}
    for row in res["throughput"].values():
        assert set(row) == {"chunks_per_s", "speedup", "efficiency"}
        assert row["chunks_per_s"] > 0
    assert res["throughput"]["1"]["speedup"] == 1.0
    assert res["objf_parity_10step_max_abs_delta"] <= 1e-5
    traj = res["objf_trajectories"]
    assert len(traj["1"]) == bench_scaling.PARITY_STEPS
    assert np.all(np.isfinite(traj["2"]))
    assert not torch.distributed.is_initialized()
    with open(tmp_path / "scaling.json") as f:
        assert set(json.load(f)) >= {
            "backend", "note", "per_device_batch", "throughput",
            "objf_parity_10step_max_abs_delta"}


# ---- bench_dense_den ----

def test_dense_den_keys_and_plain_logz_equal_the_reference(tmp_path):
    """The tool's random den at a small size: its plain scan's logZ equals
    the reference's XLA ``forward_score`` on the same draws, and the
    kernel pair (plain versions here) agrees with it."""
    import jax.numpy as jnp
    from tdnnf_nas_tpu.ops.fwdbwd import forward_score as jforward

    sizes = (2, 6, 40, 50)
    res = bench_dense_den.run(str(tmp_path), sizes=sizes, n=1, rounds=2,
                              device="cpu")
    _timing_keys(res, ("plain_fwd", "kernel_fwd", "plain_fwd_grad",
                       "kernel_fwd_grad"))
    assert res["fwd_rel_err"] <= 1e-5 and res["grad_max_abs_err"] <= 1e-5
    b, t, s, p = sizes
    *graph, rng = bench_dense_den.random_den(s, p)
    obs = rng.randn(b, t, p).astype(np.float32)
    want = np.asarray(jforward(jnp.asarray(obs), *map(jnp.asarray, graph),
                               leaky_coef=0.1))
    from tdnnf_nas_torch.ops.fwdbwd import forward_score

    got = forward_score(torch.from_numpy(obs),
                        *[torch.from_numpy(a) for a in graph],
                        leaky_coef=0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (tmp_path / "bench_dense_den.json").exists()
