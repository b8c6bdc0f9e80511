"""The position-factored denominator of the port against the JAX package
on the CPU: ``CompiledDenFsa.to_factored``'s arrays, ``forward_score_
factored``'s logZ and obs gradient in each of its two forms (dense
``trans_pos``, the arc-list segment sums, against the reference's padded
gather), the
``prepare_data`` fallback when ``to_blocked`` refuses a den, and
``chain_objective`` and 12 train steps on a factored den.

Dens: the trigram x left-biphone den and the trigram x left-2 triphone
den of tests/test_ngram_den.py:103-146,290-330, and the committed +-1
den with its wildcard positions of tests/test_torch_cross_triphone.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import graphs as jgraphs
from tdnnf_nas_tpu.data import synthetic as jsyn
from tdnnf_nas_tpu.graphs import den_graph as jden
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.data import synthetic as tsyn
from tdnnf_nas_torch.graphs import den_graph as tden
from tdnnf_nas_torch.ops import fwdbwd as tfwd
from tests.test_torch_cross_triphone import P as PM1_PHONES
from tests.test_torch_cross_triphone import _corpus as pm1_corpus

torch.set_num_threads(1)

_FACTORED = ("seg_bounds", "state_pdf", "init", "final", "trans_pos",
             "pdf_perm", "pdf_bounds")
# the forms of the port's scan and the export budgets that select them
_FORMS = {"dense": {}, "arcs": dict(dense_budget=0)}


def _assert_in_arcs_equal(tg, jg):
    """The port's destination-sorted arc list holds the reference's padded
    [S, K] in-arc tables ``in_pos``/``in_w`` row by row: state s's arcs
    are its row's first in-degree(s) entries, the rest zero padding."""
    s, k = tg.num_states, tg.max_in_degree
    dst = np.repeat(np.arange(s), np.diff(tg.dst_bounds))
    rank = np.arange(tg.num_arcs) - tg.dst_bounds[dst]
    in_pos = np.zeros((s, k), np.int32)
    in_w = np.zeros((s, k), np.float32)
    in_pos[dst, rank] = tg.arc_src_pos
    in_w[dst, rank] = tg.arc_w
    np.testing.assert_array_equal(in_pos, np.asarray(jg.in_pos))
    np.testing.assert_array_equal(in_w, np.asarray(jg.in_w))


def _seqs(p, n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, p, rng.randint(3, 12)).tolist() for _ in range(n)]


def _biphone(g):
    p = 5
    lm = g.estimate_ngram_phone_lm(_seqs(p, seed=2), p, order=3,
                                   num_extra_lm_states=20)
    return g.compile_denominator_fsa(lm, g.ChainTopology(p), g.BiphoneTree(p))


def _triphone(g, syn):
    cfg = syn.SyntheticCorpusConfig(num_phones=5, num_utts=24, feat_dim=6)
    utts, phone_seqs, _, topo = syn.make_synthetic_corpus(cfg)
    stats = g.accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        cfg.num_phones, cfg.frame_subsampling_factor)
    tree = g.build_clustered_triphone_tree(stats, num_leaves=30)
    lm = g.estimate_ngram_phone_lm(phone_seqs, cfg.num_phones, order=3,
                                   num_extra_lm_states=25)
    return g.compile_denominator_fsa(lm, topo, tree)


def _pm1(g):
    seqs, feats, begins = pm1_corpus()
    stats = g.accumulate_cross_triphone_stats(feats, seqs, begins,
                                              PM1_PHONES, 1)
    tree = g.build_clustered_cross_triphone_tree(stats, num_leaves=30)
    lm = g.estimate_ngram_phone_lm(seqs, PM1_PHONES, order=4,
                                   num_extra_lm_states=20)
    return g.compile_denominator_fsa(lm, g.ChainTopology(PM1_PHONES), tree)


@pytest.fixture(scope="module")
def dens():
    """{name: (JAX CompiledDenFsa, port CompiledDenFsa)}."""
    out = {"biphone": (_biphone(jgraphs), _biphone(tgraphs)),
           "triphone": (_triphone(jgraphs, jsyn), _triphone(tgraphs, tsyn)),
           "pm1": (_pm1(jgraphs), _pm1(tgraphs))}
    assert out["pm1"][1].committed and out["pm1"][1].wildcard_positions
    return out


@pytest.mark.parametrize("name", ["biphone", "triphone", "pm1"])
def test_to_factored_equals_jax(dens, name):
    """Every array of the reference's export, the dense trans_pos (its
    bf16 hi/lo split is not kept) included, and its padded in-arc tables
    in the arc list, sorted by destination with per-state offsets."""
    jf, tf = dens[name]
    jg, tg = jf.to_factored(), tf.to_factored()
    for f in _FACTORED:
        np.testing.assert_array_equal(getattr(tg, f),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert tg.trans_pos is not None
    _assert_in_arcs_equal(tg, jg)
    order = np.argsort(tf.arc_dst, kind="stable")
    np.testing.assert_array_equal(tg.arc_src_pos, tf.arc_src_pos[order])
    np.testing.assert_array_equal(tg.arc_w, tf.arc_w[order])
    assert tg.dst_bounds[-1] == tg.num_arcs == len(tf.arc_dst)
    np.testing.assert_array_equal(np.diff(tg.dst_bounds),
                                  np.bincount(tf.arc_dst,
                                              minlength=tf.num_states))
    assert tg.max_in_degree == np.asarray(jg.in_pos).shape[1]


def test_budgets_drop_the_big_tables(dens):
    """Over its budget trans_pos is not built, on the host or the device,
    and no [S, K] table is, in either form; the device copy names the
    form the scan takes."""
    _, tf = dens["pm1"]
    for form, kw in _FORMS.items():
        host = tf.to_factored(**kw)
        dev = tfwd.FactoredDenGraph.from_host(host, "cpu")
        assert dev.form == form
        assert (host.trans_pos is None) == (form != "dense")
        assert (dev.trans_pos is None) == (host.trans_pos is None)
        s_k = host.num_states * host.max_in_degree
        for v in vars(host).values():
            if isinstance(v, np.ndarray) and v is not host.trans_pos:
                assert v.size < s_k


def _jax_strict(jf):
    """The reference's factored den with its float32 gather form (the
    dense form's bf16 hi/lo products are a TPU device choice)."""
    return dataclasses.replace(jf.to_factored(), trans_pos=None,
                               trans_pos_hi=None, trans_pos_lo=None)


def _obs(num_pdfs, b=3, t=10, seed=1):
    return (np.random.RandomState(seed).randn(b, t, num_pdfs) * 2.0
            ).astype(np.float32)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("name", ["biphone", "triphone", "pm1"])
def test_forward_score_factored_matches_jax(dens, name, form, leaky):
    """logZ and d(sum logZ)/d obs against the reference's float32 scan,
    both at atol 2e-5 (the blocked den's bar,
    tests/test_pallas_fwdbwd.py:102,108)."""
    jf, tf = dens[name]
    obs = _obs(tf.num_pdfs)
    jg = _jax_strict(jf)
    jz, jgrad = jax.value_and_grad(
        lambda o: jnp.sum(jfwd.forward_score_factored(o, jg, leaky)))(
        jnp.asarray(obs))
    jlogz = jfwd.forward_score_factored(jnp.asarray(obs), jg, leaky)
    tg = tfwd.FactoredDenGraph.from_host(tf.to_factored(**_FORMS[form]),
                                         "cpu")
    assert tg.form == form
    o = torch.from_numpy(obs).requires_grad_(True)
    tz = tfwd.forward_score_factored(o, tg, leaky)
    tgrad, = torch.autograd.grad(tz.sum(), o)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jlogz),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=2e-5)


def test_factored_scan_repeats_and_matches_dense(dens):
    """Two runs of each form are equal bit for bit, and each form's logZ
    equals the dense [S, S] scan of the same den (rtol 1e-5)."""
    _, tf = dens["pm1"]
    sg = tf.to_state_graph()
    obs = torch.from_numpy(_obs(tf.num_pdfs, seed=4))
    zd = tfwd.forward_score(obs, torch.from_numpy(sg.trans),
                            torch.from_numpy(sg.state_pdf).long(),
                            torch.from_numpy(sg.init),
                            torch.from_numpy(sg.final), leaky_coef=0.1)
    for kw in _FORMS.values():
        g = tfwd.FactoredDenGraph.from_host(tf.to_factored(**kw), "cpu")
        runs = []
        for _ in range(2):
            o = obs.clone().requires_grad_(True)
            z = tfwd.forward_score_factored(o, g, 0.1)
            runs.append((z.detach(), torch.autograd.grad(z.sum(), o)[0]))
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        np.testing.assert_allclose(runs[0][0].numpy(), zd.numpy(),
                                   rtol=1e-5)


_MODEL = dict(feat_dim=12, ivector_dim=0, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 3), prefinal_big=32, prefinal_small=16,
              compute_dtype="float32")


def _refuse_blocked(monkeypatch, module):
    """to_blocked with a one-entry budget: it refuses every den."""
    monkeypatch.setattr(module.CompiledDenFsa, "to_blocked",
                        functools.partialmethod(
                            module.CompiledDenFsa.to_blocked,
                            budget_entries=1))


def _build(pkg):
    """(bundle, model_cfg, batches) of a +-1 tree, 4-gram LM, through one
    package's prepare_data."""
    if pkg == "jax":
        from tdnnf_nas_tpu import data, graphs, models
        from tdnnf_nas_tpu.recipes.chain_recipes import prepare_data
    else:
        from tdnnf_nas_torch import data, graphs, models
        from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    p = PM1_PHONES
    corpus_cfg = data.SyntheticCorpusConfig(num_utts=32, num_phones=p,
                                            feat_dim=12)
    utts, phone_seqs, _, topo = data.make_synthetic_corpus(corpus_cfg)
    stats = graphs.accumulate_cross_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts], p,
        corpus_cfg.frame_subsampling_factor)
    tree = graphs.build_clustered_cross_triphone_tree(stats, num_leaves=20)
    bundle = prepare_data(utts, phone_seqs, tree, topo, p, phone_lm_order=4,
                          num_extra_lm_states=40)
    model_cfg = models.TdnnfModelConfig(num_pdfs=tree.num_pdfs, **_MODEL)
    chunks = bundle.egs(model_cfg, chunk_width=16, max_phones_per_chunk=12)
    it = data.batch_iterator(chunks, batch_size=4,
                             rng=np.random.RandomState(0))
    return bundle, model_cfg, [next(it) for _ in range(3)]


@pytest.fixture(scope="module")
def refused():
    """Both packages' bundles with to_blocked refusing the den."""
    with pytest.MonkeyPatch.context() as mp:
        _refuse_blocked(mp, jden)
        _refuse_blocked(mp, tden)
        return _build("jax"), _build("torch")


def test_prepare_data_falls_back_to_factored(refused):
    """Both packages take the factored branch, with equal den arrays; the
    port's den_on_device moves it to the device form."""
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device

    (jb, _, _), (tb, _, _) = refused
    assert isinstance(jb.den_arrays, jfwd.FactoredDenGraph)
    assert isinstance(tb.den_arrays, tden.FactoredDenGraph)
    for f in _FACTORED:
        np.testing.assert_array_equal(getattr(tb.den_arrays, f),
                                      np.asarray(getattr(jb.den_arrays, f)),
                                      err_msg=f)
    _assert_in_arcs_equal(tb.den_arrays, jb.den_arrays)
    dev = den_on_device(tb, "cpu")
    assert isinstance(dev, tfwd.FactoredDenGraph) and dev.form == "dense"


def test_chain_objective_and_12_steps_match_jax(refused):
    """chain_objective on a factored den (every metric within 1e-5
    relative), then 12 float32 steps from the same state: objf_mmi within
    5e-4 of the JAX package's at every step (__graft_entry__.py:119)."""
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_tpu.train import init_train_state as jinit
    from tdnnf_nas_tpu.train import make_train_step as jmake
    from tdnnf_nas_tpu.train.objective import (ChainObjectiveConfig as JCfg,
                                               chain_objective as jobj)
    from tdnnf_nas_torch.train import TrainerConfig, make_train_step
    from tdnnf_nas_torch.train.objective import (ChainObjectiveConfig,
                                                 chain_objective)

    (jb, jcfg, jbatches), (tb, tcfg, tbatches) = refused
    tden_dev = tfwd.FactoredDenGraph.from_host(tb.den_arrays, "cpu")
    rng = np.random.RandomState(5)
    b, t = jbatches[0]["sup"].mask.shape[:2]
    out = (rng.randn(b, t, tcfg.num_pdfs) * 2).astype(np.float32)
    xent = rng.randn(b, t, tcfg.num_pdfs).astype(np.float32)
    jsup = jax.tree.map(jnp.asarray, jbatches[0]["sup"])
    _, jm = jobj(jnp.asarray(out), jnp.asarray(xent), jb.den_arrays, jsup,
                 JCfg())
    tsup = convert.batch_to_torch(tbatches[0], device="cpu")["sup"]
    _, tm = chain_objective(torch.from_numpy(out), torch.from_numpy(xent),
                            tden_dev, tsup, ChainObjectiveConfig())
    for k in ("objf_mmi", "logz_num", "logz_den", "objf_xent", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)

    jtc = JTrainerConfig()
    jst = jinit(jcfg, jtc, jax.random.PRNGKey(2))
    jstep = jmake(jcfg, jtc, jb.den_arrays, donate=False)
    tst = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jst.params),
        jax.tree.map(np.asarray, jst.bn_state),
        jax.tree.map(np.asarray, jst.opt_state), int(jst.step),
        device="cpu")
    tstep = make_train_step(tcfg, TrainerConfig(), tden_dev)
    jtraj, ttraj = [], []
    for i in range(12):
        jbd = jax.tree.map(jnp.asarray, jbatches[i % 3])
        tbd = convert.batch_to_torch(tbatches[i % 3], device="cpu")
        jst, jm = jstep(jst, jbd, jax.random.PRNGKey(3))
        tst, tm = tstep(tst, tbd)
        jtraj.append(float(jm["objf_mmi"]))
        ttraj.append(float(tm["objf_mmi"]))
    assert all(np.isfinite(ttraj)), ttraj
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 5e-4, (delta, jtraj, ttraj)


def test_segment_sums_across_chunks():
    """The blocked float64 cumsum behind the arc and position sums: runs
    that start and end on and across chunk edges, empty runs and a
    ragged tail equal the float64 sums of each run."""
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 5000)
                         .astype(np.float32))
    chunk = tfwd._SCAN_CHUNK
    bounds = torch.tensor([0, 0, 7, chunk - 1, chunk, chunk + 1, 3 * chunk,
                           4999, 4999])
    got = tfwd._segment_sums(x, bounds)
    want = torch.stack([x[:, bounds[i]:bounds[i + 1]].double().sum(dim=-1)
                        for i in range(len(bounds) - 1)], dim=-1).float()
    assert torch.equal(got, want)
