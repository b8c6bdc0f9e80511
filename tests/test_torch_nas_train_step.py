"""Port's supernet train and valid steps, ``train_model``, the two search
pipelines, the ``nas/search.py`` copy and the metrics logger vs the JAX
package (float32, CPU).

The small dense biphone setup of tests/test_torch_dense_train_step.py
(32 utterances, 6 phones, ``BiphoneTree(6)``, the 48-state dense den) and
the small supernet of tests/test_scan_supernet.py (3 layers of width 16,
K = 3 offsets, or bottleneck groups (2, 2)), chunk width 16, batch 4.
The JAX steps take ``pallas_den=False`` (its XLA ``forward_score``); the
port's dense den scans through its kernels' dispatch (plain on the CPU).
Each JAX step's draws are derived from its own keys (``trainer.py:198``)
and injected through the port's noise seam.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import data as jdata
from tdnnf_nas_tpu import models as jmodels
from tdnnf_nas_tpu import nas as jsearch
from tdnnf_nas_tpu import train as jtrain
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import data as tdata
from tdnnf_nas_torch import models as tmodels
from tdnnf_nas_torch import nas as tsearch
from tdnnf_nas_torch import train as ttrain
from tests.test_torch_dense_train_step import _build
from tests.test_torch_nas import injected, jax_draws

torch.set_num_threads(1)

_SUPERNETS = {
    "offsets": dict(search_offsets=True, max_stride=2),
    "bottleneck": dict(search_offsets=False, search_bottleneck=True,
                       bottleneck_groups=(2, 2)),
}


def _cfgs(pkg_models, num_pdfs, which):
    base = pkg_models.TdnnfModelConfig(
        feat_dim=12, ivector_dim=0, hidden_dim=16, bottleneck_dim=4,
        time_strides=(1, 1, 1), num_pdfs=num_pdfs, prefinal_big=16,
        prefinal_small=8, compute_dtype="float32")
    return pkg_models.DartsModelConfig(base=base, **_SUPERNETS[which])


@pytest.fixture(scope="module")
def setup():
    jbundle, _, _ = _build("jax")
    tbundle, _, _ = _build("torch")
    out = dict(jbundle=jbundle, tbundle=tbundle, cfg={}, batch={})
    p = jbundle.tree.num_pdfs
    for which in _SUPERNETS:
        jc, tc = _cfgs(jmodels, p, which), _cfgs(tmodels, p, which)
        batches = []
        for bundle, cfg, data in ((jbundle, jc, jdata), (tbundle, tc, tdata)):
            chunks = bundle.egs(None, chunk_width=16, max_phones_per_chunk=12,
                                supernet_cfg=cfg)
            batches.append(next(data.batch_iterator(
                chunks, batch_size=4, rng=np.random.RandomState(0))))
        np.testing.assert_array_equal(batches[0]["feats"], batches[1]["feats"])
        out["cfg"][which] = (jc, tc)
        out["batch"][which] = (jax.tree.map(jnp.asarray, batches[0]),
                               convert.batch_to_torch(batches[1],
                                                      device="cpu"))
    return out


def _jax_state(jc, jtc, seed=2):
    """JAX supernet state with seeded output layers x0.1, so that no
    gradient is degenerate (as tests/test_scan_supernet.py:73)."""
    st = jtrain.init_train_state(jc, jtc, jax.random.PRNGKey(seed),
                                 supernet=True)
    rng = np.random.RandomState(seed)
    params = dict(st.params)
    for head in ("chain", "xent"):
        out = params[f"output_{head}"]
        params[f"output_{head}"] = dict(out, w=jnp.asarray(
            rng.randn(*out["w"].shape).astype(np.float32) * 0.1))
    return dataclasses.replace(st, params=params)


def _port_state(jst):
    return convert.supernet_state_from_numpy(
        *(jax.tree.map(np.asarray, t) for t in (
            jst.params, jst.alphas, jst.bn_state, jst.opt_state,
            jst.alpha_opt_state)), int(jst.step), device="cpu")


def _run_both(jc, tc, jtc, ttc, jst, tst, den_pair, batch_pair, n):
    """n steps of each package on one batch, JAX's draws injected into the
    port; returns both final states and both metric lists."""
    jden, tden = den_pair
    jbatch, tbatch = batch_pair
    key = jax.random.PRNGKey(3)
    jstep = jtrain.make_train_step(jc, jtc, jden, supernet=True, donate=False)
    tstep = ttrain.make_train_step(tc, ttc, tden, supernet=True,
                                   generator=torch.Generator())
    jms, tms = [], []
    for _ in range(n):
        step_key = jax.random.fold_in(key, jst.step)
        k_model, k_drop = jax.random.split(step_key)
        p = ttrain.trainer._dropout_at(tst.step, ttc,
                                       ttc.optimizer.num_steps) or 0.0
        draws = jax_draws(jc, jtc.search_mode, k_model, 4, k_drop, p)
        jst, jm = jstep(jst, jbatch, key)
        with injected(draws):
            tst, tm = tstep(tst, tbatch)
        jms.append(jm)
        tms.append(tm)
    return jst, tst, jms, tms


def _check_metrics(jms, tms):
    for jm, tm in zip(jms, tms):
        assert set(jm) == set(tm), (sorted(jm), sorted(tm))
        assert abs(float(tm["objf_mmi"]) - float(jm["objf_mmi"])) < 5e-4
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


_STAGE_B = {
    "offsets": dict(alpha_entropy_coef=0.01),
    "bottleneck": dict(flops_coef=1e-3),
}


@pytest.mark.parametrize("which", sorted(_SUPERNETS))
def test_two_stage_steps_match_jax(setup, which):
    """Stage A (uniform sampling, theta only, a dropout schedule) then
    stage B (gumbel, alpha only, theta and BN frozen, carrying stage A's
    step counter, with the entropy or the FLOPs term), 3 steps each:
    objf_mmi within 5e-4 per step (__graft_entry__.py:119), every metric
    within 1e-3, alphas within 1e-4 after stage B, and stage B leaves
    params and BN stats unchanged bit for bit."""
    jc, tc = setup["cfg"][which]
    dens = (setup["jbundle"].den_arrays, setup["tbundle"].den_arrays)
    opt_a = dict(lr_initial=2e-3, lr_final=1e-3, num_steps=6)
    opt_b = dict(lr_initial=1e-2, lr_final=3e-3, num_steps=6,
                 alpha_lr_scale=2.0)
    sched = ((0.0, 0.0), (0.5, 0.2), (1.0, 0.0))
    stages = [
        dict(search_mode="uniform", dropout_schedule=sched, opt=opt_a),
        dict(search_mode="gumbel", train_theta=False, train_alpha=True,
             bn_frozen=True, opt=opt_b, **_STAGE_B[which]),
    ]
    jst = tst = None
    for stage in stages:
        kw = dict(stage)
        opt = kw.pop("opt")
        jtc = jtrain.TrainerConfig(optimizer=jtrain.OptimizerConfig(**opt),
                                   **kw)
        ttc = ttrain.TrainerConfig(optimizer=ttrain.OptimizerConfig(**opt),
                                   **kw)
        if jst is None:
            jst = _jax_state(jc, jtc)
            tst = _port_state(jst)
        t_before = tst
        jst, tst, jms, tms = _run_both(jc, tc, jtc, ttc, jst, tst, dens,
                                       setup["batch"][which], 3)
        _check_metrics(jms, tms)
    assert tst.step == int(jst.step) == 6
    for name, a in tst.alphas.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(jst.alphas[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
        assert float((a - t_before.alphas[name]).abs().max()) > 1e-4, name
    paths = ttrain.optimizer.tree_paths
    for (_, x), (_, y) in zip(paths(t_before.params), paths(tst.params)):
        assert torch.equal(x, y)
    for name, st in t_before.bn_state.items():
        for f in ("mean", "var"):
            assert torch.equal(st[f], tst.bn_state[name][f])


def test_valid_step_matches_jax(setup):
    """``make_valid_step``: a supernet in softmax at tau_min (search mode
    gumbel), eval-mode BN, on alphas and BN stats away from their init."""
    jc, tc = setup["cfg"]["offsets"]
    jtc = jtrain.TrainerConfig(search_mode="gumbel")
    ttc = ttrain.TrainerConfig(search_mode="gumbel")
    jst = _jax_state(jc, jtc)
    rng = np.random.RandomState(4)
    jst = dataclasses.replace(
        jst,
        alphas=jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)), jst.alphas),
        bn_state=jax.tree.map(lambda a: a + jnp.asarray(
            rng.rand(*a.shape).astype(np.float32) * 0.1), jst.bn_state))
    jbatch, tbatch = setup["batch"]["offsets"]
    jm = jtrain.make_valid_step(jc, jtc, setup["jbundle"].den_arrays,
                                supernet=True)(jst, jbatch)
    tm = ttrain.make_valid_step(tc, ttc, setup["tbundle"].den_arrays,
                                supernet=True)(_port_state(jst), tbatch)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_train_model_softmax_matches_jax(setup):
    """``train_model`` in softmax mode (no sampling), theta and alphas
    trained, 3 steps from the same state: the same batches in the same
    order (``RandomState(seed)``), objf_mmi within 5e-4 per step, alphas
    within 1e-4 after."""
    from tdnnf_nas_tpu.recipes.chain_recipes import train_model as jtm
    from tdnnf_nas_torch.recipes.chain_recipes import train_model as ttm

    jc, tc = setup["cfg"]["offsets"]
    opt = dict(lr_initial=3e-3, lr_final=1e-3, num_steps=10)
    jtc = jtrain.TrainerConfig(search_mode="softmax", train_alpha=True,
                               optimizer=jtrain.OptimizerConfig(**opt))
    ttc = ttrain.TrainerConfig(search_mode="softmax", train_alpha=True,
                               optimizer=ttrain.OptimizerConfig(**opt))
    jst = _jax_state(jc, jtc)
    kw = dict(batch_size=4, chunk_width=16, seed=5, supernet=True)
    jst, jlog = jtm(setup["jbundle"], jc, jtc, 3, init_state=jst, prefetch=0,
                    **kw)
    tst, tlog = ttm(setup["tbundle"], tc, ttc, 3,
                    init_state=_port_state(_jax_state(jc, jtc)),
                    device="cpu", **kw)
    jo = [v for _, v in jlog.series["objf_mmi"]]
    to = [v for _, v in tlog.series["objf_mmi"]]
    assert len(to) == len(jo) == 3
    assert max(abs(a - b) for a, b in zip(jo, to)) < 5e-4, (jo, to)
    for name, a in tst.alphas.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(jst.alphas[name]),
                                   rtol=0, atol=1e-4, err_msg=name)
    assert tlog.last("tau") == pytest.approx(jlog.last("tau"), rel=1e-6)


@pytest.mark.parametrize("step", [0, 1, 7, 20])
def test_schedules_match_jax(step):
    """Temperature and dropout proportion as host floats, equal to the
    reference's float32 values."""
    from tdnnf_nas_tpu.train import trainer as jtr
    from tdnnf_nas_torch.train import trainer as ttr

    kw = dict(tau_max=1.5, tau_min=0.05,
              dropout_schedule=((0.0, 0.0), (0.2, 0.0), (0.5, 0.5),
                                (1.0, 0.1)))
    jc, tc = jtrain.TrainerConfig(**kw), ttrain.TrainerConfig(**kw)
    s = jnp.asarray(step, jnp.int32)
    assert ttr._tau_at(step, tc, 17) == float(jtr._tau_at(s, jc, 17))
    assert ttr._dropout_at(step, tc, 17) == pytest.approx(
        float(jtr._dropout_at(s, jc, 17)), abs=1e-7)
    assert ttr._dropout_at(step, ttrain.TrainerConfig(), 17) is None


def test_supernet_state_round_trip():
    """JAX supernet TrainState -> port -> numpy, array for array."""
    jc = _cfgs(jmodels, 12, "offsets").replace(search_bottleneck=True,
                                                 bottleneck_groups=(2, 2))
    jst = _jax_state(jc, jtrain.TrainerConfig())
    rng = np.random.RandomState(6)
    jst = dataclasses.replace(
        jst, step=jnp.asarray(5, jnp.int32),
        alpha_opt_state=jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)), jst.alpha_opt_state))
    out = convert.supernet_state_to_numpy(_port_state(jst))
    ref = (jst.params, jst.alphas, jst.bn_state, jst.opt_state,
           jst.alpha_opt_state)
    for a, b in zip(out[:5], ref):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert jax.tree.structure(a) == jax.tree.structure(
            jax.tree.map(np.asarray, b))
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert out[5] == 5
    assert set(out[1]) == {"offsets_linear", "offsets_affine", "bottleneck"}


def test_search_copy_equals_original():
    """nas/search.py's numpy copy gives the original's outputs exactly."""
    rng = np.random.RandomState(7)
    lin, aff = rng.randn(4, 3), rng.randn(4, 3)
    bott = rng.randn(4, 5)
    for f in (0.0, 0.3, 1.0, 1.7):
        assert tsearch.temperature_at(f, 1.2, 0.1) == jsearch.temperature_at(
            f, 1.2, 0.1)
    assert (tsearch.beam_search_archs(lin, beam=3, top_k=4)
            == jsearch.beam_search_archs(lin, beam=3, top_k=4))
    t_off = tsearch.extract_offsets(lin, aff, top_k=3)
    assert t_off == jsearch.extract_offsets(lin, aff, top_k=3)
    cands = (25, 50, 80, 100, 120)
    t_bn = tsearch.extract_bottlenecks(bott, cands, top_k=2)
    assert t_bn == jsearch.extract_bottlenecks(bott, cands, top_k=2)
    tbase = tmodels.TdnnfModelConfig(num_pdfs=40, time_strides=(1, 1, 3, 3))
    jbase = jmodels.TdnnfModelConfig(num_pdfs=40, time_strides=(1, 1, 3, 3))
    tchild = tsearch.child_config_from_arch(tbase, t_off[0][0], t_bn[0][0])
    jchild = jsearch.child_config_from_arch(jbase, t_off[0][0], t_bn[0][0])
    assert dataclasses.asdict(tchild) == dataclasses.asdict(jchild)
    assert tsearch.arch_param_count(tchild) == jsearch.arch_param_count(
        jchild)
    assert tsearch.arch_param_count(tchild) == tmodels.count_params(
        tmodels.init_model(tchild, torch.Generator().manual_seed(0),
                           device="cpu")[0])


def test_metrics_logger_matches_jax(tmp_path):
    """Deferred logging of device tensors and host floats: the same
    series, last values, report and JSONL records as the JAX logger."""
    from tdnnf_nas_tpu.core.metrics import MetricsLogger as JLog
    from tdnnf_nas_torch.core.metrics import MetricsLogger as TLog

    jl = JLog(str(tmp_path / "j.jsonl"), flush_every=3)
    tl = TLog(str(tmp_path / "t.jsonl"), flush_every=3)
    for i in range(5):
        m = {"objf": np.float32(0.25 * i - 1.0), "tau": 1.0 - 0.1 * i}
        if i % 2:
            m["extra"] = np.float32(i)
        jl.log(i, {k: jnp.asarray(v) if k != "tau" else v
                   for k, v in m.items()})
        tl.log(i, {k: torch.tensor(v) if k != "tau" else v
                   for k, v in m.items()})
    assert tl.series == jl.series
    assert tl.last("objf") == jl.last("objf")
    assert tl.report() == jl.report()
    jl.close()
    tl.close()
    import json
    strip = lambda path: [{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in open(path)]
    assert strip(tmp_path / "t.jsonl") == strip(tmp_path / "j.jsonl")


# ------------------------------------------------ the pipelines, miniature

@pytest.fixture(scope="module")
def mini_bundle():
    """tests/test_nas_pipeline.py's corpus through the port's host code."""
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.recipes import prepare_data

    cfg = SyntheticCorpusConfig(num_utts=40, num_phones=5, feat_dim=10,
                                min_phones=5, max_phones=14, seed=3)
    utts, phone_seqs, tree, topo = make_synthetic_corpus(cfg)
    return prepare_data(utts, phone_seqs, tree, topo, cfg.num_phones,
                        dev_fraction=0.2)


_MINI_BASE = dict(feat_dim=10, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
                  time_strides=(1, 2), num_pdfs=10, prefinal_big=24,
                  prefinal_small=12, compute_dtype="float32")
_MINI_TKW = dict(optimizer=ttrain.OptimizerConfig(
    kind="adam", lr_initial=2e-3, lr_final=1e-3, num_steps=40,
    alpha_lr_scale=5.0))


def test_offset_search_pipeline(mini_bundle):
    """The behaviours tests/test_nas_pipeline.py checks of the reference:
    alphas moved in the cv-update, archs in range, the child learns."""
    from tdnnf_nas_torch.recipes import run_offset_search_pipeline

    res = run_offset_search_pipeline(
        mini_bundle, tmodels.TdnnfModelConfig(**_MINI_BASE), max_stride=2,
        pretrain_steps=14, cvupdate_steps=12, child_steps=14, batch_size=4,
        chunk_width=14, trainer_kw=_MINI_TKW, device="cpu")
    a = res["supernet_state"].alphas["offsets_linear"]
    assert float(a.abs().max()) > 1e-4
    pairs, _ = res["archs"][0]
    assert len(pairs) == 2 and all(0 <= x <= 2 for pr in pairs for x in pr)
    child = res["children"][0]
    assert np.isfinite(child["metrics"].last("objf_mmi"))
    first = child["metrics"].series["objf_mmi"][0][1]
    assert child["metrics"].last("objf_mmi") > first
    # stage B carried stage A's step counter (the reference's behaviour)
    assert res["supernet_state"].step == 14 + 12


def test_bottleneck_search_pipeline(mini_bundle):
    from tdnnf_nas_torch.recipes import run_bottleneck_search_pipeline

    res = run_bottleneck_search_pipeline(
        mini_bundle, tmodels.TdnnfModelConfig(**_MINI_BASE),
        bottleneck_groups=(4, 4, 8), pretrain_steps=12, cvupdate_steps=10,
        child_steps=12, flops_coef=1e-4, batch_size=4, chunk_width=14,
        trainer_kw=_MINI_TKW, device="cpu")
    dims, _ = res["archs"][0]
    assert len(dims) == 2 and all(d in (4, 8, 16) for d in dims)
    assert res["child_cfg"].bottleneck_dims == dims
    assert np.isfinite(res["child_metrics"].last("objf_mmi"))
    assert np.isfinite(res["cvupdate_metrics"].last("expected_bottleneck"))
