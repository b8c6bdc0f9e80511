"""Port's host setup and train step vs the JAX package (float32, CPU).

The small composed-den setup of ``__graft_entry__.dryrun_multichip``: a
32-utterance synthetic corpus, a 20-leaf left-2 triphone tree, a 4-gram
phone LM with 40 extra states, the blocked den export, chunk width 16.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph

torch.set_num_threads(1)

_MODEL = dict(feat_dim=12, ivector_dim=0, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 3), prefinal_big=32, prefinal_small=16,
              compute_dtype="float32")


def _build(pkg):
    """(bundle, model_cfg, batch) through one package's host modules."""
    if pkg == "jax":
        from tdnnf_nas_tpu import data, graphs, models
        from tdnnf_nas_tpu.recipes.chain_recipes import prepare_data
    else:
        from tdnnf_nas_torch import data, graphs, models
        from tdnnf_nas_torch.recipes.chain_recipes import prepare_data
    corpus_cfg = data.SyntheticCorpusConfig(num_utts=32, num_phones=6,
                                            feat_dim=12)
    utts, phone_seqs, _, topo = data.make_synthetic_corpus(corpus_cfg)
    stats = graphs.accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts], 6,
        corpus_cfg.frame_subsampling_factor)
    tree = graphs.build_clustered_triphone_tree(stats, num_leaves=20)
    bundle = prepare_data(utts, phone_seqs, tree, topo, 6, phone_lm_order=4,
                          num_extra_lm_states=40)
    model_cfg = models.TdnnfModelConfig(num_pdfs=tree.num_pdfs, **_MODEL)
    chunks = bundle.egs(model_cfg, chunk_width=16, max_phones_per_chunk=12)
    batch = next(data.batch_iterator(chunks, batch_size=4,
                                     rng=np.random.RandomState(0)))
    return bundle, model_cfg, batch


@pytest.fixture(scope="module")
def setup():
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_tpu.train import init_train_state as jinit
    from tdnnf_nas_tpu.train import make_train_step as jmake
    from tdnnf_nas_torch.train import TrainerConfig

    jbundle, jcfg, jbatch = _build("jax")
    tbundle, tcfg, tbatch = _build("torch")
    jtc = JTrainerConfig()
    jstate = jinit(jcfg, jtc, jax.random.PRNGKey(2))
    # one jitted JAX step for both step tests (compiled once)
    jstep = jmake(jcfg, jtc, jbundle.den_arrays, donate=False)
    return dict(jbundle=jbundle, jcfg=jcfg, jbatch=jbatch, tbundle=tbundle,
                tcfg=tcfg, tbatch=tbatch, jstate=jstate, jstep=jstep,
                jtc=jtc, ttc=TrainerConfig())


def _port_state(jstate):
    return convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state),
        jax.tree.map(np.asarray, jstate.opt_state), int(jstate.step))


def _port_step(s):
    from tdnnf_nas_torch.train import make_train_step

    den = BlockedDenGraph.from_host(s["tbundle"].den_arrays, "cpu")
    return make_train_step(s["tcfg"], s["ttc"], den)


def test_host_batches_identical(setup):
    """Same seed -> the port's corpus, tree, LM, den export and egs give
    the JAX package's batch array for array."""
    jb, tb = setup["jbatch"], setup["tbatch"]
    np.testing.assert_array_equal(tb["feats"], jb["feats"])
    assert "ivectors" not in tb and "ivectors" not in jb
    for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
        a, b = getattr(tb["sup"], f), getattr(jb["sup"], f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tb["sup"].self_loop_prob == jb["sup"].self_loop_prob
    jd, td = setup["jbundle"].den_arrays, setup["tbundle"].den_arrays
    assert jd.bcast_sel is None and td.bcast_sel is None
    assert td.w_blocks.shape == tuple(jd.w_blocks.shape) == (1, 53, 265)
    assert td.num_states == jd.num_states == 116
    for f in ("w_blocks", "perm", "perm_inv", "init_pos", "pdf_virtual",
              "init_virtual", "final_virtual"):
        np.testing.assert_array_equal(getattr(td, f),
                                      np.asarray(getattr(jd, f)), err_msg=f)


def test_one_step_matches_jax(setup):
    """Loss and per-leaf gradients, then the updated params and BN state
    of one full step, against the JAX package in float32."""
    from tdnnf_nas_tpu.models import tdnnf as jmodel
    from tdnnf_nas_tpu.train.objective import chain_objective as jobj
    from tdnnf_nas_torch.models import tdnnf as tmodel
    from tdnnf_nas_torch.train.objective import chain_objective as tobj
    from tdnnf_nas_torch.train.optimizer import tree_paths, tree_unflatten

    s = setup
    jstate = s["jstate"]
    jbatch_dev = jax.tree.map(jnp.asarray, s["jbatch"])
    jden = s["jbundle"].den_arrays

    def jloss(params):
        c, x, _ = jmodel.apply_model(s["jcfg"], params, jstate.bn_state,
                                     jbatch_dev["feats"], None, train=True)
        return jobj(c, x, jden, jbatch_dev["sup"], s["jtc"].objective)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jstate.params)

    tstate = _port_state(jstate)
    tbatch = convert.batch_to_torch(s["tbatch"])
    tden = BlockedDenGraph.from_host(s["tbundle"].den_arrays, "cpu")
    pl = tree_paths(tstate.params)
    leaves = [x.clone().requires_grad_(True) for _, x in pl]
    params = tree_unflatten([(p, x) for (p, _), x in zip(pl, leaves)])
    c, x, _ = tmodel.apply_model(s["tcfg"], params, tstate.bn_state,
                                 tbatch["feats"], None, train=True)
    tl, _ = tobj(c, x, tden, tbatch["sup"], s["ttc"].objective)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    jg_leaves = jax.tree_util.tree_leaves(jg)  # sorted keys, like tree_paths
    assert len(jg_leaves) == len(tg)
    for (path, _), a, b in zip(pl, tg, jg_leaves):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * scale,
                                   err_msg="/".join(path))

    jnew, jm = s["jstep"](jstate, jbatch_dev, jax.random.PRNGKey(3))
    tnew, tm = _port_step(s)(_port_state(jstate), tbatch)
    for k in ("objf_mmi", "loss", "logz_num", "logz_den", "objf_xent",
              "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    jp = jax.tree.map(np.asarray, jnew.params)
    tparams, tbn, topt, tstep = convert.train_state_to_numpy(tnew)
    assert tstep == 1 and set(topt) == {"m", "v"}
    for (path, x), g in zip(tree_paths(tparams), jg_leaves):
        ref = jp
        for k in path:
            ref = ref[k]
        g = np.abs(np.asarray(g))
        # Adam's first step moves a weight by lr * g / (|g| + eps): about
        # lr * sign(g) wherever |g| >> eps.  Where the gradient is float32
        # rounding noise (below the 1e-4 * max|g| bar it was held to above,
        # e.g. xent-output columns of pdfs no frame visits) its sign is
        # arbitrary, so there the two steps may differ by up to 2 * lr;
        # elsewhere the bar is a hundredth of lr = 1e-3.
        sig = g > 1e-4 * max(float(g.max()), 1e-6)
        np.testing.assert_allclose(x[sig], ref[sig], atol=1e-5,
                                   err_msg="/".join(path))
        np.testing.assert_allclose(x, ref, atol=2e-3 + 1e-5,
                                   err_msg="/".join(path))
    for name, st in jax.tree.map(np.asarray, jnew.bn_state).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(tbn[name][k], st[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name}/{k}")


def test_objf_trajectory_matches_jax(setup):
    """12 steps on the same batch: objf_mmi within 5e-4 of the JAX
    package at every step (the bar of __graft_entry__.py:119)."""
    s = setup
    jstep = s["jstep"]
    jbatch_dev = jax.tree.map(jnp.asarray, s["jbatch"])
    tstep = _port_step(s)
    tbatch = convert.batch_to_torch(s["tbatch"])
    jst, tst = s["jstate"], _port_state(s["jstate"])
    jtraj, ttraj = [], []
    for _ in range(12):
        jst, jm = jstep(jst, jbatch_dev, jax.random.PRNGKey(3))
        tst, tm = tstep(tst, tbatch)
        jtraj.append(float(jm["objf_mmi"]))
        ttraj.append(float(tm["objf_mmi"]))
    assert all(np.isfinite(ttraj)), ttraj
    assert ttraj[-1] > ttraj[0], ttraj  # it learns
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 5e-4, (delta, jtraj, ttraj)
