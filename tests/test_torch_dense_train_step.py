"""Port's dense-den host setup and train step vs the JAX package (float32,
CPU).

A small biphone setup: a 32-utterance synthetic corpus with 6 phones,
``BiphoneTree(6)``, the bigram phone LM (``phone_lm_order=2``), the dense
den graph (48 states), the small model of tests/test_torch_train_step.py
and chunk width 16.  The port's step takes the default objective config:
a dense den always scans through the dense-den kernels' dispatch (their
plain versions on the CPU).  The JAX step takes ``pallas_den=True``, its
Pallas kernels in interpret mode.
"""

from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
from tests.test_torch_train_step import _MODEL, _port_state

torch.set_num_threads(1)


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
    tree = graphs.BiphoneTree(6)
    bundle = prepare_data(utts, phone_seqs, tree, topo, 6, phone_lm_order=2)
    model_cfg = models.TdnnfModelConfig(num_pdfs=tree.num_pdfs, **_MODEL)
    chunks = bundle.egs(model_cfg, chunk_width=16, max_phones_per_chunk=12)
    batch = next(data.batch_iterator(chunks, batch_size=4,
                                     rng=np.random.RandomState(0)))
    return bundle, model_cfg, batch


@pytest.fixture(scope="module")
def setup():
    jbundle, jcfg, jbatch = _build("jax")
    tbundle, tcfg, tbatch = _build("torch")
    return dict(jbundle=jbundle, jcfg=jcfg, jbatch=jbatch, tbundle=tbundle,
                tcfg=tcfg, tbatch=tbatch)


def test_host_batches_identical(setup):
    """Same seed -> the port's corpus, bigram LM, dense den graph and egs
    give the JAX package's batch array for array, numerator init from the
    den graph's initial probs (den_init_fn) included."""
    jb, tb = setup["jbatch"], setup["tbatch"]
    np.testing.assert_array_equal(tb["feats"], jb["feats"])
    for f in ("trans", "state_pdf", "init", "final", "mask", "next_w"):
        a, b = getattr(tb["sup"], f), getattr(jb["sup"], f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # den_init_fn weights: not uniform over the allowed start states
    init = tb["sup"].init
    assert not all(np.allclose(row[row > 0], row[row > 0].max())
                   for row in init)
    jd, td = setup["jbundle"], setup["tbundle"]
    assert td.den_fsa is None and jd.den_fsa is None
    assert td.den.num_states == jd.den.num_states == 48
    for f in ("trans", "state_pdf", "init", "final"):
        np.testing.assert_array_equal(getattr(td.den, f),
                                      getattr(jd.den, f), err_msg=f)
    assert isinstance(td.den_arrays, DenGraphArrays)
    np.testing.assert_array_equal(td.den_arrays.trans_T.numpy(),
                                  np.asarray(jd.den_arrays.trans_T))


def test_objf_trajectory_matches_jax(setup):
    """3 float32 steps on the same batch (JAX with ``pallas_den=True``):
    objf_mmi within 5e-4 of the JAX package at every step (the bar of
    __graft_entry__.py:119)."""
    from jax.experimental.pallas import tpu as pltpu
    from tdnnf_nas_tpu.train import ChainObjectiveConfig as JObj
    from tdnnf_nas_tpu.train import TrainerConfig as JTrainerConfig
    from tdnnf_nas_tpu.train import init_train_state as jinit
    from tdnnf_nas_tpu.train import make_train_step as jmake
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.train import ChainObjectiveConfig, TrainerConfig
    from tdnnf_nas_torch.train import make_train_step

    s = setup
    jtc = JTrainerConfig(objective=JObj(pallas_den=True))
    ttc = TrainerConfig(objective=ChainObjectiveConfig())
    jst = jinit(s["jcfg"], jtc, jax.random.PRNGKey(2))
    tst = _port_state(jst)
    jbatch = jax.tree.map(jnp.asarray, s["jbatch"])
    tbatch = convert.batch_to_torch(s["tbatch"])
    tstep = make_train_step(s["tcfg"], ttc, s["tbundle"].den_arrays)
    before = ddc.dense_den_fwd_cuda.launches
    jtraj, ttraj = [], []
    with pltpu.force_tpu_interpret_mode():
        jstep = jmake(s["jcfg"], jtc, s["jbundle"].den_arrays, donate=False)
        for _ in range(3):
            jst, jm = jstep(jst, jbatch, jax.random.PRNGKey(3))
            jtraj.append(float(jm["objf_mmi"]))
    for _ in range(3):
        tst, tm = tstep(tst, tbatch)
        ttraj.append(float(tm["objf_mmi"]))
    assert ddc.dense_den_fwd_cuda.launches == before  # CPU: plain scans
    assert all(np.isfinite(ttraj)), ttraj
    delta = max(abs(a - b) for a, b in zip(jtraj, ttraj))
    assert delta < 5e-4, (delta, jtraj, ttraj)


@pytest.mark.parametrize("pallas_den", [False, True])
def test_dense_den_always_takes_kernel_dispatch(setup, pallas_den):
    """``pallas_den`` is accepted and ignored: on a dense den the objective
    scans through the dense-den kernels' dispatch (forward, then the
    adjoint in backward) either way, and its logZ_den agrees with the plain
    autograd ``forward_score`` within 1e-5 per frame."""
    from tdnnf_nas_torch.ops import dense_den_cuda as ddc
    from tdnnf_nas_torch.ops.fwdbwd import forward_score
    from tdnnf_nas_torch.train import ChainObjectiveConfig, chain_objective

    den = setup["tbundle"].den_arrays
    sup = convert.batch_to_torch(setup["tbatch"])["sup"]
    b, t, _ = sup.mask.shape
    rng = np.random.RandomState(4)
    p = setup["tcfg"].num_pdfs
    out = torch.tensor(rng.randn(b, t, p).astype(np.float32),
                       requires_grad=True)
    cfg = ChainObjectiveConfig(pallas_den=pallas_den)
    with mock.patch.object(ddc, "_scan_impl", wraps=ddc._scan_impl) as impl:
        loss, metrics = chain_objective(out, out.detach(), den, sup, cfg)
        assert impl.call_count == 1
        loss.backward()
        assert impl.call_count == 2
    ref = forward_score(out.detach(), den.trans, den.state_pdf, den.init,
                        den.final, leaky_coef=cfg.leaky_hmm_coef)
    np.testing.assert_allclose(float(metrics["logz_den"]),
                               float(ref.mean()) / t, rtol=0, atol=1e-5)
    assert torch.isfinite(out.grad).all()
