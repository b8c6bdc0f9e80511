"""The port's optimizer kinds against the JAX package (CPU, float32).

``update_fn`` of sgd, sgd with momentum, adafactor, ng (and adam) over 12
steps on one tree with a 1-D leaf, a 3-D leaf, a leaf with one side over
``ng_max_dim`` and one with both sides over it; a ``make_train_step``
trajectory with ``kind="ng"``; checkpoints of every kind crossing between
the packages in both directions.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.core import checkpoint as jckpt
from tdnnf_nas_tpu.train import optimizer as jopt
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core import checkpoint as tckpt
from tdnnf_nas_torch.train import optimizer as topt
from tdnnf_nas_torch.train.optimizer import tree_paths

torch.set_num_threads(1)

# ng_max_dim = 8: "w3" [2, 3, 5] preconditions both sides (6 and 5), "wide"
# [4, 12] its left side only, "big" [10, 12] none, "lda/b" is 1-D
_SHAPES = {"lda": {"b": (6,), "w": (5, 7)}, "w3": (2, 3, 5),
           "wide": (4, 12), "big": (10, 12)}
_KINDS = {
    "sgd": dict(kind="sgd"),
    "sgd_momentum": dict(kind="sgd", momentum=0.9),
    "adafactor": dict(kind="adafactor"),
    "ng": dict(kind="ng", ng_update_period=5, ng_max_dim=8),
    "adam": dict(kind="adam"),
}


def _wd_scale(path):
    return 0.0 if "lda" in "/".join(path) else 0.5


def _np_tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _np_tree(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _assert_tree_close(port, ref, **tol):
    pp = tree_paths(port)
    rl = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(pp) == len(rl)
    for (path, x), (_, r) in zip(pp, rl):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), **tol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_update_fn_matches_jax(kind):
    """12 updates from the same params and gradients: params and every
    leaf of the optimizer state.  Bars: rtol 1e-5 with atol 1e-7, about
    one float32 ulp at the parameters' scale of 1, for values near zero
    (sgd, adafactor, adam: lr and Adam's bias corrections are float32 on
    both sides); atol 1e-5 for ng, whose eigh runs in another LAPACK on
    each side (steps 0, 5 and 10 recompute the inverse roots)."""
    cfg = dict(lr_initial=0.05, lr_final=0.01, num_steps=12,
               l2_regularize=0.1, max_change_per_leaf=0.3,
               max_change_global=0.5, **_KINDS[kind])
    jinit, jupdate = jopt.make_optimizer(jopt.OptimizerConfig(**cfg),
                                         _wd_scale)
    tinit, tupdate = topt.make_optimizer(topt.OptimizerConfig(**cfg),
                                         _wd_scale)
    rng = np.random.default_rng(0)
    params = _np_tree(_SHAPES, rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.tree_to_torch(params, "cpu")
    js, ts = jinit(jp), tinit(tp)
    _assert_tree_close(ts, js, atol=0)
    tol = (dict(rtol=0, atol=1e-5) if kind == "ng"
           else dict(rtol=1e-5, atol=1e-7))
    for step in range(12):
        grads = _np_tree(_SHAPES, rng, scale=0.5)
        jp, js = jupdate(jax.tree.map(jnp.asarray, grads), js, jp,
                         jnp.asarray(step, jnp.int32))
        tp, ts = tupdate([torch.from_numpy(g) for _, g in
                          tree_paths(grads)], ts, tp, step)
        _assert_tree_close(tp, jp, **tol)
        _assert_tree_close(ts, js, **tol)
    if kind == "ng":  # the holes: 1-D and both-sides-over leaves
        assert ts["ng"]["lda"]["b"] == {} and ts["ng"]["big"] == {}
        assert set(ts["ng"]["wide"]) == {"cl", "pl"}
        assert set(ts["ng"]["w3"]) == {"cl", "cr", "pl", "pr"}


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        topt.make_optimizer(topt.OptimizerConfig(kind="lbfgs"))


_MODEL = dict(feat_dim=10, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
              time_strides=(1, 2), num_pdfs=12, prefinal_big=24,
              prefinal_small=12, compute_dtype="float32")


def _states(kind, supernet=False):
    """(JAX state with every leaf distinct seeded data, the port's like
    state) of the 2-layer model (or a small supernet) with optimizer
    ``kind``."""
    from tdnnf_nas_tpu import models as jmodels
    from tdnnf_nas_tpu import train as jtrain
    from tdnnf_nas_torch import models as tmodels
    from tdnnf_nas_torch import train as ttrain
    from tests.test_torch_nas_train_step import _cfgs

    ocfg = {**_KINDS[kind], "ng_max_dim": 16}
    if supernet:
        jcfg, tcfg = _cfgs(jmodels, 12, "offsets"), _cfgs(tmodels, 12,
                                                           "offsets")
    else:
        jcfg = jmodels.TdnnfModelConfig(**_MODEL)
        tcfg = tmodels.TdnnfModelConfig(**_MODEL)
    jtc = jtrain.TrainerConfig(optimizer=jtrain.OptimizerConfig(**ocfg))
    ttc = ttrain.TrainerConfig(optimizer=ttrain.OptimizerConfig(**ocfg))
    st = jtrain.init_train_state(jcfg, jtc, jax.random.PRNGKey(0),
                                 supernet=supernet)
    rng = np.random.RandomState(1)
    rand = lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32))
    jst = dataclasses.replace(
        jax.tree.map(rand, dataclasses.replace(st, step=None)),
        step=jnp.asarray(7, jnp.int32))
    like = ttrain.init_train_state(tcfg, ttc, torch.Generator().manual_seed(
        2), "cpu", supernet=supernet)
    return jst, like


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_checkpoint_of_each_kind_crosses(tmp_path, kind):
    """A JAX checkpoint of each optimizer kind loads into the port equal
    to ``convert.train_state_from_numpy`` of its arrays (the state's
    structure from the port's own ``init_fn``), and the port's checkpoint
    of it loads back into JAX leaf for leaf."""
    jst, like = _states(kind)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, jst)
    state, step, _ = tckpt.load_checkpoint(str(tmp_path / "j"), like)
    ref = convert.train_state_from_numpy(
        _np(jst.params), _np(jst.bn_state), _np(jst.opt_state), 7, "cpu")
    assert step == 7 and state.step == 7
    for name in ("params", "bn_state", "opt_state"):
        a, b = tree_paths(getattr(state, name)), tree_paths(getattr(ref,
                                                                    name))
        assert [p for p, _ in a] == [p for p, _ in b], name
        for (p, x), (_, y) in zip(a, b):
            assert torch.equal(x, y), (name, p)
    _assert_tree_close(state.opt_state, jst.opt_state, atol=0)
    # and back: the port writes, JAX reads
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, state)
    jback, _, _ = jckpt.load_checkpoint(str(tmp_path / "t"), jst)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np_state = convert.train_state_to_numpy(state)
    for a, b in zip(jax.tree_util.tree_leaves(np_state[2]),
                    jax.tree_util.tree_leaves(_np(jst.opt_state))):
        np.testing.assert_array_equal(a, b)


def test_supernet_ng_checkpoint_crosses(tmp_path):
    """kind="ng" reaches the supernet's [L, K] alphas through the alpha
    optimizer; their state crosses too."""
    jst, like = _states("ng", supernet=True)
    assert set(like.alpha_opt_state) == {"ng"}
    for name in ("offsets_linear", "offsets_affine"):
        assert set(like.alpha_opt_state["ng"][name]) == {"cl", "cr", "pl",
                                                         "pr"}
    jckpt.save_checkpoint(str(tmp_path), 7, jst)
    state, _, _ = tckpt.load_checkpoint(str(tmp_path), like)
    _assert_tree_close(state.alpha_opt_state, jst.alpha_opt_state, atol=0)
    _assert_tree_close(state.opt_state, jst.opt_state, atol=0)


def test_ng_train_steps_match_jax():
    """Three make_train_step steps with kind="ng" (step 0 recomputes the
    inverse roots, period 2: step 2 again) from one state: objf_mmi within
    5e-4 of JAX at every step (the bar of __graft_entry__.py:119), the
    params after the first step within 1e-4 and its ng state within 1e-5
    of each leaf's largest entry."""
    from tdnnf_nas_tpu.train import (OptimizerConfig as JOpt,
                                     TrainerConfig as JTC,
                                     init_train_state as jinit,
                                     make_train_step as jmake)
    from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph
    from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                       make_train_step)
    from tests.test_torch_train_step import _build

    jbundle, jcfg, jbatch = _build("jax")
    tbundle, tcfg, tbatch = _build("torch")
    ocfg = dict(kind="ng", ng_update_period=2, lr_initial=1e-2,
                lr_final=1e-3, num_steps=3)
    jtc, ttc = JTC(optimizer=JOpt(**ocfg)), TrainerConfig(
        optimizer=OptimizerConfig(**ocfg))
    jst = jinit(jcfg, jtc, jax.random.PRNGKey(2))
    jstep = jmake(jcfg, jtc, jbundle.den_arrays, donate=False)
    tst = convert.train_state_from_numpy(
        _np(jst.params), _np(jst.bn_state), _np(jst.opt_state), 0,
        device="cpu")
    assert tst.opt_state.keys() == {"ng"}
    tstep = make_train_step(tcfg, ttc,
                            BlockedDenGraph.from_host(tbundle.den_arrays,
                                                      "cpu"))
    jb = jax.tree.map(jnp.asarray, jbatch)
    tb = convert.batch_to_torch(tbatch, device="cpu")
    for i in range(3):
        jst, jm = jstep(jst, jb, jax.random.PRNGKey(3))
        tst, tm = tstep(tst, tb)
        d = abs(float(tm["objf_mmi"]) - float(jm["objf_mmi"]))
        assert d < 5e-4, (i, float(tm["objf_mmi"]), float(jm["objf_mmi"]))
        if i == 0:
            _assert_tree_close(tst.params, jst.params, rtol=0, atol=1e-4)
            # each covariance and inverse root within 1e-5 of its largest
            # entry (an inverse root of a near-degenerate covariance, as
            # of the zero-initialised output layer, reaches ~1/damp)
            for (path, x), (_, r) in zip(
                    tree_paths(tst.opt_state),
                    jax.tree_util.tree_flatten_with_path(jst.opt_state)[0]):
                r = np.asarray(r)
                np.testing.assert_allclose(
                    x.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                    err_msg="/".join(path))
