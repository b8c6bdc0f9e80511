"""The port's model finalization (``train/finalize.py``) vs the JAX package
on the same numpy states (CPU): batchnorm stats recompute, the three
combination modes and parameter shrinkage.

The 2-layer float32 model of tests/test_egs_file.py; three states whose
params are one seeded target plus noise of three sizes, scored by a
validation objective that both packages compute in float64 from the
params (minus the squared distance to the target).  Tolerances: BN
statistics are float32 reductions in another order (rtol 1e-5); averages
sum the same float32 values in the same order (atol 1e-7); shrinkage is
one float32 product (exact).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import models as jmodels
from tdnnf_nas_tpu import train as jtrain
from tdnnf_nas_tpu.train import finalize as jfin
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import models as tmodels
from tdnnf_nas_torch.train import finalize as tfin
from tdnnf_nas_torch.train.optimizer import tree_paths
from tests.test_torch_checkpoint import _PLAIN

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def states():
    """Three JAX states (params = target + noise * k) and their targets."""
    cfg = jmodels.TdnnfModelConfig(**_PLAIN)
    st = jtrain.init_train_state(cfg, jtrain.TrainerConfig(),
                                 jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    target = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), st.params)
    out = []
    for k in (0.3, 0.2, 0.25):
        params = jax.tree.map(
            lambda t: jnp.asarray(
                t + k * rng.standard_normal(t.shape).astype(np.float32)),
            target)
        bn = jax.tree.map(lambda a: jnp.asarray(
            a + rng.rand(*a.shape).astype(np.float32)), st.bn_state)
        out.append(dataclasses.replace(st, params=params, bn_state=bn))
    return out, target


def _port(jst):
    return convert.train_state_from_numpy(
        *(jax.tree.map(np.asarray, t) for t in (jst.params, jst.bn_state,
                                                jst.opt_state)),
        int(jst.step), device="cpu")


def _objf(leaves, target_leaves):
    return -sum(float(np.sum((np.asarray(x, np.float64) - t) ** 2))
                for x, t in zip(leaves, target_leaves))


def _assert_params_close(tparams, jparams, atol):
    jl = jax.tree.leaves(jparams)
    tl = tree_paths(tparams)
    assert len(jl) == len(tl)
    for (p, x), y in zip(tl, jl):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=atol, err_msg="/".join(p))


@pytest.mark.parametrize("mode", ["best", "average", "weighted"])
def test_combine_states_matches_jax(states, mode):
    jstates, target = states
    tl = jax.tree.leaves(target)
    jobjf = lambda s: _objf(jax.tree.leaves(s.params), tl)
    tobjf = lambda s: _objf([x.numpy() for _, x in tree_paths(s.params)], tl)
    jout, jo = jfin.combine_states(jstates, jobjf, mode=mode)
    tout, to = tfin.combine_states([_port(s) for s in jstates], tobjf,
                                   mode=mode)
    assert to == jo and int(np.argmax(to)) == 1
    _assert_params_close(tout.params, jout.params, atol=1e-7)
    best_bn = _port(jstates[1]).bn_state
    for name, st in tout.bn_state.items():
        for k in st:
            assert torch.equal(st[k], best_bn[name][k])
    if mode == "weighted":  # it combined more than the best state
        assert tobjf(tout) > max(to)


def test_combine_states_rejects_unknown_mode(states):
    with pytest.raises(ValueError, match="mode"):
        tfin.combine_states([_port(s) for s in states[0]], lambda s: 0.0,
                            mode="median")


def test_shrink_params_matches_jax(states):
    """Every leaf scaled but the LDA and the output layers, exactly."""
    jst = states[0][0]
    jp = jfin.shrink_params(jst.params, 0.9)
    tp = tfin.shrink_params(_port(jst).params, 0.9)
    _assert_params_close(tp, jp, atol=0.0)
    orig = _port(jst).params
    assert torch.equal(tp["lda"]["w"], orig["lda"]["w"])
    assert torch.equal(tp["output_chain"]["w"], orig["output_chain"]["w"])
    assert not torch.equal(tp["tdnn1"]["w"], orig["tdnn1"]["w"])


def test_recompute_bn_stats_matches_jax(states):
    """3 train-mode forwards of seeded batches (max_batches=3 of 4) from
    the stored statistics."""
    from tdnnf_nas_tpu.models import tdnnf as jmodel
    from tdnnf_nas_torch.models import tdnnf as tmodel

    jcfg = jmodels.TdnnfModelConfig(**_PLAIN)
    tcfg = tmodels.TdnnfModelConfig(**_PLAIN)
    t_in = tmodels.chunk_input_frames(tcfg, 6)
    rng = np.random.RandomState(3)
    feats = [rng.randn(4, t_in, 10).astype(np.float32) for _ in range(4)]
    jst = states[0][0]

    def japply(params, bn, f):
        return jmodel.apply_model(jcfg, params, bn, jnp.asarray(f), None,
                                  train=True)[2]

    def tapply(params, bn, f):
        with torch.no_grad():
            return tmodel.apply_model(tcfg, params, bn, torch.tensor(f),
                                      None, train=True)[2]

    jout = jfin.recompute_bn_stats(japply, jst, feats, max_batches=3)
    tout = tfin.recompute_bn_stats(tapply, _port(jst), feats, max_batches=3)
    jbn = jax.tree.map(np.asarray, jout.bn_state)
    moved = 0.0
    for name, st in tout.bn_state.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k].numpy(), jbn[name][k],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}/{k}")
            moved = max(moved, float(np.abs(
                jbn[name][k] - np.asarray(jst.bn_state[name][k])).max()))
    assert moved > 1e-3
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_paths(tout.params), tree_paths(_port(jst).params)))
