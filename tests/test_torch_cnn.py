"""The port's CNN front ends and cnn-tdnn model against the JAX package
(CPU, float32): conv stacks with a height stride, ResBlock, Res2Block,
the channel average, ConvDARTS in fixed, softmax, uniform and gumbel
modes (the sampled modes with JAX's draws through
``models.nas.draw_noise``), and ``apply_cnn_tdnnf``'s logits with its
parameter and alpha gradients."""

from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.models import cnn as jcnn
from tdnnf_nas_tpu.models import tdnnf as jtdnnf
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import cnn as tcnn
from tdnnf_nas_torch.models import nas as tnas
from tdnnf_nas_torch.models import tdnnf as ttdnnf
from tdnnf_nas_torch.train.optimizer import tree_paths, tree_unflatten

torch.set_num_threads(1)


def _frontends(pkg):
    """name -> CnnFrontendConfig of one package."""
    m = jcnn if pkg == "jax" else tcnn
    darts = m.ConvDartsLayerConfig(out_channels=6,
                                   candidates=((0,), (-1, 0, 1), (-2, 0, 2)))
    return {
        "stride": m.CnnFrontendConfig(in_height=12, layers=(
            m.ConvLayerConfig(out_channels=4),
            m.ConvLayerConfig(out_channels=6, height_subsample=2,
                              height_kernel=4),
            m.ConvLayerConfig(out_channels=5, time_offsets=(0,), relu=False,
                              batchnorm=False))),
        "resblock": m.CnnFrontendConfig(in_height=10, layers=(
            m.ConvLayerConfig(out_channels=6),
            m.ResBlockConfig(channels=6))),
        "res2block_avg": m.CnnFrontendConfig(in_height=10, layers=(
            m.ConvLayerConfig(out_channels=6),
            m.ResBlockConfig(channels=6, pre_activation=True),
            m.ResBlockConfig(channels=7, time_offsets=(-2, 0, 2))),
            channel_average=True),
        "darts": m.CnnFrontendConfig(in_height=9, layers=(
            m.ConvLayerConfig(out_channels=4, height_subsample=2),
            darts)),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(port, ref, **tol):
    pp = tree_paths(port)
    rl = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(pp) == len(rl)
    for (path, x), (_, r) in zip(pp, rl):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(r), **tol,
                                   err_msg="/".join(path))


def _fake_draws(draws):
    """draw_noise stand-in returning the JAX package's draws in order."""
    it = iter(draws)

    def fake(kind, shape, generator, device, arg):
        d = _t(next(it))
        assert tuple(d.shape) == tuple(shape), (kind, d.shape, shape)
        return d
    return fake


@pytest.mark.parametrize("name", ["stride", "resblock", "res2block_avg"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_apply_cnn_frontend_matches_jax(name, train):
    """Hidden output, consumed_left and the new BN stats at 1e-5."""
    jcfg, tcfg = _frontends("jax")[name], _frontends("torch")[name]
    jp, jbn = jcnn.init_cnn_frontend(jcfg, jax.random.PRNGKey(0))
    tp0, tbn0 = tcnn.init_cnn_frontend(tcfg, torch.Generator().manual_seed(0),
                                       "cpu")
    # same keys and shapes (kernels in JAX's HWIO), different draws
    for a, b in ((tp0, jp), (tbn0, jbn)):
        pa = tree_paths(a)
        pb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [tuple(x.shape) for _, x in pa] == [x.shape for _, x in pb]
    if not train:  # non-trivial running stats
        rng = np.random.RandomState(9)
        jbn = jax.tree.map(lambda a: jnp.asarray(
            np.abs(rng.randn(*a.shape)).astype(np.float32) + 0.5), jbn)
    x = np.random.RandomState(1).randn(2, 17, jcfg.in_height).astype(
        np.float32)
    jh, jnew, jc = jcnn.apply_cnn_frontend(jcfg, jp, jbn, jnp.asarray(x),
                                           train=train)
    th, tnew, tc = tcnn.apply_cnn_frontend(
        tcfg, convert.tree_to_torch(_np(jp), "cpu"),
        convert.tree_to_torch(_np(jbn), "cpu"), _t(x), train=train)
    assert tc == jc and tuple(th.shape) == jh.shape
    assert th.shape[-1] == tcfg.out_dim()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    _assert_tree_close(tnew, jnew, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["fixed", "softmax", "uniform", "gumbel"])
def test_conv_darts_matches_jax(mode):
    """ConvDARTS in each mode, the sampled ones with JAX's draws: the
    hidden output at 1e-5 and the alpha gradient of a projection of it at
    1e-5."""
    jcfg, tcfg = _frontends("jax")["darts"], _frontends("torch")["darts"]
    jp, jbn = jcnn.init_cnn_frontend(jcfg, jax.random.PRNGKey(2))
    x = np.random.RandomState(3).randn(2, 14, 9).astype(np.float32)
    alphas = np.random.RandomState(4).randn(1, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k0 = jax.random.split(key, 8)[0]
    draws = {"uniform": [jax.random.randint(k0, (), 0, 3)],
             "gumbel": [jax.random.uniform(k0, (3,), minval=1e-8,
                                           maxval=1.0 - 1e-8)]}.get(mode, [])
    r = np.random.RandomState(6).randn(2, 8, 5 * 6).astype(np.float32)

    def jf(a):
        h, _, c = jcnn.apply_cnn_frontend(jcfg, jp, jbn, jnp.asarray(x),
                                          alphas=a, mode=mode, tau=0.7,
                                          key=key, train=True)
        return jnp.sum(h * r), h

    (_, jh), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(alphas))
    ta = _t(alphas).requires_grad_(True)
    with mock.patch.object(tnas, "draw_noise", _fake_draws(draws)):
        th, _, tc = tcnn.apply_cnn_frontend(
            tcfg, convert.tree_to_torch(_np(jp), "cpu"),
            convert.tree_to_torch(_np(jbn), "cpu"), _t(x), alphas=ta,
            mode=mode, tau=0.7, generator=torch.Generator(), train=True)
    assert tc == 3 and tuple(th.shape) == jh.shape == (2, 8, 30)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5)
    tg = torch.zeros_like(ta)  # fixed and uniform: no path to alpha
    if th.requires_grad:
        (tg,) = torch.autograd.grad(torch.sum(th * _t(r)), ta)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    if mode in ("softmax", "gumbel"):
        assert float(tg.abs().max()) > 0


_TDNNF = dict(feat_dim=9, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
              time_strides=(1, 3), num_pdfs=10, prefinal_big=24,
              prefinal_small=12, compute_dtype="float32")


@pytest.mark.parametrize("mode", ["fixed", "softmax", "gumbel"])
def test_apply_cnn_tdnnf_matches_jax(mode):
    """Chain and xent logits at 1e-4 (a float32 conv stack, projection and
    TDNN-F stack in another summation order), and every parameter and
    alpha gradient of a projection of them within 1e-4 of its leaf's
    largest entry."""
    jcfg = jcnn.CnnTdnnfModelConfig(cnn=_frontends("jax")["darts"],
                                    tdnnf=jtdnnf.TdnnfModelConfig(**_TDNNF))
    tcfg = tcnn.CnnTdnnfModelConfig(cnn=_frontends("torch")["darts"],
                                    tdnnf=ttdnnf.TdnnfModelConfig(**_TDNNF))
    assert tcnn.cnn_tdnnf_context(tcfg) == jcnn.cnn_tdnnf_context(jcfg)
    left, right = tcnn.cnn_tdnnf_context(tcfg)
    jp, ja, jbn = jcnn.init_cnn_tdnnf(jcfg, jax.random.PRNGKey(0))
    tp0, ta0, _ = tcnn.init_cnn_tdnnf(tcfg, torch.Generator().manual_seed(0),
                                      "cpu")
    assert [p for p, _ in tree_paths(tp0)] == [
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ta0["conv_offsets"].shape == ja["conv_offsets"].shape == (1, 3)
    params = _np(jp)
    rng = np.random.RandomState(7)
    for head in ("chain", "xent"):
        params[f"output_{head}"]["w"] = (
            0.1 * rng.randn(12, 10)).astype(np.float32)
    alphas = {"conv_offsets": rng.randn(1, 3).astype(np.float32)}
    t_in = left + 4 * 3 + 1 + right
    x = rng.randn(2, t_in, 9).astype(np.float32)
    r1, r2 = (rng.randn(2, 5, 10).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(8)
    k0 = jax.random.split(key, 8)[0]
    draws = ([jax.random.uniform(k0, (3,), minval=1e-8, maxval=1.0 - 1e-8)]
             if mode == "gumbel" else [])

    def jf(p, a):
        c, xe, _ = jcnn.apply_cnn_tdnnf(jcfg, p, jbn, jnp.asarray(x),
                                        alphas=a, mode=mode, tau=0.8,
                                        key=key, train=True)
        return jnp.sum(c * r1) + jnp.sum(xe * r2), (c, xe)

    (_, (jc, jx)), (jgp, jga) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, alphas))
    pl = tree_paths(convert.tree_to_torch(params, "cpu"))
    leaves = [v.requires_grad_(True) for _, v in pl]
    tp = tree_unflatten([(p, v) for (p, _), v in zip(pl, leaves)])
    ta = _t(alphas["conv_offsets"]).requires_grad_(True)
    with mock.patch.object(tnas, "draw_noise", _fake_draws(draws)):
        tc, tx, _ = tcnn.apply_cnn_tdnnf(
            tcfg, tp, convert.tree_to_torch(_np(jbn), "cpu"), _t(x),
            alphas={"conv_offsets": ta}, mode=mode, tau=0.8,
            generator=torch.Generator(), train=True)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=1e-4)
    loss = torch.sum(tc * _t(r1)) + torch.sum(tx * _t(r2))
    grads = torch.autograd.grad(loss, leaves + [ta], allow_unused=True)
    refs = jax.tree_util.tree_leaves(jgp) + [jga["conv_offsets"]]
    names = ["/".join(p) for p, _ in pl] + ["alphas/conv_offsets"]
    for g, ref, name in zip(grads, refs, names):
        ref = np.asarray(ref)
        g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-3),
                                   err_msg=name)
    if mode != "fixed":
        assert float(grads[-1].abs().max()) > 0
