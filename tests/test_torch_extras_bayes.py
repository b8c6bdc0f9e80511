"""The port's fork-extra ops, Bayes/GP TDNN-F, ``layer_activations``,
``estimate_lda`` and ``orthonormality_error`` against the JAX package
(CPU, float32).  Random draws: the JAX package's, passed in through each
op's ``noise`` / the model's ``eps``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.models import bayes as jbayes
from tdnnf_nas_tpu.models import tdnnf as jtdnnf
from tdnnf_nas_tpu.ops import extras as jextras
from tdnnf_nas_tpu.ops import semiorth as jsemi
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import bayes as tbayes
from tdnnf_nas_torch.models import tdnnf as ttdnnf
from tdnnf_nas_torch.ops import extras as textras
from tdnnf_nas_torch.ops import semiorth as tsemi
from tdnnf_nas_torch.train.optimizer import tree_paths, tree_unflatten

torch.set_num_threads(1)

_BASE = dict(feat_dim=8, ivector_dim=0, hidden_dim=32, bottleneck_dim=8,
             time_strides=(1, 0, 3), num_pdfs=10, prefinal_big=32,
             prefinal_small=16, compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, **tol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# ---------------------------------------------------------------- ops/extras

def test_normal_rand_takes_the_draw():
    """Per frame the draw is the output; else one row, broadcast."""
    key = jax.random.PRNGKey(0)
    for per_frame in (True, False):
        ref = jextras.normal_rand(key, 4, 6, rand_per_frame=per_frame)
        draw = jax.random.normal(key, (4, 6) if per_frame else (1, 6))
        out = textras.normal_rand(4, 6, rand_per_frame=per_frame,
                                  device="cpu", noise=_t(draw))
        _close(out, ref, rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    shared = textras.normal_rand(5, 3, g, rand_per_frame=False, device="cpu")
    assert shared.shape == (5, 3) and torch.equal(shared[0], shared[4])
    with pytest.raises(ValueError):
        textras.normal_rand(2, 2, device="cpu")


def test_min_value_forward_and_constant_grad():
    """Forward scale * x; the gradient is -scale whatever comes in."""
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    cot = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jextras.min_value(a, 2.5), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    tx = _t(x).requires_grad_(True)
    ty = textras.min_value(tx, 2.5)
    (tg,) = torch.autograd.grad(ty, tx, _t(cot))
    _close(ty, y, rtol=0, atol=0)
    _close(tg, jg, rtol=0, atol=0)
    assert float(tg[0, 0]) == -2.5


def test_softmax_gradnorm_forward_and_vjp():
    """Row softmax; its input gradient is the softmax VJP times
    100 / num_cols.  Bar 1e-6."""
    x = np.random.RandomState(2).randn(4, 7).astype(np.float32)
    cot = np.random.RandomState(3).randn(4, 7).astype(np.float32)
    y, vjp = jax.vjp(jextras.softmax_gradnorm, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    tx = _t(x).requires_grad_(True)
    ty = textras.softmax_gradnorm(tx)
    (tg,) = torch.autograd.grad(ty, tx, _t(cot))
    _close(ty, y, rtol=0, atol=1e-6)
    _close(tg, jg, rtol=0, atol=1e-6)


def test_input_vector_linear_and_select_col():
    rng = np.random.RandomState(4)
    lin = rng.randn(2, 3, 12).astype(np.float32)
    gains = rng.randn(2, 3, 4).astype(np.float32)
    sizes = (5, 3, 4)
    ref = jextras.input_vector_linear(jnp.asarray(lin), jnp.asarray(gains),
                                      sizes)
    _close(textras.input_vector_linear(_t(lin), _t(gains), sizes), ref,
           rtol=0, atol=1e-6)
    ids = np.array([3, 0, 2, 3], np.int32)
    params = rng.randn(5, 4).astype(np.float32)
    ref = jextras.linear_select_col(jnp.asarray(ids), jnp.asarray(params))
    _close(textras.linear_select_col(_t(ids), _t(params)), ref, rtol=0,
           atol=0)


def test_gumbel_softmax_with_jax_noise():
    logits = np.random.RandomState(5).randn(3, 6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jextras.gumbel_softmax(jnp.asarray(logits), key, 0.5)
    u = jax.random.uniform(key, logits.shape, minval=1e-20, maxval=1.0)
    out = textras.gumbel_softmax(_t(logits), 0.5, noise=_t(u))
    _close(out, ref, rtol=0, atol=1e-6)
    g = textras.gumbel_softmax(_t(logits), 0.5,
                               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_argmax_onehot_st():
    """Hard one-hot forward, identity gradient."""
    x = np.random.RandomState(6).randn(4, 5).astype(np.float32)
    cot = np.random.RandomState(7).randn(4, 5).astype(np.float32)
    y, vjp = jax.vjp(jextras.argmax_onehot_st, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(cot))
    tx = _t(x).requires_grad_(True)
    ty = textras.argmax_onehot_st(tx)
    (tg,) = torch.autograd.grad(ty, tx, _t(cot))
    _close(ty, y, rtol=0, atol=1e-6)
    _close(tg, jg, rtol=0, atol=0)


@pytest.mark.parametrize("per_frame", [False, True])
def test_sample_vec_and_kl(per_frame):
    rng = np.random.RandomState(8)
    m, s, pm, ps = (rng.randn(3, 4, 6).astype(np.float32) for _ in range(4))
    s, ps = np.abs(s) + 0.1, np.abs(ps) + 0.1
    key = jax.random.PRNGKey(9)
    args = [jnp.asarray(a) for a in (m, s, pm, ps)]
    for test_mode in (False, True):
        zr, klr = jextras.sample_vec_and_kl(*args, key,
                                            rand_per_frame=per_frame,
                                            test_mode=test_mode)
        eps = jax.random.normal(key, m.shape if per_frame else m.shape[-1:])
        z, kl = textras.sample_vec_and_kl(
            *(_t(a) for a in (m, s, pm, ps)), rand_per_frame=per_frame,
            test_mode=test_mode, noise=_t(eps))
        _close(z, zr, rtol=0, atol=1e-6)
        _close(kl, klr, rtol=1e-6, atol=1e-6)


# ---------------------------------------------- models/tdnnf, ops/semiorth

def _jax_params(init, *args):
    params, bn = init(*args)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn)


def _randomize_heads(params, seed):
    """The output heads are zero-initialized; give them mass so upstream
    effects show in the logits."""
    rng = np.random.RandomState(seed)
    for head in ("chain", "xent"):
        w = params[f"output_{head}"]["w"]
        params[f"output_{head}"]["w"] = (0.1 * rng.randn(*w.shape)
                                         ).astype(np.float32)
    return params


def test_layer_activations_through_apply_model():
    """A per-layer activation replaces that layer's ReLU; the logits
    equal JAX's at 1e-5 (and differ from the ReLU model's)."""
    jcfg = jtdnnf.TdnnfModelConfig(**_BASE)
    tcfg = ttdnnf.TdnnfModelConfig(**_BASE)
    params, bn = _jax_params(jtdnnf.init_model, jcfg, jax.random.PRNGKey(0))
    params = _randomize_heads(params, 1)
    feats = np.random.RandomState(2).randn(
        2, jtdnnf.chunk_input_frames(jcfg, 5), 8).astype(np.float32)
    jc, jx, _ = jtdnnf.apply_model(
        jcfg, params, bn, jnp.asarray(feats), train=True,
        layer_activations={"tdnnf3": jnp.tanh, "tdnnf4": jax.nn.sigmoid})
    tp, tb = (convert.tree_to_torch(t, "cpu") for t in (params, bn))
    tc, tx, _ = ttdnnf.apply_model(
        tcfg, tp, tb, _t(feats), train=True,
        layer_activations={"tdnnf3": torch.tanh, "tdnnf4": torch.sigmoid})
    _close(tc, jc, rtol=0, atol=1e-5)
    _close(tx, jx, rtol=0, atol=1e-5)
    relu, _, _ = ttdnnf.apply_model(tcfg, tp, tb, _t(feats), train=True)
    assert float((relu - tc).abs().max()) > 1e-3


def test_estimate_lda_equals_jax():
    x = np.random.RandomState(3).randn(4, 50, 9).astype(np.float32) * [
        1, 2, 3, 1, 1, 5, 1, 1, 0.5]
    for a, b in zip(ttdnnf.estimate_lda(x), jtdnnf.estimate_lda(x)):
        np.testing.assert_array_equal(a, b)


def test_orthonormality_error_matches_jax():
    for shape in ((12, 5), (5, 12), (7, 7)):
        w = np.random.RandomState(4).randn(*shape).astype(np.float32)
        ref = float(jsemi.orthonormality_error(jnp.asarray(w)))
        got = float(tsemi.orthonormality_error(_t(w)))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    w = torch.linalg.qr(torch.randn(9, 4, generator=torch.Generator()
                                    .manual_seed(0)))[0] * 3.0
    assert float(tsemi.orthonormality_error(w)) < 1e-5


# ------------------------------------------------------------- models/bayes

def _bayes_cfgs(gp):
    kw = dict(gp_activation=gp, rho_init=-1.0)
    return (jbayes.BayesTdnnfModelConfig(
                base=jtdnnf.TdnnfModelConfig(**_BASE), **kw),
            tbayes.BayesTdnnfModelConfig(
                base=ttdnnf.TdnnfModelConfig(**_BASE), **kw))


def _jax_eps(jcfg, params, key):
    """The draws of apply_bayes_model (bayes.py:169-170 there): split into
    2 * num_tdnnf keys, [2i] the affine's eps, [2i+1] the gpact's."""
    keys = jax.random.split(key, 2 * jcfg.base.num_tdnnf)
    out = []
    for i in range(jcfg.base.num_tdnnf):
        layer = params[f"tdnnf{i + 2}"]
        for j, k in ((2 * i, "affine_mu"), (2 * i + 1, "gpact_mu")):
            if k not in layer:
                out.append(None)
                continue
            mu = layer[k]
            shape = (mu.shape[:-1] + (1,) if jcfg.share_std_output_sampling
                     else mu.shape)
            out.append(_t(jax.random.normal(keys[j], shape, jnp.float32)))
    return out


@pytest.mark.parametrize("gp", [False, True], ids=["bayes", "gp"])
@pytest.mark.parametrize("train", [False, True], ids=["test", "train"])
def test_apply_bayes_model_matches_jax(gp, train):
    """Logits and every parameter gradient of
    mean(chain * r) + mean(xent * r') + kl at atol 1e-5 (kl at rtol 1e-5),
    with JAX's eps in train mode."""
    jcfg, tcfg = _bayes_cfgs(gp)
    params, bn = _jax_params(jbayes.init_bayes_model, jcfg,
                             jax.random.PRNGKey(0))
    params = _randomize_heads(params, 5)
    feats = np.random.RandomState(6).randn(
        2, jtdnnf.chunk_input_frames(jcfg.base, 5), 8).astype(np.float32)
    rng = np.random.RandomState(7)
    r1, r2 = (rng.randn(2, 5, 10).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(11)

    def jloss(p):
        c, x, _, kl = jbayes.apply_bayes_model(
            jcfg, p, bn, jnp.asarray(feats), key=key if train else None,
            train=train)
        return (jnp.mean(c * r1) + jnp.mean(x * r2) + kl, (c, x, kl))

    (jl, (jc, jx, jkl)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))

    pl = tree_paths(convert.tree_to_torch(params, "cpu"))
    leaves = [x.requires_grad_(True) for _, x in pl]
    tp = tree_unflatten([(p, x) for (p, _), x in zip(pl, leaves)])
    tc, tx, _, tkl = tbayes.apply_bayes_model(
        tcfg, tp, convert.tree_to_torch(bn, "cpu"), _t(feats), train=train,
        eps=_jax_eps(jcfg, params, key) if train else None)
    tl = torch.mean(tc * _t(r1)) + torch.mean(tx * _t(r2)) + tkl
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    _close(tc, jc, rtol=0, atol=1e-5)
    _close(tx, jx, rtol=0, atol=1e-5)
    # kl sums ~10^4 float32 terms in another order: rtol 1e-5
    _close(tkl, jkl, rtol=1e-5, atol=1e-5)
    jgl = jax.tree_util.tree_leaves(jg)
    assert len(jgl) == len(tg)
    for (path, _), a, b in zip(pl, tg, jgl):
        a = torch.zeros_like(leaves[0]) if a is None else a
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg="/".join(path))


def test_bayes_train_mode_draws_from_the_generator():
    """Two generators' draws give two outputs; one seed gives one; test
    mode needs no generator; train mode without one raises."""
    _, tcfg = _bayes_cfgs(True)
    tp, tb = tbayes.init_bayes_model(tcfg.replace(rho_init=0.0),
                                     torch.Generator().manual_seed(0), "cpu")
    assert set(tp["tdnnf2"]) == {"linear", "affine_mu", "affine_rho",
                                 "affine_b", "gpact_mu", "gpact_rho"}
    tp = convert.tree_to_torch(_randomize_heads(convert.tree_to_numpy(tp),
                                                1), "cpu")
    x = torch.randn(1, ttdnnf.chunk_input_frames(tcfg.base, 4), 8,
                    generator=torch.Generator().manual_seed(1))
    run = lambda s: tbayes.apply_bayes_model(
        tcfg, tp, tb, x, generator=torch.Generator().manual_seed(s),
        train=True)[0]
    assert torch.equal(run(3), run(3))
    assert float((run(3) - run(4)).abs().max()) > 0
    with pytest.raises(ValueError):
        tbayes.apply_bayes_model(tcfg, tp, tb, x, train=True)
    assert tbayes.semiorth_param_paths(tcfg) == ttdnnf.semiorth_param_paths(
        tcfg.base)
