"""Port's model ops and TDNN-F forward vs the JAX package (float32, CPU)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.models import tdnnf as jmodel
from tdnnf_nas_tpu.ops import semiorth as jsemi
from tdnnf_nas_tpu.ops import tdnn as jtdnn
from tdnnf_nas_torch import convert
from tdnnf_nas_torch.models import tdnnf as tmodel
from tdnnf_nas_torch.ops import semiorth as tsemi
from tdnnf_nas_torch.ops import tdnn as ttdnn

torch.set_num_threads(1)

_SMALL = dict(feat_dim=12, ivector_dim=5, hidden_dim=32, bottleneck_dim=8,
              time_strides=(1, 1, 0, 3, 3), num_pdfs=23, prefinal_big=32,
              prefinal_small=16, compute_dtype="float32")


@pytest.mark.parametrize("offsets", [(0,), (-1, 0), (0, 3)])
def test_spliced_linear_matches_jax(offsets):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 6).astype(np.float32)
    w = rng.randn(len(offsets), 6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    got = ttdnn.spliced_linear(torch.tensor(x), torch.tensor(w), offsets,
                               bias=torch.tensor(b),
                               compute_dtype=torch.float32).numpy()
    ref = np.asarray(jtdnn.spliced_linear(jnp.asarray(x), jnp.asarray(w),
                                          offsets, bias=jnp.asarray(b),
                                          compute_dtype=jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        ttdnn.splice(torch.tensor(x), offsets).numpy(),
        np.asarray(jtdnn.splice(jnp.asarray(x), offsets)))


@pytest.mark.parametrize("shape", [(40, 8), (8, 40), (2, 24, 6)])
def test_semi_orthogonal_step_matches_jax(shape):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32) * 0.3
    if len(shape) == 3:
        got = tsemi.semi_orthogonal_step_3d(torch.tensor(w)).numpy()
        ref = jsemi.semi_orthogonal_step_3d(jnp.asarray(w))
    else:
        got = tsemi.semi_orthogonal_step(torch.tensor(w)).numpy()
        ref = jsemi.semi_orthogonal_step(jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_apply_model_matches_jax(train):
    """Chain/xent logits and new BN stats at a small float32 config, with
    the JAX package's weights carried across by convert.py (output layers
    randomized so the heads are not trivially zero)."""
    jcfg = jmodel.TdnnfModelConfig(**_SMALL)
    tcfg = tmodel.TdnnfModelConfig(**_SMALL)
    params, bn = jmodel.init_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    bn = jax.tree.map(np.asarray, bn)
    rng = np.random.RandomState(2)
    for head in ("chain", "xent"):
        params[f"output_{head}"]["w"] = rng.randn(
            *params[f"output_{head}"]["w"].shape).astype(np.float32) * 0.1
    t_in = jmodel.chunk_input_frames(jcfg, 4)
    assert t_in == tmodel.chunk_input_frames(tcfg, 4)
    assert jmodel.model_context(jcfg) == tmodel.model_context(tcfg)
    feats = rng.randn(3, t_in, 12).astype(np.float32)
    iv = rng.randn(3, 5).astype(np.float32)
    jc, jx, jbn = jax.jit(lambda p, s, f, i: jmodel.apply_model(
        jcfg, p, s, f, i, train=train))(params, bn, jnp.asarray(feats),
                                        jnp.asarray(iv))
    tc, tx, tbn = tmodel.apply_model(
        tcfg, convert.tree_to_torch(params, device="cpu"),
        convert.tree_to_torch(bn, device="cpu"),
        torch.tensor(feats), torch.tensor(iv), train=train)
    assert tc.shape == (3, 4, 23) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    tbn = convert.tree_to_numpy(tbn)
    for name, st in jax.tree.map(np.asarray, jbn).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(tbn[name][k], st[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}/{k}")


def test_flagship_count_params():
    """18,751,248 params at the flagship 7q config (BENCH_r05.json), from
    shapes only (meta tensors), and the same layout as the JAX package."""
    cfg = tmodel.TdnnfModelConfig()
    params, _ = tmodel.init_model(cfg, torch.Generator().manual_seed(0),
                                  device="meta")
    assert tmodel.count_params(params) == 18_751_248
    jparams = jax.eval_shape(lambda k: jmodel.init_model(
        jmodel.TdnnfModelConfig(), k)[0], jax.random.PRNGKey(0))
    jshapes = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jparams)[0]}
    from tdnnf_nas_torch.train.optimizer import tree_paths
    tshapes = {"/".join(p): tuple(x.shape) for p, x in tree_paths(params)}
    assert tshapes == jshapes
    assert tmodel.semiorth_param_paths(cfg) == jmodel.semiorth_param_paths(
        jmodel.TdnnfModelConfig())
