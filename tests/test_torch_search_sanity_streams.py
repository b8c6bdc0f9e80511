"""Whether the planted sanity check finds its stride is a property of the
random streams, not of the port: the reference's sizes on the CPU, 320
uniform pretraining steps in both packages on the batches of
``RandomState(0)`` with JAX's draws under ``PRNGKey(0)`` injected into
the port, then each package's 800-step softmax cv-update from its own
state (``scripts/search_sanity_planted.py:121-138`` against
``tdnnf_nas_torch.tools.search_sanity_planted``).  Both must put more
than 0.8 of the affine softmax on the reachable strides 2 and 3, within
0.05 of each other.  About a minute on one worker."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tdnnf_nas_tpu.data.egs as jegs
import tdnnf_nas_tpu.models as jmodels
import tdnnf_nas_tpu.recipes.chain_recipes as jrec
import tdnnf_nas_tpu.train as jtrain
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import train as ttrain
from tdnnf_nas_torch.data.egs import batch_iterator
from tdnnf_nas_torch.models import DartsModelConfig
from tdnnf_nas_torch.recipes.chain_recipes import prepare_data, train_model
from tdnnf_nas_torch.tools import search_sanity_planted as tssp
from tests.test_torch_nas import injected, jax_draws

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN, CV, BATCH, CHUNK = 320, 800, 16, 20  # the reference's, :121-137


def _reference():
    spec = importlib.util.spec_from_file_location(
        "_sanity_ref", os.path.join(REPO, "scripts",
                                    "search_sanity_planted.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reachable_mass(a) -> float:
    a = np.asarray(a, np.float64)
    p = np.exp(a) / np.exp(a).sum(-1, keepdims=True)
    return float(p[0, 2] + p[0, 3])


def test_same_draws_find_the_planted_stride_in_both_packages():
    ref = _reference()
    utts, phones, tree, topo = ref.make_planted_corpus()
    jb = jrec.prepare_data(utts, phones, tree, topo, 8, dev_fraction=0.12)
    tu, tp, tt, ttopo = tssp.make_planted_corpus()
    tb = prepare_data(tu, tp, tt, ttopo, 8, dev_fraction=0.12)
    base = tssp.model_config(16)
    jd = jmodels.DartsModelConfig(
        base=jmodels.TdnnfModelConfig(**dataclasses.asdict(base)),
        search_offsets=True, max_stride=3)
    td = DartsModelConfig(base=base, search_offsets=True, max_stride=3)
    cfgs = {}
    for name, pkg in (("jax", jtrain), ("port", ttrain)):
        cfgs[name] = (
            pkg.TrainerConfig(train_theta=True, train_alpha=False,
                              search_mode="uniform",
                              optimizer=pkg.OptimizerConfig(
                                  num_steps=PRETRAIN, **tssp.OPT)),
            pkg.TrainerConfig(train_theta=False, train_alpha=True,
                              bn_frozen=True, search_mode="softmax",
                              optimizer=pkg.OptimizerConfig(
                                  num_steps=CV, alpha_lr_scale=30.0,
                                  **tssp.OPT)))
    jst = jtrain.init_train_state(jd, cfgs["jax"][0], jax.random.PRNGKey(0),
                                  supernet=True)
    tst = convert.supernet_state_from_numpy(
        *(jax.tree.map(np.asarray, t) for t in (
            jst.params, jst.alphas, jst.bn_state, jst.opt_state,
            jst.alpha_opt_state)), int(jst.step), device="cpu")
    jstep = jtrain.make_train_step(jd, cfgs["jax"][0], jb.den_arrays,
                                   supernet=True, donate=False)
    tstep = ttrain.make_train_step(td, cfgs["port"][0], tb.den_arrays,
                                   supernet=True, seed=0)
    jit = jegs.batch_iterator(jb.egs(None, chunk_width=CHUNK,
                                     supernet_cfg=jd),
                              BATCH, np.random.RandomState(0))
    tit = batch_iterator(tb.egs(None, chunk_width=CHUNK, supernet_cfg=td),
                         BATCH, np.random.RandomState(0))
    key = jax.random.PRNGKey(0)
    for _ in range(PRETRAIN):
        jbatch, tbatch = next(jit), next(tit)
        np.testing.assert_array_equal(jbatch["feats"], tbatch["feats"])
        k_model, k_drop = jax.random.split(jax.random.fold_in(key, jst.step))
        draws = jax_draws(jd, "uniform", k_model, BATCH, k_drop, 0.0)
        jst, _ = jstep(jst, jax.tree.map(jnp.asarray, jbatch), key)
        with injected(draws):
            tst, _ = tstep(tst, convert.batch_to_torch(tbatch, device="cpu"))
    run = dict(batch_size=BATCH, chunk_width=CHUNK, seed=1, supernet=True,
               dev=True)
    jst, _ = jrec.train_model(jb, jd, cfgs["jax"][1], CV, init_state=jst,
                              **run)
    tst, _ = train_model(tb, td, cfgs["port"][1], CV, init_state=tst,
                         device="cpu", prefetch=0, **run)
    m_jax = _reachable_mass(jst.alphas["offsets_affine"])
    m_port = _reachable_mass(tst.alphas["offsets_affine"].numpy())
    print(f"reachable mass after the cv-update: JAX {m_jax:.4f}, port "
          f"{m_port:.4f}")
    assert m_jax > 0.8 and m_port > 0.8, (m_jax, m_port)
    assert abs(m_jax - m_port) <= 0.05, (m_jax, m_port)
