"""``SparseDenGraph`` and ``forward_score_sparse`` of the port against the
JAX package on the CPU: the padded in-arc tables of ``from_graph`` and
``from_arcs`` equal the reference's, and logZ and the obs gradient agree
at the blocked den's bar (atol 2e-5), with leaky 0 and 0.1."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import graphs as jgraphs
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.ops import fwdbwd as tfwd

torch.set_num_threads(1)
P = 5


def _seqs(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, P, rng.randint(3, 12)).tolist() for _ in range(n)]


def _graphs(g):
    """(biphone bigram StateGraph, trigram x biphone composed StateGraph)
    through one package."""
    seqs = _seqs()
    topo = g.ChainTopology(P)
    dense = g.build_denominator_graph(g.estimate_phone_lm(seqs, P), topo,
                                      g.BiphoneTree(P))
    lm3 = g.estimate_ngram_phone_lm(seqs, P, order=3, num_extra_lm_states=20)
    composed = g.compile_denominator_fsa(lm3, topo,
                                         g.BiphoneTree(P)).to_state_graph()
    return {"biphone": dense, "composed": composed}


@pytest.fixture(scope="module")
def graphs():
    return _graphs(jgraphs), _graphs(tgraphs)


def _arcs(trans, seed):
    """The graph's arcs (src, dst, w) in a seeded order."""
    src, dst = np.nonzero(trans)
    order = np.random.RandomState(seed).permutation(len(src))
    return src[order], dst[order], trans[src, dst][order]


@pytest.mark.parametrize("build", ["from_graph", "from_arcs"])
@pytest.mark.parametrize("name", ["biphone", "composed"])
def test_sparse_tables_equal_jax(graphs, name, build):
    jg, tg = graphs[0][name], graphs[1][name]
    np.testing.assert_array_equal(tg.trans, jg.trans)
    if build == "from_graph":
        j = jfwd.SparseDenGraph.from_graph(jg)
        t = tfwd.SparseDenGraph.from_graph(tg, "cpu")
    else:
        src, dst, w = _arcs(jg.trans, seed=3)
        j = jfwd.SparseDenGraph.from_arcs(jg.num_states, src, dst, w,
                                          jg.state_pdf, jg.init, jg.final)
        t = tfwd.SparseDenGraph.from_arcs(tg.num_states, src, dst, w,
                                          tg.state_pdf, tg.init, tg.final,
                                          "cpu")
    for f in ("in_src", "in_w", "state_pdf", "init", "final"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("name", ["biphone", "composed"])
def test_forward_score_sparse_matches_jax(graphs, name, leaky):
    """logZ and d(sum logZ)/d obs at atol 2e-5; logZ also equals the
    port's dense scan of the same graph (rtol 1e-5)."""
    jg, tg = graphs[0][name], graphs[1][name]
    obs = (np.random.RandomState(1).randn(3, 12, tg.num_pdfs) * 2
           ).astype(np.float32)
    js = jfwd.SparseDenGraph.from_graph(jg)
    jz = jfwd.forward_score_sparse(jnp.asarray(obs), js, leaky)
    jgrad = jax.grad(lambda o: jnp.sum(
        jfwd.forward_score_sparse(o, js, leaky)))(jnp.asarray(obs))
    ts = tfwd.SparseDenGraph.from_graph(tg, "cpu")
    o = torch.from_numpy(obs).requires_grad_(True)
    tz = tfwd.forward_score_sparse(o, ts, leaky)
    tgrad, = torch.autograd.grad(tz.sum(), o)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=2e-5)
    zd = tfwd.forward_score(torch.from_numpy(obs),
                            torch.from_numpy(tg.trans),
                            torch.from_numpy(tg.state_pdf).long(),
                            torch.from_numpy(tg.init),
                            torch.from_numpy(tg.final), leaky_coef=leaky)
    np.testing.assert_allclose(tz.detach().numpy(), zd.numpy(), rtol=1e-5)


def test_chain_objective_takes_a_sparse_den(graphs):
    """chain_objective's SparseDenGraph branch: logz_den equals the
    reference's on the same outputs (rtol 1e-5)."""
    from tdnnf_nas_torch.train.objective import (ChainObjectiveConfig,
                                                 chain_objective)
    from tests.test_torch_dense_numerator import _dense_sup

    jg, tg = graphs[0]["biphone"], graphs[1]["biphone"]
    sup, out = _dense_sup(tg.num_pdfs)
    js = jfwd.SparseDenGraph.from_graph(jg)
    want = jfwd.forward_score_sparse(jnp.asarray(out), js, 0.1)
    _, m = chain_objective(torch.from_numpy(out), torch.from_numpy(out),
                           tfwd.SparseDenGraph.from_graph(tg, "cpu"), sup,
                           ChainObjectiveConfig())
    t = out.shape[1]
    np.testing.assert_allclose(float(m["logz_den"]),
                               float(jnp.mean(want)) / t, rtol=1e-5)
