"""Port's dense denominator (host graphs, plain scans on CPU) vs the JAX
package.

Host arrays (bigram LM, stationary init, dense den graphs, numerator init
lookups) must equal the JAX package's exactly.  The device math runs the
port's ``pallas_forward_score`` (plain versions of the dense-den kernels on
the CPU) and ``forward_score`` against JAX's ``pallas_forward_score``
(Pallas in interpret mode) and ``forward_score`` on the same seeded inputs,
with the reference's own bars (``tests/test_pallas_fwdbwd.py``,
``tests/test_fwdbwd.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import graphs as jgraphs
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.ops import dense_den_cuda as ddc
from tdnnf_nas_torch.ops import fwdbwd as tfwd
from tests.test_ngram_den import _seqs
from tests.test_pallas_fwdbwd import _random_graph

torch.set_num_threads(1)

_P = 5


def _trees(pkg, kind):
    return (pkg.ContextIndependentTree(_P) if kind == "ci"
            else pkg.BiphoneTree(_P))


@pytest.fixture(scope="module")
def host():
    """Bigram LM and dense den graphs (CI and biphone trees) built by both
    packages from one seeded phone corpus."""
    seqs = _seqs(_P, seed=3)
    jlm = jgraphs.estimate_phone_lm(seqs, _P)
    tlm = tgraphs.estimate_phone_lm(seqs, _P)
    dens = {}
    for kind in ("ci", "biphone"):
        dens[kind] = (
            jgraphs.build_denominator_graph(jlm, jgraphs.ChainTopology(_P),
                                            _trees(jgraphs, kind)),
            tgraphs.build_denominator_graph(tlm, tgraphs.ChainTopology(_P),
                                            _trees(tgraphs, kind)))
    return jlm, tlm, dens


def _equal(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_estimate_phone_lm_matches_jax_exactly(host):
    jlm, tlm, _ = host
    _equal(tlm.probs, jlm.probs, "probs")
    _equal(tlm.final, jlm.final, "final")
    assert tlm.num_phones == jlm.num_phones and tlm.order == 2
    for ctx in range(-1, _P):
        for q in range(_P):
            assert tlm.walk(ctx, q) == jlm.walk(ctx, q)
        assert tlm.final_prob(ctx) == jlm.final_prob(ctx)
    seq = [0, 3, 1, 4]
    assert tlm.log_prob(seq) == jlm.log_prob(seq)


@pytest.mark.parametrize("average", [False, True])
def test_stationary_init_matches_jax_exactly(average):
    from tdnnf_nas_tpu.graphs.fsa import stationary_init as jinit

    rng = np.random.RandomState(5)
    trans, _, init, _ = _random_graph(rng, 17, 4)
    for start in (None, init):
        _equal(tgraphs.stationary_init(trans, start=start, average=average),
               jinit(trans, start=start, average=average), "init")


@pytest.mark.parametrize("kind", ["ci", "biphone"])
def test_build_denominator_graph_matches_jax_exactly(host, kind):
    jg, tg = host[2][kind]
    for name in ("trans", "state_pdf", "init", "final"):
        _equal(getattr(tg, name), getattr(jg, name), name)
    assert tg.num_pdfs == jg.num_pdfs
    assert tg.num_states == jg.num_states == (
        2 * _P if kind == "ci" else _P * (_P + 1) + _P)
    tg.validate()


@pytest.mark.parametrize("kind", ["ci", "biphone"])
def test_den_init_lookup_matches_jax(host, kind):
    jg, tg = host[2][kind]
    jfn = jgraphs.den_init_lookup(jg, _P)
    tfn = tgraphs.den_init_lookup(tg, _P)
    for p in range(_P):
        for k in (0, 1):
            for left in range(-1, _P):
                assert tfn(p, k, left) == jfn(p, k, left)


def _args(rng, s, p):
    return [np.asarray(a) for a in _random_graph(rng, s, p)]


def _port_pallas(obs, trans, state_pdf, init, final, leaky, w):
    o = torch.tensor(obs, requires_grad=True)
    z = ddc.pallas_forward_score(
        o, torch.tensor(trans), torch.tensor(state_pdf, dtype=torch.int64),
        torch.tensor(init), torch.tensor(final), leaky_coef=leaky)
    (z * torch.tensor(w)).sum().backward()
    return z.detach().numpy(), o.grad.numpy()


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_pallas_forward_score_matches_jax(leaky):
    """logZ (rtol 1e-4, atol 1e-4), weighted-sum gradients (rtol 1e-3,
    atol 1e-5) against JAX's Pallas kernels (interpret mode) and the XLA
    autodiff path; per-frame posteriors sum to the weights (atol 1e-4)."""
    from jax.experimental.pallas import tpu as pltpu
    from tdnnf_nas_tpu.ops.pallas_fwdbwd import pallas_forward_score as jpal

    rng = np.random.RandomState(1)
    s, p, t, b = 12, 6, 6, 3
    trans, state_pdf, init, final = _args(rng, s, p)
    obs = rng.randn(b, t, p).astype(np.float32) * 2
    w = rng.rand(b).astype(np.float32) + 0.5
    z, g = _port_pallas(obs, trans, state_pdf, init, final, leaky, w)

    jargs = [jnp.asarray(a) for a in (trans, state_pdf, init, final)]

    def jloss(fn):
        return lambda o: jnp.sum(jnp.asarray(w) * fn(o, *jargs,
                                                     leaky_coef=leaky))

    with pltpu.force_tpu_interpret_mode():
        zp = np.asarray(jpal(jnp.asarray(obs), *jargs, leaky_coef=leaky))
        gp = np.asarray(jax.grad(jloss(jpal))(jnp.asarray(obs)))
    gx = np.asarray(jax.grad(jloss(jfwd.forward_score))(jnp.asarray(obs)))
    np.testing.assert_allclose(z, zp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, gp, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(g, gx, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(g.sum(-1), np.tile(w[:, None], (1, t)),
                               atol=1e-4)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_forward_score_shared_graph_matches_jax(leaky):
    """Plain autograd ``forward_score`` on a shared graph: logZ and the
    occupancy posteriors against JAX's XLA path; logZ against the numpy
    log-semiring reference on each sequence (rtol 5e-4, atol 5e-4, the
    bar of tests/test_fwdbwd.py)."""
    rng = np.random.RandomState(0)
    s, p, t, b = 12, 6, 9, 3
    args = _args(rng, s, p)
    obs = rng.randn(b, t, p).astype(np.float32) * 2
    targs = [torch.tensor(a) for a in args]
    z, gamma = tfwd.occupancy_posteriors(torch.tensor(obs), *targs,
                                         leaky_coef=leaky)
    zj, gj = jfwd.occupancy_posteriors(
        jnp.asarray(obs), *[jnp.asarray(a) for a in args], leaky_coef=leaky)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(gj), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(gamma.sum(-1).numpy(), 1.0, atol=1e-4)
    for i in range(b):
        ref = tfwd.forward_score_reference(obs[i], *args, leaky_coef=leaky)
        assert ref == jfwd.forward_score_reference(obs[i], *args,
                                                   leaky_coef=leaky)
        np.testing.assert_allclose(float(z[i]), ref, rtol=5e-4, atol=5e-4)


def test_forward_score_batched_graphs_with_mask_matches_jax():
    """Per-sequence [B, S, S] graphs with an allow-mask, as the dense
    numerator uses them, against JAX's XLA path and the numpy reference."""
    rng = np.random.RandomState(2)
    s, p, t, b = 8, 5, 7, 3
    graphs = [_args(rng, s, p) for _ in range(b)]
    trans, state_pdf, init, final = (np.stack(x) for x in zip(*graphs))
    mask = (rng.rand(b, t, s) < 0.7).astype(np.float32)
    mask[:, :, 0] = 1.0
    obs = rng.randn(b, t, p).astype(np.float32)
    z = tfwd.forward_score(torch.tensor(obs), torch.tensor(trans),
                           torch.tensor(state_pdf), torch.tensor(init),
                           torch.tensor(final), mask=torch.tensor(mask))
    zj = jfwd.forward_score(jnp.asarray(obs), jnp.asarray(trans),
                            jnp.asarray(state_pdf), jnp.asarray(init),
                            jnp.asarray(final), mask=jnp.asarray(mask))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=5e-4,
                               atol=5e-4)
    for i in range(b):
        ref = tfwd.forward_score_reference(obs[i], trans[i], state_pdf[i],
                                           init[i], final[i], mask=mask[i])
        np.testing.assert_allclose(float(z[i]), ref, rtol=5e-4, atol=5e-4)


def test_cpu_dispatch_uses_plain_scan():
    """A CPU tensor takes the plain scans and the kernel counters stay put;
    the kernel wrappers refuse a CPU tensor before building anything."""
    rng = np.random.RandomState(3)
    trans, state_pdf, init, final = _args(rng, 10, 4)
    obs = rng.randn(2, 5, 4).astype(np.float32)
    before = (ddc.dense_den_fwd_cuda.launches,
              ddc.dense_den_bwd_cuda.launches)
    _port_pallas(obs, trans, state_pdf, init, final, 0.1,
                 np.ones(2, np.float32))
    assert (ddc.dense_den_fwd_cuda.launches,
            ddc.dense_den_bwd_cuda.launches) == before
    assert ddc._scan_impl(torch.device("cpu")) == (
        ddc.dense_scan_fwd_plain, ddc.dense_scan_bwd_plain)
    assert ddc._scan_impl(torch.device("cuda")) == (
        ddc.dense_den_fwd_cuda, ddc.dense_den_bwd_cuda)
    with pytest.raises(ValueError):
        ddc._scan_impl(torch.device("meta"))
    with pytest.raises(ValueError):
        ddc.dense_den_fwd_cuda(torch.zeros(2, 5, 10), torch.tensor(trans),
                               torch.tensor(init), torch.tensor(final), 0.1)


def test_chain_objective_refuses_unported_den():
    """Only the blocked and the dense dens are ported; any other graph
    (the reference's factored and sparse ones) raises TypeError."""
    from tdnnf_nas_torch.train import ChainObjectiveConfig, chain_objective

    out = torch.zeros(1, 2, 3)
    with pytest.raises(TypeError):
        chain_objective(out, out, object(), None, ChainObjectiveConfig())
