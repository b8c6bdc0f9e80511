"""Port's blocked denominator (plain scan on CPU) vs the JAX package.

Same seeded inputs through JAX's ``forward_score_blocked`` (XLA scan),
``forward_score_blocked_pallas`` (Pallas kernels in interpret mode) and
the port's ``forward_score_blocked``; the host export ``to_blocked`` of the
port must equal the JAX package's array for array.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import graphs as jgraphs
from tdnnf_nas_tpu.ops import fwdbwd as jfwd
from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph as HostBlocked
from tdnnf_nas_torch.ops import fwdbwd as tfwd
from tests.test_ngram_den import _seqs

torch.set_num_threads(1)

_FIELDS = ("w_blocks", "perm", "perm_inv", "init_pos", "pdf_virtual",
           "init_virtual", "final_virtual")


@pytest.fixture(scope="module")
def graphs():
    """The graph of tests/test_pallas_fwdbwd.py: p=5, order-3 LM, biphone
    tree, superblocks=3, enter_pad=2 — built by both packages."""
    p = 5
    seqs = _seqs(p, seed=2)
    jlm = jgraphs.estimate_ngram_phone_lm(seqs, p, order=3,
                                          num_extra_lm_states=20)
    jcomp = jgraphs.compile_denominator_fsa(jlm, jgraphs.ChainTopology(p),
                                            jgraphs.BiphoneTree(p))
    jblk = jcomp.to_blocked(superblocks=3, enter_pad=2)
    tlm = tgraphs.estimate_ngram_phone_lm(seqs, p, order=3,
                                          num_extra_lm_states=20)
    tcomp = tgraphs.compile_denominator_fsa(tlm, tgraphs.ChainTopology(p),
                                            tgraphs.BiphoneTree(p))
    tblk = tcomp.to_blocked(superblocks=3, enter_pad=2)
    return jblk, tblk, jgraphs.BiphoneTree(p).num_pdfs


def _obs(num_pdfs, seed=1, b=3, t=10):
    return np.random.RandomState(seed).randn(b, t, num_pdfs).astype(np.float32)


def _port_score_and_grad(tblk, obs, leaky, obs_bf16=False, w=None):
    g = tfwd.BlockedDenGraph.from_host(tblk, "cpu")
    o = torch.tensor(obs, requires_grad=True)
    z = tfwd.forward_score_blocked(o, g, leaky_coef=leaky, obs_bf16=obs_bf16)
    wt = torch.ones_like(z) if w is None else torch.tensor(w)
    (z * wt).sum().backward()
    return z.detach().numpy(), o.grad.numpy()


def test_to_blocked_matches_jax_exactly(graphs):
    jblk, tblk, _ = graphs
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(tblk, name),
                                      np.asarray(getattr(jblk, name)),
                                      err_msg=name)
        assert getattr(tblk, name).dtype == np.asarray(
            getattr(jblk, name)).dtype, name
    assert tblk.bcast_sel is None and jblk.bcast_sel is None
    assert (tblk.enter_pad, tblk.num_states, tblk.num_pdfs) == (
        jblk.enter_pad, jblk.num_states, jblk.num_pdfs)


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_blocked_score_and_grad_match_xla_and_pallas(graphs, leaky):
    """logZ and d logZ/d obs within atol 2e-5 (the reference's own bar,
    tests/test_pallas_fwdbwd.py) of the XLA twin and of the Pallas kernels."""
    from jax.experimental.pallas import tpu as pltpu

    jblk, tblk, num_pdfs = graphs
    obs = _obs(num_pdfs)
    # per-sequence weights, so the cotangents differ across the batch
    w = np.asarray([0.7, 1.0, 1.3], np.float32)
    z, g = _port_score_and_grad(tblk, obs, leaky, w=w)

    def jloss(fn):
        return lambda o: jnp.sum(jnp.asarray(w) * fn(o, jblk, leaky))

    zx = np.asarray(jfwd.forward_score_blocked(jnp.asarray(obs), jblk, leaky))
    gx = np.asarray(jax.grad(jloss(jfwd.forward_score_blocked))(
        jnp.asarray(obs)))
    with pltpu.force_tpu_interpret_mode():
        zp = np.asarray(jfwd.forward_score_blocked_pallas(
            jnp.asarray(obs), jblk, leaky))
        gp = np.asarray(jax.grad(jloss(jfwd.forward_score_blocked_pallas))(
            jnp.asarray(obs)))
    np.testing.assert_allclose(z, zx, atol=2e-5)
    np.testing.assert_allclose(z, zp, atol=2e-5)
    np.testing.assert_allclose(g, gx, atol=2e-5)
    np.testing.assert_allclose(g, gp, atol=2e-5)


def test_blocked_obs_bf16_matches_jax(graphs):
    """bf16 expanded observations: both sides round the same f32 values to
    bf16, but exp() may differ by one f32 ulp between the libraries and
    then round to a neighbouring bf16 value (relative 2^-8), and the
    gather's backward accumulates in bf16 on both sides in different
    orders; hence looser bars than the f32 case."""
    jblk, tblk, num_pdfs = graphs
    obs = _obs(num_pdfs, t=12)
    z, g = _port_score_and_grad(tblk, obs, 0.1, obs_bf16=True)
    zj = np.asarray(jfwd.forward_score_blocked(jnp.asarray(obs), jblk, 0.1,
                                               obs_bf16=True))
    gj = np.asarray(jax.grad(lambda o: jnp.sum(jfwd.forward_score_blocked(
        o, jblk, 0.1, obs_bf16=True)))(jnp.asarray(obs)))
    np.testing.assert_allclose(z, zj, atol=1e-3)
    np.testing.assert_allclose(g, gj, atol=1e-2)


def test_blocked_wildcard_term_matches_xla():
    """The committed +-1 graph of tests/test_ngram_den.py carries the rank-R
    wildcard term: the port's plain scan (fed the JAX package's export)
    must match the XLA twin in logZ and gradient."""
    P = 6
    rng = np.random.RandomState(0)
    seqs = [list(rng.randint(0, P, rng.randint(4, 12))) for _ in range(60)]
    feats = [rng.randn(len(s) * 3, 8).astype(np.float32) for s in seqs]
    begins = [list(range(len(s))) for s in seqs]
    stats = jgraphs.accumulate_cross_triphone_stats(feats, seqs, begins, P, 1)
    tree = jgraphs.build_clustered_cross_triphone_tree(stats, num_leaves=30)
    lm = jgraphs.estimate_ngram_phone_lm(seqs, P, order=4,
                                         num_extra_lm_states=20)
    comp = jgraphs.compile_denominator_fsa(lm, jgraphs.ChainTopology(P), tree)
    jblk = comp.to_blocked()
    assert jblk.bcast_sel is not None
    host = HostBlocked(
        **{k: np.asarray(getattr(jblk, k)) for k in _FIELDS},
        bcast_sel=np.asarray(jblk.bcast_sel),
        bcast_vec=np.asarray(jblk.bcast_vec),
        enter_pad=jblk.enter_pad, num_states=jblk.num_states,
        num_pdfs=jblk.num_pdfs)
    obs = rng.randn(3, 10, tree.num_pdfs).astype(np.float32)
    z, g = _port_score_and_grad(host, obs, 0.1)
    zj = np.asarray(jfwd.forward_score_blocked(jnp.asarray(obs), jblk, 0.1))
    gj = np.asarray(jax.grad(lambda o: jnp.sum(jfwd.forward_score_blocked(
        o, jblk, 0.1)))(jnp.asarray(obs)))
    np.testing.assert_allclose(z, zj, atol=2e-5)
    np.testing.assert_allclose(g, gj, atol=2e-5)


def test_cpu_dispatch_uses_plain_scan(graphs):
    """A CPU tensor takes the plain scan; the kernel counters stay put."""
    from tdnnf_nas_torch.ops import blocked_den_cuda as bdc

    _, tblk, num_pdfs = graphs
    before = (bdc.blocked_den_fwd_cuda.launches,
              bdc.blocked_den_bwd_cuda.launches)
    _port_score_and_grad(tblk, _obs(num_pdfs), 0.1)
    assert (bdc.blocked_den_fwd_cuda.launches,
            bdc.blocked_den_bwd_cuda.launches) == before
    assert bdc._scan_impl(torch.device("cpu")) == (
        bdc.blocked_scan_fwd_plain, bdc.blocked_scan_bwd_plain)
    assert bdc._scan_impl(torch.device("cuda")) == (
        bdc.blocked_den_fwd_cuda, bdc.blocked_den_bwd_cuda)
    with pytest.raises(ValueError):
        bdc._scan_impl(torch.device("meta"))
