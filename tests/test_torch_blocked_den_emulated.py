"""The blocked-den kernels' arithmetic, emulated in torch on the CPU, held
against float64 and against the plain scan.

``split_tf32_matmul`` is the kernels' 3xTF32 block product;
``blocked_scan_fwd_emulated`` / ``blocked_scan_bwd_emulated`` repeat the
kernels' deferred normalization, split partial sums and row dot through
the gathered alphas.  The scans are held to ``chip_smoke.py``'s own
tolerances: logZ within 1e-3, the obs gradient within 1e-3 (float32) and
1e-2 (bf16) of its largest entry, alphas within rtol 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.ops import fwdbwd as jfwd

from tdnnf_nas_torch import graphs as tgraphs
from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph
from tests.test_ngram_den import _seqs

torch.set_num_threads(1)


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11),
                      one + 2 ** -11 - 2 ** -23, 3.0 + 2 ** -10 + 2 ** -11],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2 ** -10, -(one + 2 ** -10), one,
                         3.0 + 2 ** -9], dtype=torch.float32)
    assert torch.equal(bdc.tf32_round(x), want)
    # ten mantissa bits: the low 13 bits are zero
    r = bdc.tf32_round(torch.randn(1000))
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("k", [8, 538, 2690])
def test_split_product_is_float32_accurate(k):
    """Against float64, relative to |x| @ |w|: within the source note's
    bound 2^-20 + 3K * 2^-24, within twice a float32 product's error, and
    far inside one TF32 pass's."""
    rng = np.random.RandomState(k)
    x = torch.tensor(rng.rand(3, 16, k).astype(np.float32))
    w = torch.tensor((rng.rand(3, k, 24) * (rng.rand(3, k, 24) < 0.3))
                     .astype(np.float32))
    exact = x.double() @ w.double()
    scale = x.double().abs() @ w.double().abs()
    live = scale > 0

    def rel_err(y):
        return float(((y.double() - exact).abs()[live] / scale[live]).max())

    split = rel_err(bdc.split_tf32_matmul(x, w))
    assert split <= 2.0 ** -20 + 3 * k * 2.0 ** -24
    assert split <= 2 * rel_err(x @ w) + 2.0 ** -22
    one_pass = rel_err(bdc.tf32_round(x) @ bdc.tf32_round(w))
    assert one_pass >= 16 * split


def test_row_dot_through_the_gather():
    """sum_v (L^T v)[v] alpha[v] == sum_j u[j] beta0[j]: the identity the
    adjoint kernel takes its row dot from (perm_inv inverts perm)."""
    rng = np.random.RandomState(3)
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, 3, 30, 17, 3, 20), "cpu")
    c, nsrc, ndp = g.w_blocks.shape
    u = torch.tensor(rng.randn(4, c * nsrc))
    alpha = torch.tensor(rng.rand(4, c * ndp))
    lhs = (bdc._assemble(u, g) * alpha).sum(-1)
    rhs = (u * bdc._gather_beta(alpha, g)).sum(-1)
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


def _ngram_graph():
    """The graph of tests/test_pallas_fwdbwd.py: p=5, order-3 LM, biphone
    tree, superblocks=3, enter_pad=2."""
    p = 5
    lm = tgraphs.estimate_ngram_phone_lm(_seqs(p, seed=2), p, order=3,
                                         num_extra_lm_states=20)
    comp = tgraphs.compile_denominator_fsa(lm, tgraphs.ChainTopology(p),
                                           tgraphs.BiphoneTree(p))
    return comp.to_blocked(superblocks=3, enter_pad=2)


_GRAPHS = {
    # (B, T, host graph maker): ragged random graphs and the n-gram den
    "random": (5, 9, lambda rng: random_blocked_graph(rng, 2, 70, 40, 3, 50)),
    "random_t2": (3, 2, lambda rng: random_blocked_graph(rng, 3, 45, 21, 3,
                                                         30)),
    "ngram": (4, 10, lambda rng: _ngram_graph()),
    # the wildcard (rank-R broadcast) term: random groups, R = 1 and the
    # kernels' largest R
    "random_wild1": (4, 7, lambda rng: random_blocked_graph(
        rng, 2, 60, 30, 3, 40, groups=1)),
    "random_wild4": (3, 6, lambda rng: random_blocked_graph(
        rng, 3, 45, 21, 2, 30, groups=bdc.MAX_WILDCARD_GROUPS)),
}


@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_emulated_scans_match_plain(name, obs_dtype):
    b, t, make = _GRAPHS[name]
    rng = np.random.RandomState(0)
    host = make(rng)
    g = BlockedDenGraph.from_host(host, "cpu")
    p = host.num_pdfs
    logits = torch.tensor(rng.randn(b, t, p).astype(np.float32) * 2)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=-30.0))
    obs_v = obs.to(obs_dtype).index_select(
        -1, g.pdf_virtual.long()).contiguous()
    gbar = torch.tensor(rng.rand(b).astype(np.float32) + 0.5)
    for leaky in (0.0, 0.1):
        ze, ae, ce = bdc.blocked_scan_fwd_emulated(obs_v, g, leaky)
        zp, ap, cp = bdc.blocked_scan_fwd_plain(obs_v, g, leaky)
        assert float((ze - zp).abs().max()) <= 1e-3
        torch.testing.assert_close(ae, ap.float(), rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(ce, cp.float(), rtol=1e-4, atol=1e-30)
        for splits in (1, 4):
            ge = bdc.blocked_scan_bwd_emulated(obs_v, g, ae, ce, gbar,
                                               splits=splits)
            gp = bdc.blocked_scan_bwd_plain(obs_v, g, ap, cp, gbar)
            assert ge.dtype == obs_dtype
            gmax = float(gp.float().abs().max())
            tol = (1e-3 if obs_dtype == torch.float32 else 1e-2)
            assert float((ge.float() - gp.float()).abs().max()) <= (
                tol * max(gmax, 1.0))


def test_emulated_scans_refuse_wildcard():
    """A wildcard term the kernels cannot take: more groups than
    MAX_WILDCARD_GROUPS (the error names R), or a slot in two groups."""
    rng = np.random.RandomState(1)
    host = random_blocked_graph(rng, 1, 8, 4, 2, 5)
    r = bdc.MAX_WILDCARD_GROUPS + 1
    host.bcast_sel = np.zeros((8, r), np.float32)
    host.bcast_vec = np.zeros((r, 16), np.float32)
    g = BlockedDenGraph.from_host(host, "cpu")
    with pytest.raises(ValueError, match=f"R={r}"):
        bdc.blocked_scan_fwd_emulated(torch.rand(1, 3, 16), g, 0.1)
    host.bcast_sel = np.zeros((8, 2), np.float32)
    host.bcast_sel[3] = 1.0
    host.bcast_vec = np.zeros((2, 16), np.float32)
    g = BlockedDenGraph.from_host(host, "cpu")
    with pytest.raises(ValueError, match="at most one group"):
        bdc.blocked_scan_fwd_emulated(torch.rand(1, 3, 16), g, 0.1)


def _sequential_gather(alpha, g):
    """The kernels' gather from a whole row: each slot's enter slots summed
    in slot order, then its loop slot; a sentinel slot takes its loop slot
    alone."""
    c, nsrc, ndp = g.w_blocks.shape
    r = g.enter_pad
    ndpos = (ndp - nsrc) // r
    j = torch.arange(c * nsrc)
    cj = j // nsrc
    x = alpha[:, cj * ndp + r * ndpos + (j - cj * nsrc)]
    k = g.perm.long()
    valid = k < c * ndpos
    kc = torch.where(valid, k // ndpos, 0)
    base = kc * ndp + (torch.where(valid, k, 0) - kc * ndpos)
    acc = alpha[:, base]
    for i in range(1, r):
        acc = acc + alpha[:, base + i * ndpos]
    return torch.where(valid, acc + x, x)


@pytest.mark.parametrize("parts", [1, 2, 3, 16])
@pytest.mark.parametrize("groups", [0, 1])
def test_part_staged_gather_is_the_whole_row_gather(parts, groups):
    """A row staged part by part (rows past shared memory) through the
    host-built gather plan gathers the same bits as the row staged whole;
    the plan holds each of a part's slots once, sorted by perm, sentinels
    last; what the parts stage is each enter and loop slot of the row at
    most once (perm is injective); both gathers hold the plain gather to
    float32 rounding."""
    rng = np.random.RandomState(4)
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, 3, 45, 21, 4, 30, groups=groups), "cpu")
    alpha = torch.tensor(rng.rand(5, g.w_blocks.shape[0]
                                  * g.w_blocks.shape[2]).astype(np.float32))
    got = bdc.gather_parts_emulated(alpha, g, parts)
    assert torch.equal(got, _sequential_gather(alpha, g))
    torch.testing.assert_close(got, bdc._gather_beta(alpha, g), rtol=1e-6,
                               atol=0.0)
    c, nsrc, ndp = g.w_blocks.shape
    cs = c * nsrc
    plan = bdc.gather_plan(g, parts)
    assert plan.shape == (cs, 2) and plan.dtype == torch.int32
    assert bdc.gather_plan(g, parts) is plan  # made once per graph
    staged = []
    for h in range(parts):
        j0, j1 = cs * h // parts, cs * (h + 1) // parts
        i, k = plan[j0:j1, 0].long(), plan[j0:j1, 1].long()
        # each of the part's slots once, the valid ones by ascending perm
        assert torch.equal(torch.sort(i).values, torch.arange(j1 - j0))
        kv = k[k >= 0]
        assert torch.equal(kv, torch.sort(kv).values)
        assert bool((k[len(kv):] == -1).all())
        assert torch.equal(k, torch.where(g.perm[j0:j1][i] < c * (
            (ndp - nsrc) // g.enter_pad), g.perm[j0:j1][i], -1).long())
        staged.append(bdc.part_stage_rows(g, j0, j1, plan))
    staged = torch.cat(staged)
    staged = staged[staged >= 0]
    assert len(torch.unique(staged)) == len(staged)
    assert int(staged.max()) < c * ndp


# the reference's own bar for its kernels against the XLA core
# (tests/test_pallas_fwdbwd.py): atol 2e-5 on logZ and the obs gradient
_CORE = {
    "plain": (4, 7, lambda rng: random_blocked_graph(rng, 2, 70, 40, 3, 50)),
    "wildcard": (4, 7, lambda rng: random_blocked_graph(
        rng, 2, 60, 30, 3, 40, groups=1)),
}


@functools.lru_cache(maxsize=None)
def _core_case(name):
    """(graph, obs, gbar, JAX's logZ and obs gradient) of ``_CORE[name]``:
    prob-space obs through ``_blocked_score_core``, leaky 0.1."""
    b, t, make = _CORE[name]
    rng = np.random.RandomState(0)
    host = make(rng)
    logits = rng.randn(b, t, host.num_pdfs).astype(np.float32) * 2
    obs = np.exp(np.maximum(logits - logits.max(-1, keepdims=True), -30.0))
    obs_v = np.ascontiguousarray(obs[:, :, host.pdf_virtual])
    gbar = rng.rand(b).astype(np.float32) + 0.5

    def core(o):
        opt = (lambda x: None if x is None else jnp.asarray(x))
        return jfwd._blocked_score_core(
            o, jnp.asarray(host.w_blocks), jnp.asarray(host.perm),
            jnp.asarray(host.perm_inv), jnp.asarray(host.init_pos),
            jnp.asarray(host.init_virtual), jnp.asarray(host.final_virtual),
            opt(host.bcast_sel), opt(host.bcast_vec), 0.1, host.enter_pad)

    zj, vjp = jax.vjp(core, jnp.asarray(obs_v))
    gj, = vjp(jnp.asarray(gbar))
    g = BlockedDenGraph.from_host(host, "cpu")
    return (g, torch.tensor(obs_v), torch.tensor(gbar), np.asarray(zj),
            np.asarray(gj))


@pytest.mark.parametrize("bwd_splits", [1, 2, 3])
@pytest.mark.parametrize("fwd_splits", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(_CORE))
def test_emulated_split_scans_match_jax_core(name, fwd_splits, bwd_splits):
    """The kernels' arithmetic with the forward's product split over its
    depth (the splits' partial products summed in order, the wildcard term
    in split 0, then times obs) and the adjoint's over d, against JAX's
    ``_blocked_score_core`` and its custom VJP."""
    g, obs_v, gbar, zj, gj = _core_case(name)
    ze, ae, ce = bdc.blocked_scan_fwd_emulated(obs_v, g, 0.1,
                                               splits=fwd_splits)
    ge = bdc.blocked_scan_bwd_emulated(obs_v, g, ae, ce, gbar,
                                       splits=bwd_splits)
    np.testing.assert_allclose(ze.numpy(), zj, rtol=0, atol=2e-5)
    np.testing.assert_allclose(ge.numpy(), gj, rtol=0, atol=2e-5)
