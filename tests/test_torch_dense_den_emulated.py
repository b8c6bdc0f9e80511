"""The dense-den kernels' arithmetic and tile plan, on the CPU.

``dense_scan_fwd_emulated`` / ``dense_scan_bwd_emulated`` repeat what
``csrc/dense_den.cu`` computes (3xTF32 products per depth slice of the
plan, partials summed in slice order, the forward's deferred
normalization, the adjoint's row dot from per-tile partial dots); they are
held against float64, the plain scans and the JAX package's Pallas pair
(interpret mode).  ``_plan`` is the layout the kernels are launched with:
its tiles cover trans once and fit a block's shared memory.  Tolerances
are those of ``tests/test_torch_cuda_dense_den.py``: logZ within 1e-3,
alphas rtol 1e-3, scales rtol 1e-4, the obs gradient within 1e-3 of its
largest entry.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnnf_nas_torch.ops import dense_den_cuda as ddc
from tdnnf_nas_torch.tools import dense_den_phases
from tests.test_torch_dense_den import _args, _port_pallas

torch.set_num_threads(1)

_SMEM = 232_448  # bytes of shared memory an H100 block can use


def _inputs(s, b=5, t=9, dtype=torch.float32, seed=0):
    """A random dense graph (rows of trans stochastic, sparse-ish), max-
    normalized log obs and per-row cotangents."""
    rng = np.random.RandomState(seed)
    trans = rng.rand(s, s) * (rng.rand(s, s) < 0.3)
    trans[np.arange(s), np.arange(s)] += 0.3
    trans /= trans.sum(axis=1, keepdims=True)
    init = rng.rand(s)
    init /= init.sum()
    logits = rng.randn(b, t, s) * 2
    obs = np.maximum(logits - logits.max(-1, keepdims=True), -30.0)
    gbar = rng.rand(b) + 0.5

    def tt(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    return (tt(obs.astype(np.float32)), tt(trans.astype(np.float32)),
            tt(init.astype(np.float32)), tt(np.ones(s, np.float32)),
            tt(gbar.astype(np.float32)))


def _reference(kind, obs, trans, init, final, gbar, leaky):
    """(logz, alphas, cs, grad) of the plain scans in float32 or float64."""
    if kind == "float64":
        obs, trans, init, final, gbar = (
            x.double() for x in (obs, trans, init, final, gbar))
    z, al, cs = ddc.dense_scan_fwd_plain(obs, trans, init, final, leaky)
    g = ddc.dense_scan_bwd_plain(obs, trans, final, al, cs, gbar)
    return z, al, cs, g


@pytest.mark.parametrize("reference", ["float64", "plain"])
@pytest.mark.parametrize("leaky", [0.0, 0.1])
@pytest.mark.parametrize("s", [19, 75, 130])
def test_emulated_scans_match(s, leaky, reference):
    obs, trans, init, final, gbar = _inputs(s)
    ze, ae, ce = ddc.dense_scan_fwd_emulated(obs, trans, init, final, leaky)
    ge = ddc.dense_scan_bwd_emulated(obs, trans, final, ae, ce, gbar)
    zr, ar, cr, gr = _reference(reference, obs, trans, init, final, gbar,
                                leaky)
    assert ze.dtype == ae.dtype == ge.dtype == torch.float32
    torch.testing.assert_close(ze.double(), zr.double(), rtol=1e-5,
                               atol=1e-3)
    torch.testing.assert_close(ae.double(), ar.double(), rtol=1e-3,
                               atol=1e-6)
    torch.testing.assert_close(ce.double(), cr.double(), rtol=1e-4,
                               atol=1e-30)
    gmax = float(gr.abs().max())
    assert float((ge.double() - gr.double()).abs().max()) <= (
        1e-3 * max(gmax, 1.0))


@pytest.mark.parametrize("leaky", [0.0, 0.1])
def test_emulated_scans_match_jax_pallas(leaky):
    """The port's pallas_forward_score with the emulated scans in place of
    the kernels, against JAX's Pallas pair in interpret mode (the bars of
    tests/test_torch_dense_den.py: logZ rtol 1e-4 atol 1e-4, gradients
    rtol 1e-3 atol 1e-5)."""
    from jax.experimental.pallas import tpu as pltpu
    from tdnnf_nas_tpu.ops.pallas_fwdbwd import pallas_forward_score as jpal

    rng = np.random.RandomState(1)
    s, p, t, b = 12, 6, 6, 3
    trans, state_pdf, init, final = _args(rng, s, p)
    obs = rng.randn(b, t, p).astype(np.float32) * 2
    w = rng.rand(b).astype(np.float32) + 0.5
    emulated = (ddc.dense_scan_fwd_emulated, ddc.dense_scan_bwd_emulated)
    with mock.patch.object(ddc, "_scan_impl", lambda device: emulated):
        z, g = _port_pallas(obs, trans, state_pdf, init, final, leaky, w)

    jargs = [jnp.asarray(a) for a in (trans, state_pdf, init, final)]

    def jloss(o):
        return jnp.sum(jnp.asarray(w) * jpal(o, *jargs, leaky_coef=leaky))

    with pltpu.force_tpu_interpret_mode():
        zp = np.asarray(jpal(jnp.asarray(obs), *jargs, leaky_coef=leaky))
        gp = np.asarray(jax.grad(jloss)(jnp.asarray(obs)))
    np.testing.assert_allclose(z, zp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, gp, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("adjoint", ["plain", "emulated"])
def test_adjoint_of_trans_is_the_autograd_gradient(adjoint):
    """The adjoints take the forward's trans (not its transpose): on a
    non-symmetric graph in float64 each equals autograd's gradient of
    sum(gbar * logZ) through the plain forward scan (rtol 1e-10; the
    emulation's 3xTF32 products within 1e-3 of the largest entry)."""
    obs, trans, init, final, gbar = (
        x.double() for x in _inputs(40, t=5))
    assert not torch.equal(trans, trans.T)
    o = obs.clone().requires_grad_(True)
    z, al, cs = ddc.dense_scan_fwd_plain(o, trans, init, final, 0.1)
    want, = torch.autograd.grad((gbar * z).sum(), o)
    if adjoint == "plain":
        got = ddc.dense_scan_bwd_plain(obs, trans, final, al.detach(),
                                       cs.detach(), gbar)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    else:
        f = [x.float() for x in (obs, trans, init, final, gbar)]
        _, ae, ce = ddc.dense_scan_fwd_emulated(f[0], f[1], f[2], f[3], 0.1)
        got = ddc.dense_scan_bwd_emulated(f[0], f[1], f[3], ae, ce, f[4])
        gmax = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-3 * max(
            gmax, 1.0)


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("direction", ["forward", "adjoint"])
@pytest.mark.parametrize("s, sms", [(19, 132), (130, 132), (2208, 132),
                                    (2304, 132), (3000, 132), (500, 16)])
def test_plan_covers_trans_once(s, sms, direction):
    """Every (k, n) of trans lies in exactly one tile: forward tiles are
    trans[depth, out], the adjoint's trans[out, depth]."""
    pl = ddc._plan(64, s, sms)
    assert pl.out_w == 192 and pl.depth_w % 8 == 0 and pl.chunk % 8 == 0
    assert pl.n_out == -(-s // pl.out_w)
    assert pl.n_depth == -(-s // pl.depth_w)
    if pl.resident:
        assert pl.tiles <= sms and pl.chunk == pl.depth_w
    count = np.zeros((s, s), np.int32)
    for o0, o1, d0, d1 in pl.tile_ranges(s):
        assert o0 < o1 and d0 < d1
        if direction == "forward":
            count[d0:d1, o0:o1] += 1
        else:
            count[o0:o1, d0:d1] += 1
    assert int(count.min()) == int(count.max()) == 1


@pytest.mark.parametrize("b", [32, 64])
def test_plan_fits_shared_memory_at_the_flagship(b):
    """S = 2,208 on 132 SMs: 12 x 11 resident tiles of 192 x 208 whose
    tile and stages fit a block's 232,448 bytes."""
    pl = ddc._plan(b, 2208, 132)
    assert (pl.n_out, pl.n_depth, pl.depth_w) == (12, 11, 208)
    assert pl.resident and pl.tiles == 132
    assert pl.smem_bytes == ddc._smem_bytes(pl.chunk, pl.depth_w, True)
    assert pl.smem_bytes == 222_720 <= _SMEM  # as _plan's docstring says
    assert ddc._plan(b, 2208, 132, _SMEM, ddc._smem_bytes) == pl


def test_plan_switches_to_global_tiles_where_documented():
    """On 132 SMs the tile is resident exactly for S <= RESIDENT_MAX_S
    (2,304, as _plan's docstring says); above it the same kernel reads
    the tile from global memory with the A stage in chunks of 256."""
    assert ddc.RESIDENT_MAX_S == 2304 and "2,304" in ddc._plan.__doc__
    for s in range(1, 4001):
        pl = ddc._plan(64, s, 132)
        assert pl.resident == (s <= ddc.RESIDENT_MAX_S), s
        assert pl.smem_bytes <= _SMEM, s
        if not pl.resident:
            assert pl.chunk == min(pl.depth_w, 256)


def test_plan_follows_the_shared_memory_limit():
    """The limit and the size function are the plan's inputs: a block
    limit below the flagship tile's 222,720 bytes reads tiles from global
    memory instead."""
    assert ddc._plan(64, 2208, 132, 222_720).resident
    pl = ddc._plan(64, 2208, 132, 222_719)
    assert not pl.resident and pl.chunk == 208 and pl.smem_bytes <= 222_719
    assert ddc._plan(64, 2208, 132, 10**6, lambda c, d, r: 10**6).resident


def test_plan_refuses_bad_requests():
    for args in ((0, 10, 132), (4, 0, 132), (4, 10, 0)):
        with pytest.raises(ValueError):
            ddc._plan(*args)


@pytest.mark.parametrize("variant", sorted(dense_den_phases.VARIANTS))
def test_phase_tool_instruments_the_kernels(variant):
    """Every variant of tools/dense_den_phases.py finds its cut in the
    kernels' source (a stamp at the kernel's start and in the barrier)."""
    out = dense_den_phases.instrumented_source(ddc._SRC.read_text(), variant)
    assert out.count("%globaltimer") == 2
    assert "phases_read" in out
