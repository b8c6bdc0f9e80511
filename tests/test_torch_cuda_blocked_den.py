"""CUDA blocked-den kernels vs their plain PyTorch versions (needs a GPU).

Skips without a CUDA device.  On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_blocked_den.py

(``--noconftest``: tests/conftest.py imports jax, which the GPU host lacks;
this file imports only torch and the port.)
"""

import numpy as np
import pytest
import torch

from tdnnf_nas_torch.graphs.den_graph import random_blocked_graph
from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, T, C, NSRC, NDPOS, R, P): ragged tiles, T=1, flagship; then the
    # persistent kernels' tiling edges: three 64-row tiles (B=130), B=1,
    # T=2, NSRC past one 160-wide tile and NDP past two, neither a
    # multiple of the 160-wide tiles or the 32-deep stages
    (3, 5, 2, 70, 40, 3, 50),
    (2, 1, 1, 17, 9, 2, 11),
    (64, 50, 7, 538, 538, 4, 6034),
    (130, 6, 3, 70, 40, 3, 50),
    (1, 7, 2, 45, 21, 3, 30),
    (5, 2, 3, 33, 10, 2, 40),
    (4, 4, 3, 161, 83, 2, 60),
])
def test_kernels_match_plain(cuda, shape, obs_dtype):
    """Tolerances: float32 sums in another order (no atomics, so kernel
    runs repeat bit for bit); bf16 obs gradients round to 2^-8 relative."""
    _match_plain(cuda, shape, obs_dtype, groups=0)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    # (B, T, C, NSRC, NDPOS, R, P), wildcard groups: small ragged graphs
    # at R = 1 and the kernels' largest R; the committed +-1 den's shape
    # (V = 61,512: rows read through L2, not staged), with and without
    # the term; B past one 64-row tile
    ((3, 5, 2, 70, 40, 3, 50), 1),
    ((5, 4, 3, 45, 21, 2, 30), 4),
    ((130, 3, 3, 70, 40, 3, 50), 2),
    ((64, 50, 22, 556, 560, 4, 430), 1),
    ((4, 6, 22, 556, 560, 4, 430), 0),
])
def test_kernels_match_plain_wildcard(cuda, shape, groups, obs_dtype):
    """The wildcard term and the rows too long for shared memory, at the
    same tolerances as test_kernels_match_plain."""
    _match_plain(cuda, shape, obs_dtype, groups=groups)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,want", [
    # (B, T, C, NSRC, NDPOS, R, P), wildcard groups, and what the plan
    # must pick there (forward, adjoint): (tile rows, splits > 1, rows
    # staged part by part).  LHUC's B = 16 den: 16-row tiles, the adjoint
    # split over d; the planted table's den at B = 48, T = 24: 32 tiles,
    # the forward split too; phase 16's pm1 contender at B = 48 (V = 58,044 > 51,196
    # floats, a wildcard group): rows staged part by part (the forward not
    # split: 378 tiles are three waves already); the same at B = 16
    ((16, 50, 6, 492, 484, 4, 6034), 0, ((16, False, False),
                                         (16, True, False))),
    ((48, 24, 2, 477, 487, 4, 430), 0, ((64, True, False),
                                        (64, True, False))),
    ((48, 40, 21, 544, 555, 4, 430), 1, ((64, False, True),
                                         (64, True, True))),
    ((16, 5, 21, 544, 555, 4, 430), 1, ((16, False, True),
                                        (16, True, True))),
])
def test_kernels_match_plain_at_the_planned_shapes(cuda, shape, groups,
                                                   want, obs_dtype):
    """The shapes the plan redesigns for: the plan's choices (the adjoint's
    W copies evict_first where rows are staged by part and W does not fit
    L2), then the kernels against the plain scans as in
    test_kernels_match_plain."""
    b, t, c, nsrc, ndpos, r, _ = shape
    ndp = r * ndpos + nsrc
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    w_past_l2 = c * nsrc * (ndp + -ndp % 4) * 4 > l2
    for fwd, (rows, split, part) in zip((True, False), want):
        pl = bdc.plan(0, fwd, b, c, nsrc, ndp, r, groups)
        assert (pl.tile_rows, pl.splits > 1, pl.part_staged) == (
            rows, split, part), (fwd, pl)
        assert pl.w_evict_first == (not fwd and part and w_past_l2), (
            fwd, pl)
    _match_plain(cuda, shape, obs_dtype, groups=groups)


@pytest.mark.cuda
def test_flagship_plan_is_unsplit(cuda):
    """The flagship den at B = 64 keeps its design: 64-row tiles, no
    forward split, rows staged whole, no L2 hint."""
    pl = bdc.plan(0, True, 64, 7, 538, 2690, 4, 0)
    assert (pl.tile_rows, pl.splits, pl.part_staged, pl.w_evict_first) == (
        64, 1, False, False)


@pytest.mark.cuda
def test_buffers_given_by_the_caller(cuda):
    """``out=``/``scratch=`` views into larger buffers: the same bits as
    the wrapper's own allocations, and nothing written around them."""
    rng = np.random.RandomState(2)
    b, t, p = 5, 6, 40
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, 3, 45, 21, 2, p, groups=1), cuda)
    obs = torch.rand(b, t, p, device=cuda).index_select(
        -1, g.pdf_virtual).contiguous()
    gbar = torch.rand(b, device=cuda) + 0.5
    z, al, cs = bdc.blocked_den_fwd_cuda(obs, g, 0.1)
    gr = bdc.blocked_den_bwd_cuda(obs, g, al, cs, gbar)

    def banded(n, dtype):
        size = torch.empty((), dtype=dtype).element_size()
        buf = torch.full((2048 + n * size,), 0xA5, dtype=torch.uint8,
                         device=cuda)
        return buf, buf[1024:1024 + n * size].view(dtype)

    bufs = {k: banded(n, dt) for k, n, dt in (
        ("logz", b, torch.float32), ("alphas", t * b * obs.shape[2],
                                     torch.float32),
        ("cs", t * b, torch.float32), ("grad", obs.numel(), torch.float32),
        ("fs", bdc.fwd_scratch_floats(obs, g), torch.float32),
        ("bs", bdc.bwd_scratch_floats(obs, g), torch.float32))}
    z2, al2, cs2 = bdc.blocked_den_fwd_cuda(
        obs, g, 0.1, out=(bufs["logz"][1], bufs["alphas"][1].view(al.shape),
                          bufs["cs"][1].view(cs.shape)),
        scratch=bufs["fs"][1])
    gr2 = bdc.blocked_den_bwd_cuda(obs, g, al2, cs2, gbar,
                                   out=bufs["grad"][1].view(gr.shape),
                                   scratch=bufs["bs"][1])
    torch.cuda.synchronize()
    assert torch.equal(z, z2) and torch.equal(al, al2)
    assert torch.equal(cs, cs2) and torch.equal(gr, gr2)
    for name, (buf, _) in bufs.items():
        assert bool((buf[:1024] == 0xA5).all()), name
        assert bool((buf[-1024:] == 0xA5).all()), name
    with pytest.raises(ValueError, match="scratch"):
        bdc.blocked_den_fwd_cuda(obs, g, 0.1, scratch=bufs["fs"][1][1:])


def _match_plain(cuda, shape, obs_dtype, groups):
    b, t, c, nsrc, ndpos, r, p = shape
    rng = np.random.RandomState(0)
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, c, nsrc, ndpos, r, p, groups=groups), cuda)
    logits = torch.tensor(rng.randn(b, t, p).astype(np.float32) * 2,
                          device=cuda)
    obs = torch.exp(torch.clamp(logits - logits.amax(-1, keepdim=True),
                                min=-30.0))
    obs_v = obs.to(obs_dtype).index_select(-1, g.pdf_virtual).contiguous()
    gbar = torch.tensor(rng.rand(b).astype(np.float32) + 0.5, device=cuda)
    for leaky in (0.0, 0.1):
        zk, ak, ck = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gk = bdc.blocked_den_bwd_cuda(obs_v, g, ak, ck, gbar)
        zk2, ak2, ck2 = bdc.blocked_den_fwd_cuda(obs_v, g, leaky)
        gk2 = bdc.blocked_den_bwd_cuda(obs_v, g, ak2, ck2, gbar)
        zp, ap, cp = bdc.blocked_scan_fwd_plain(obs_v, g, leaky)
        gp = bdc.blocked_scan_bwd_plain(obs_v, g, ap, cp, gbar)
        torch.cuda.synchronize()
        assert torch.equal(zk, zk2) and torch.equal(gk, gk2)
        assert gk.dtype == obs_dtype
        torch.testing.assert_close(zk, zp, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(ak, ap, rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(ck, cp, rtol=1e-4, atol=1e-30)
        gmax = float(gp.float().abs().max())
        tol = (1e-3 if obs_dtype == torch.float32 else 1e-2) * max(gmax, 1.0)
        assert float((gk.float() - gp.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_refuses_wildcard_and_cpu_mismatch(cuda):
    """The kernels refuse more wildcard groups than they take (the error
    names R); the library's limit is the wrapper's."""
    assert (bdc._library().blocked_den_max_groups()
            == bdc.MAX_WILDCARD_GROUPS)
    rng = np.random.RandomState(1)
    host = random_blocked_graph(rng, 1, 8, 4, 2, 5)
    r = bdc.MAX_WILDCARD_GROUPS + 1
    host.bcast_sel = np.zeros((8, r), np.float32)
    host.bcast_vec = np.zeros((r, 16), np.float32)
    g = BlockedDenGraph.from_host(host, cuda)
    obs = torch.rand(1, 3, 16, device=cuda)
    with pytest.raises(ValueError, match=f"R={r}"):
        bdc.blocked_den_fwd_cuda(obs, g, 0.1)
