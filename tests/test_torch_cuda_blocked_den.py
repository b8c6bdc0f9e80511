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
