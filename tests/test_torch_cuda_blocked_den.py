"""CUDA blocked-den kernels vs their plain PyTorch versions (needs a GPU).

Skips without a CUDA device.  On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_blocked_den.py

(``--noconftest``: tests/conftest.py imports jax, which the GPU host lacks;
this file imports only torch and the port.)
"""

import numpy as np
import pytest
import torch

from tdnnf_nas_torch.graphs.den_graph import BlockedDenGraph as HostBlocked
from tdnnf_nas_torch.ops import blocked_den_cuda as bdc
from tdnnf_nas_torch.ops.fwdbwd import BlockedDenGraph


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def random_blocked_graph(rng, c, nsrc, ndpos, r, num_pdfs):
    """A random graph in the blocked layout: injective perm with pad source
    slots, row-stochastic W rows, zero columns on unused enter slots."""
    ndp = r * ndpos + nsrc
    cs, cnd = c * nsrc, c * ndpos
    perm = np.full(cs, cnd, np.int64)
    src = rng.permutation(cs)[: min(cs, cnd) * 9 // 10]
    dst = rng.permutation(cnd)[: len(src)]
    perm[src] = dst
    perm_inv = np.full(cnd, cs, np.int64)
    perm_inv[dst] = src
    w = rng.rand(c, nsrc, ndp) * (rng.rand(c, nsrc, ndp) < 0.3)
    w[:, :, : r * ndpos] *= (rng.rand(r * ndpos) < 0.8)  # unused slots
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-9)
    v = c * ndp
    init_v = rng.rand(v) * (w.sum(1).reshape(-1) > 0)
    return HostBlocked(
        w_blocks=w.astype(np.float32), perm=perm.astype(np.int32),
        perm_inv=perm_inv.astype(np.int32),
        init_pos=rng.rand(cs).astype(np.float32) / cs,
        pdf_virtual=rng.randint(0, num_pdfs, v).astype(np.int32),
        init_virtual=(init_v / init_v.sum()).astype(np.float32),
        final_virtual=np.ones(v, np.float32),
        bcast_sel=None, bcast_vec=None, enter_pad=r, num_states=v,
        num_pdfs=num_pdfs)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (B, T, C, NSRC, NDPOS, R, P): ragged tiles, T=1, flagship
    (3, 5, 2, 70, 40, 3, 50),
    (2, 1, 1, 17, 9, 2, 11),
    (64, 50, 7, 538, 538, 4, 6034),
])
def test_kernels_match_plain(cuda, shape, obs_dtype):
    """Tolerances: float32 sums in another order (no atomics, so kernel
    runs repeat bit for bit); bf16 obs gradients round to 2^-8 relative."""
    b, t, c, nsrc, ndpos, r, p = shape
    rng = np.random.RandomState(0)
    g = BlockedDenGraph.from_host(
        random_blocked_graph(rng, c, nsrc, ndpos, r, p), cuda)
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
    rng = np.random.RandomState(1)
    host = random_blocked_graph(rng, 1, 8, 4, 2, 5)
    host.bcast_sel = np.zeros((8, 1), np.float32)
    host.bcast_vec = np.zeros((1, 16), np.float32)
    g = BlockedDenGraph.from_host(host, cuda)
    obs = torch.rand(1, 3, 16, device=cuda)
    with pytest.raises(ValueError):
        bdc.blocked_den_fwd_cuda(obs, g, 0.1)
