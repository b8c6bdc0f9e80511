"""CUDA dense-den kernels vs their plain PyTorch versions (needs a GPU).

Skips without a CUDA device.  On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_dense_den.py

(``--noconftest``: tests/conftest.py imports jax, which the GPU host lacks;
this file imports only torch and the port.)
"""

import numpy as np
import pytest
import torch

from tdnnf_nas_torch.ops import dense_den_cuda as ddc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def random_dense_graph(rng, s, dev):
    """Row-stochastic sparse-ish trans, random init, final ones."""
    trans = rng.rand(s, s) * (rng.rand(s, s) < 0.3)
    trans[np.arange(s), np.arange(s)] += 0.3
    trans /= trans.sum(axis=1, keepdims=True)
    init = rng.rand(s)
    init /= init.sum()

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                            device=dev)

    return t(trans), t(init), t(np.ones(s))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, T, S): ragged tiles and depth slices, T=1, B over one row tile,
    # the flagship, the search's batch, S above the resident-tile limit
    # (tiles read from global memory, the A stage in two depth chunks)
    (3, 7, 75),
    (2, 1, 19),
    (70, 4, 130),
    (64, 50, 2208),
    (32, 50, 2208),
    (16, 6, 3000),
])
def test_kernels_match_plain(cuda, shape):
    """Tolerances: float32 sums in another order than cuBLAS and torch's
    reductions (no atomics, so kernel runs repeat bit for bit): logZ
    within 1e-3 absolute, the obs gradient within 1e-3 of its largest
    entry.  Both directions take the same contiguous trans."""
    b, t, s = shape
    rng = np.random.RandomState(0)
    trans, init, final = random_dense_graph(rng, s, cuda)
    logits = torch.tensor(rng.randn(b, t, s).astype(np.float32) * 2,
                          device=cuda)
    obs = torch.clamp(logits - logits.amax(-1, keepdim=True), min=-30.0)
    gbar = torch.tensor(rng.rand(b).astype(np.float32) + 0.5, device=cuda)
    for leaky in (0.0, 0.1):
        zk, ak, ck = ddc.dense_den_fwd_cuda(obs, trans, init, final, leaky)
        gk = ddc.dense_den_bwd_cuda(obs, trans, final, ak, ck, gbar)
        zk2, ak2, ck2 = ddc.dense_den_fwd_cuda(obs, trans, init, final, leaky)
        gk2 = ddc.dense_den_bwd_cuda(obs, trans, final, ak2, ck2, gbar)
        zp, ap, cp = ddc.dense_scan_fwd_plain(obs, trans, init, final, leaky)
        gp = ddc.dense_scan_bwd_plain(obs, trans, final, ap, cp, gbar)
        torch.cuda.synchronize()
        assert torch.equal(zk, zk2) and torch.equal(ak, ak2)
        assert torch.equal(gk, gk2)
        torch.testing.assert_close(zk, zp, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(ak, ap, rtol=1e-3, atol=1e-6)
        torch.testing.assert_close(ck, cp, rtol=1e-4, atol=1e-30)
        gmax = float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= 1e-3 * max(gmax, 1.0)


@pytest.mark.cuda
def test_one_device_kernel_per_scan(cuda):
    """At the flagship shape each direction is one persistent launch (the
    barrier counter's memset apart), with its tile resident."""
    from torch.profiler import ProfilerActivity, profile

    b, t, s = 64, 50, 2208
    assert ddc._device_plan(cuda, b, s).resident
    rng = np.random.RandomState(2)
    trans, init, final = random_dense_graph(rng, s, cuda)
    obs = torch.clamp(torch.tensor(rng.randn(b, t, s).astype(np.float32),
                                   device=cuda), max=0.0)
    gbar = torch.ones(b, device=cuda)
    _, al, cs = ddc.dense_den_fwd_cuda(obs, trans, init, final, 0.1)
    runs = {"fwd": lambda: ddc.dense_den_fwd_cuda(obs, trans, init, final,
                                                  0.1),
            "bwd": lambda: ddc.dense_den_bwd_cuda(obs, trans, final, al,
                                                  cs, gbar)}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memset", "Memcpy"))]
        assert len(kernels) == 1, (name, kernels)


@pytest.mark.cuda
def test_plan_uses_the_kernels_shared_memory(cuda):
    """The card plans with the library's own shared-memory size and the
    device's limit; the CPU's copy (_smem_bytes, which the CPU plan tests
    use) gives the same bytes, and on an H100 the same plans."""
    lib = ddc._library()
    for chunk in range(8, 513, 8):
        for depth_w in (chunk, 208, 216, 512):
            for resident in (False, True):
                assert lib.dense_den_smem_bytes(chunk, depth_w, resident) == (
                    ddc._smem_bytes(chunk, depth_w, resident))
    props = torch.cuda.get_device_properties(cuda)
    if "H100" in props.name:
        assert ddc._smem_limit(cuda.index) == ddc.HOPPER_SMEM
        for b, s in ((64, 2208), (32, 2208), (16, 3000), (3, 75)):
            assert ddc._device_plan(cuda, b, s) == ddc._plan(
                b, s, props.multi_processor_count)


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    rng = np.random.RandomState(1)
    trans, init, final = random_dense_graph(rng, 9, cuda)
    obs = torch.zeros(2, 3, 9, device=cuda)
    with pytest.raises(TypeError):
        ddc.dense_den_fwd_cuda(obs.double(), trans, init, final, 0.1)
    with pytest.raises(ValueError):
        ddc.dense_den_fwd_cuda(obs[:, :, :8].contiguous(), trans, init,
                               final, 0.1)
    with pytest.raises(ValueError):
        ddc.dense_den_fwd_cuda(obs, trans.cpu(), init, final, 0.1)
    # the adjoint takes trans itself, contiguous, not a transposed view
    _, al, cs = ddc.dense_den_fwd_cuda(obs, trans, init, final, 0.1)
    with pytest.raises(ValueError):
        ddc.dense_den_bwd_cuda(obs, trans.T, final, al, cs, torch.ones(
            2, device=cuda))
