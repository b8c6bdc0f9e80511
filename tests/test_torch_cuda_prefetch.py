"""The prefetcher's CUDA path (needs a GPU): pinned buffers, copies on a
side stream, the consumer's stream waiting on each batch's event.

Skips without a CUDA device.  On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_prefetch.py

(``--noconftest``: tests/conftest.py imports jax, which the GPU host lacks;
this file imports only torch, numpy and the port.)
"""

import threading
import time

import numpy as np
import pytest
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.graphs.supervision import ChunkSupervision
from tdnnf_nas_torch.parallel import compress_batch_bf16, prefetch_to_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _host_batches(n, seed=0, b=64, t_in=150, t_out=50, s=80):
    """n host batches of the flagship loader's shapes and dtypes."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        sup = ChunkSupervision(
            trans=np.zeros((b, 1, 1), np.float32),
            state_pdf=rng.randint(0, 6034, (b, s)).astype(np.int32),
            init=rng.rand(b, s).astype(np.float32),
            final=rng.rand(b, s).astype(np.float32),
            mask=(rng.rand(b, t_out, s) > 0.5).astype(np.uint8),
            next_w=rng.rand(b, s // 2).astype(np.float32))
        yield {"feats": rng.randn(b, t_in, 40).astype(np.float32),
               "ivectors": rng.randn(b, 100).astype(np.float32), "sup": sup}


def _leaves(batch):
    out = []
    convert.map_batch(lambda k, a: out.append((k, a)), batch)
    return out


def _workers():
    return [t for t in threading.enumerate()
            if t.name == "prefetch_to_device" and t.is_alive()]


@pytest.mark.cuda
@pytest.mark.parametrize("payload_bf16", [False, True])
def test_prefetched_equal_sync_copies(cuda, payload_bf16):
    """20 prefetched batches equal synchronous copies of the same host
    batches bit for bit, each read at once on the consumer's stream while
    that stream runs a busy kernel chain between takes; every tensor is on
    the card."""
    x = torch.randn(4096, 4096, device=cuda)
    want = [convert.batch_to_torch(
        compress_batch_bf16(h) if payload_bf16 else h, cuda)
        for h in _host_batches(20)]
    sums = []
    n = 0
    for got, ref in zip(prefetch_to_device(_host_batches(20), size=3,
                                           device=cuda,
                                           payload_bf16=payload_bf16), want):
        for (k, a), (_, r) in zip(_leaves(got), _leaves(ref)):
            assert a.is_cuda and a.dtype == r.dtype, k
            assert torch.equal(a, r), k
        sums.append(got["feats"].double().sum())
        for _ in range(8):  # ~ms of work queued before the next take
            x = torch.tanh(x @ x * 1e-3)
        n += 1
    torch.cuda.synchronize()
    assert n == 20
    for s, ref in zip(sums, want):
        assert float(s) == float(ref["feats"].double().sum())
    assert not _workers()


@pytest.mark.cuda
def test_abandoned_generator_stops_worker(cuda):
    """A consumer that stops after 2 of an endless stream of batches stops
    and joins the worker."""
    def endless():
        while True:
            yield from _host_batches(4)

    gen = prefetch_to_device(endless(), size=2, device=cuda)
    for _ in range(2):
        next(gen)
    assert _workers()
    gen.close()
    deadline = time.time() + 10
    while _workers() and time.time() < deadline:
        time.sleep(0.05)
    assert not _workers()


@pytest.mark.cuda
def test_producer_exception_reaches_consumer(cuda):
    """An error raised by the host iterator surfaces in the consumer after
    the batches staged before it, and the worker is gone."""
    class Broken(Exception):
        pass

    def failing():
        yield from _host_batches(3)
        raise Broken("host iterator failed")

    got = []
    with pytest.raises(Broken, match="host iterator failed"):
        for b in prefetch_to_device(failing(), size=2, device=cuda):
            got.append(b)
    assert len(got) == 3
    assert not _workers()
