"""The port's own copy of the native egs loader (``csrc/egs_loader.cc``)
against the reference's ``native/egs_loader.cc``: the same batches byte
for byte under one seed, and the two stops the copy repairs, each of
which must finish within a timeout: a loader closed while its producer
waits on a full queue, and a consumer waiting on a shard that ends early.
"""

import ctypes
import os
import struct
import threading

import numpy as np
import pytest

from tdnnf_nas_torch.data import native
from tdnnf_nas_torch.data.egs import Chunk
from tdnnf_nas_torch.data.egs_file import NativeEgsLoader, write_egs_file
from tdnnf_nas_torch.graphs.supervision import ChunkSupervision

_TIMEOUT_S = 20.0


def _chunks(n, t_in=30, feat_dim=40, t_out=10, max_states=16, seed=0):
    """``n`` seeded chunks of one shape, compact supervision."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        sup = ChunkSupervision(
            trans=np.zeros((1, 1), np.float32),
            state_pdf=rng.randint(0, 50, max_states).astype(np.int32),
            init=rng.rand(max_states).astype(np.float32),
            final=rng.rand(max_states).astype(np.float32),
            mask=(rng.rand(t_out, max_states) > 0.5).astype(np.float32),
            next_w=rng.rand(max_states // 2).astype(np.float32))
        out.append(Chunk(feats=rng.randn(t_in, feat_dim).astype(np.float32),
                         sup=sup))
    return out


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("egs") / "copy.tegs")
    write_egs_file(_chunks(37), path)
    return path


def _reference_lib():
    so = native.build((native._NATIVE / "egs_loader.cc",), "egs_loader_ref")
    return native.bind_loader(ctypes.CDLL(str(so)))


def _batches(loader, n):
    out = []
    for i, b in enumerate(loader):
        out.append(b)
        if i + 1 == n:
            break
    return out


def test_copy_is_built_from_the_port_source():
    so = native.library_path()
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parent.parent.name == "tdnnf_nas_torch"
    assert native.get_lib()._name == str(so)


def test_copy_batches_equal_reference_loader(shard, monkeypatch):
    """Batch for batch, byte for byte, across three reshuffled passes."""
    copy = NativeEgsLoader(shard, batch_size=8, queue_depth=3, seed=5)
    try:
        got = _batches(copy, 14)
    finally:
        copy.close()
    ref_lib = _reference_lib()
    monkeypatch.setattr(native, "get_lib", lambda: ref_lib)
    ref = NativeEgsLoader(shard, batch_size=8, queue_depth=3, seed=5)
    try:
        want = _batches(ref, 14)
    finally:
        ref.close()
    assert len(got) == len(want) == 14
    for a, b in zip(got, want):
        assert a["feats"].tobytes() == b["feats"].tobytes()
        for k in ("state_pdf", "init", "final", "mask", "next_w"):
            assert (getattr(a["sup"], k).tobytes()
                    == getattr(b["sup"], k).tobytes()), k


def _finishes(fn) -> bool:
    """Whether fn() returns within the timeout (run on a daemon thread,
    which a hang leaves behind)."""
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(_TIMEOUT_S)
    return not t.is_alive()


def test_close_while_queue_full(shard):
    """Loaders closed while their producer waits on a full queue, or is
    just about to: each close() returns."""
    def cycle():
        rng = np.random.RandomState(0)
        for i in range(60):
            loader = NativeEgsLoader(shard, batch_size=2, queue_depth=1,
                                     seed=i)
            if i % 2:
                next(iter(loader))  # the producer refills the queue
            if i % 3 == 0:
                threading.Event().wait(rng.rand() * 2e-3)
            loader.close()

    assert _finishes(cycle), "close() hung on a producer at a full queue"


def test_truncated_shard_ends_iteration(tmp_path):
    """A shard cut short inside its last chunk: the producer's read of
    that chunk fails within the first pass, while the consumer, faster
    than the reads, waits on an empty queue; it gets the batches read
    before and then the end of the iteration instead of blocking for
    good."""
    path = str(tmp_path / "cut.tegs")
    write_egs_file(_chunks(64, t_in=400), path)
    with open(path, "rb") as f:
        f.seek(4)
        version, n, t_in, feat_dim, t_out = struct.unpack("<5i", f.read(20))
        (s,) = struct.unpack("<i", f.read(4))
    chunk_bytes = 4 * t_in * feat_dim + 4 * (s // 2) + 12 * s + t_out * s
    with open(path, "r+b") as f:  # 63 whole chunks and half of the last
        f.truncate(28 + 63 * chunk_bytes + chunk_bytes // 2)
    got = []

    def consume():
        loader = NativeEgsLoader(path, batch_size=20, queue_depth=2, seed=0)
        try:
            got.extend(loader)
        finally:
            loader.close()

    assert _finishes(consume), "the consumer hung on a truncated shard"
    assert len(got) <= 3  # a pass holds 3 batches of 20 of 64 chunks
    assert all(b["feats"].shape == (20, 400, 40) for b in got)
