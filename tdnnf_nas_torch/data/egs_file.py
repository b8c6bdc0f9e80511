"""TEGS egs shards and the native streaming loader (port of
``tdnnf_nas_tpu.data.egs_file``, `data/egs_file.py:27-127` there).

Chunks from ``data/egs.make_egs`` are written once into a TEGS shard (the
format is documented in ``native/egs_loader.cc``) and streamed back at
training time by the C++ loader, which reads, shuffles and batches them
on its own thread.  The supervision is stored in the compact linear-chain
form (next_w, pdf, init, final, and the mask as uint8), which is what the
numerator takes; a loaded batch carries a dummy ``trans``.
"""

from __future__ import annotations

import struct
from typing import Iterator, Sequence

import numpy as np

from tdnnf_nas_torch.data import native
from tdnnf_nas_torch.data.egs import Chunk
from tdnnf_nas_torch.graphs.supervision import ChunkSupervision

_MAGIC = b"TEGS"
_VERSION = 1


def write_egs_file(chunks: Sequence[Chunk], path: str) -> None:
    """Write ``chunks`` (all of one shape, compact supervision) to a TEGS
    shard, byte for byte as the reference's ``write_egs_file``."""
    c0 = chunks[0]
    t_in, feat_dim = c0.feats.shape
    t_out, max_states = c0.sup.mask.shape
    if c0.sup.next_w is None:
        raise ValueError("an egs shard needs the compact supervision "
                         "(next_w)")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<5i", _VERSION, len(chunks), t_in, feat_dim,
                            t_out))
        f.write(struct.pack("<i", max_states))
        for ch in chunks:
            if (ch.feats.shape != (t_in, feat_dim)
                    or ch.sup.mask.shape != (t_out, max_states)):
                raise ValueError("every chunk of a shard has the first "
                                 "chunk's shapes")
            f.write(np.ascontiguousarray(ch.feats, np.float32).tobytes())
            f.write(np.ascontiguousarray(ch.sup.next_w, np.float32).tobytes())
            f.write(np.ascontiguousarray(ch.sup.state_pdf, np.int32).tobytes())
            f.write(np.ascontiguousarray(ch.sup.init, np.float32).tobytes())
            f.write(np.ascontiguousarray(ch.sup.final, np.float32).tobytes())
            f.write((np.ascontiguousarray(ch.sup.mask) > 0)
                    .astype(np.uint8).tobytes())


class NativeEgsLoader:
    """Iterator of training batches from a TEGS shard, prefetched in C++.

    Yields ``{"feats": [B,T_in,F] float32, "sup": ChunkSupervision}`` as
    ``data.egs.batch_iterator`` does, with a compact supervision: a dummy
    ``trans`` [B,1,1], ``next_w`` [B,S/2] and a uint8 ``mask`` [B,T,S]
    (the numerator reads ``mask > 0``).  The shard holds no i-vectors.
    The C++ thread reshuffles at each pass over the shard, so the
    iterator never ends.  ``close()`` releases the C++ loader; call it
    only once no other thread is inside the iteration (a prefetcher joins
    its worker when it stops).
    """

    def __init__(self, path: str, batch_size: int, queue_depth: int = 4,
                 seed: int = 0, self_loop_prob: float = 0.5):
        self._h = None
        self._lib = native.get_lib()
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a TEGS shard ({magic!r})")
            version, num_chunks, t_in, feat_dim, t_out = struct.unpack(
                "<5i", f.read(20))
            (max_states,) = struct.unpack("<i", f.read(4))
        if version != _VERSION:
            raise ValueError(f"{path}: TEGS version {version}, expected "
                             f"{_VERSION}")
        self.num_chunks = num_chunks
        self.t_in, self.feat_dim = t_in, feat_dim
        self.t_out, self.max_states = t_out, max_states
        self.batch_size = batch_size
        self.self_loop_prob = self_loop_prob
        self._h = self._lib.egs_loader_create(path.encode(), batch_size,
                                              queue_depth, seed)
        if not self._h:
            raise RuntimeError(f"failed to open egs shard {path}")

    def __iter__(self) -> Iterator[dict]:
        b, s = self.batch_size, self.max_states
        while self._h:
            feats = np.empty((b, self.t_in, self.feat_dim), np.float32)
            next_w = np.empty((b, s // 2), np.float32)
            pdf = np.empty((b, s), np.int32)
            init = np.empty((b, s), np.float32)
            final = np.empty((b, s), np.float32)
            mask = np.empty((b, self.t_out, s), np.uint8)
            ok = self._lib.egs_loader_next(
                self._h, native._f32p(feats), native._f32p(next_w),
                native._i32p(pdf), native._f32p(init), native._f32p(final),
                native._u8p(mask))
            if not ok:
                return
            sup = ChunkSupervision(
                trans=np.zeros((b, 1, 1), np.float32),  # unused (compact)
                state_pdf=pdf, init=init, final=final, mask=mask,
                next_w=next_w, self_loop_prob=self.self_loop_prob)
            yield {"feats": feats, "sup": sup}

    def close(self) -> None:
        if self._h:
            self._lib.egs_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
