"""Kaldi ark/scp I/O: read/write feature matrices and alignments (port of
``tdnnf_nas_tpu.data.kaldi_io``, numpy, copied as it is: both packages
write the same bytes and read each other's files).

Interop layer so a user of the reference can bring Kaldi-prepared data
(features from `steps/make_fbank_40.sh`, alignments/lattice-derived phone
segmentations from `Prepare_NAS_data.sh`) straight into this framework.
Supports the standard binary formats:

  * FM/DM (float/double matrices), FV/DV (vectors)
  * CM  (CompressedMatrix format 1: global min/range + per-column
    uint16 percentile headers + uint8 entries)
  * int32 vectors (alignments)
  * scp files (``key ark_path:offset``) and write-out of ark,scp pairs

Pure numpy; no Kaldi dependency.  Round-trip tested (the image has no
Kaldi binaries to cross-check against; the layouts follow kaldi-matrix.cc /
compressed-matrix.cc).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("eof in token")
        if c == b" ":
            break
        tok += c
    return tok.decode()


def _read_basic_int32(f) -> int:
    size = f.read(1)
    assert size == b"\x04", size
    return struct.unpack("<i", f.read(4))[0]


def _write_basic_int32(f, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def _expect_binary(f) -> None:
    two = f.read(2)
    if two != b"\x00B":
        raise ValueError(f"not Kaldi binary data (got {two!r})")


def read_matrix(f) -> np.ndarray:
    """Read one binary matrix (FM/DM/CM) from a stream positioned at \\0B."""
    _expect_binary(f)
    tok = _read_token(f)
    if tok in ("FM", "DM"):
        rows = _read_basic_int32(f)
        cols = _read_basic_int32(f)
        dt = np.float32 if tok == "FM" else np.float64
        data = np.frombuffer(f.read(rows * cols * dt().itemsize), dtype=dt)
        return data.reshape(rows, cols).astype(np.float32)
    if tok == "CM":
        min_v, rng = struct.unpack("<ff", f.read(8))
        rows, cols = struct.unpack("<ii", f.read(8))
        col_hdr = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4)
        data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(
            cols, rows)
        return _uncompress(min_v, rng, col_hdr, data).T.astype(np.float32)
    raise ValueError(f"unsupported matrix token {tok!r}")


def _u16_to_float(min_v, rng, u16):
    return min_v + rng * (u16.astype(np.float64) / 65535.0)


def _uncompress(min_v, rng, col_hdr, data) -> np.ndarray:
    """data [cols, rows] uint8 -> [cols, rows] float using percentile maps."""
    p0 = _u16_to_float(min_v, rng, col_hdr[:, 0])[:, None]
    p25 = _u16_to_float(min_v, rng, col_hdr[:, 1])[:, None]
    p75 = _u16_to_float(min_v, rng, col_hdr[:, 2])[:, None]
    p100 = _u16_to_float(min_v, rng, col_hdr[:, 3])[:, None]
    c = data.astype(np.float64)
    out = np.where(
        c <= 64,
        p0 + (p25 - p0) * (c / 64.0),
        np.where(
            c <= 192,
            p25 + (p75 - p25) * ((c - 64.0) / 128.0),
            p75 + (p100 - p75) * ((c - 192.0) / 63.0),
        ),
    )
    return out


def _compress(mat: np.ndarray):
    """[rows, cols] -> (min, range, col_hdr [cols,4] u16, data [cols,rows] u8)."""
    mn = float(mat.min())
    mx = float(mat.max())
    rng = max(mx - mn, 1e-5)
    cols = mat.shape[1]

    def to_u16(v):
        return np.clip(np.round((v - mn) / rng * 65535.0), 0, 65535).astype("<u2")

    hdr = np.zeros((cols, 4), dtype="<u2")
    data = np.zeros((cols, mat.shape[0]), dtype=np.uint8)
    for j in range(cols):
        col = mat[:, j].astype(np.float64)
        p0, p25, p75, p100 = np.percentile(col, [0, 25, 75, 100])
        # quantize the headers first, then encode against the dequantized vals
        h = to_u16(np.asarray([p0, p25, p75, p100]))
        # keep strictly increasing to avoid divide-by-zero
        for k in range(1, 4):
            if h[k] <= h[k - 1]:
                h[k] = min(h[k - 1] + 1, 65535)
        hdr[j] = h
        q0, q25, q75, q100 = (_u16_to_float(mn, rng, h.astype(np.uint16)))
        c = np.empty_like(col)
        lo = col <= q25
        hi = col >= q75
        mid = ~(lo | hi)
        c[lo] = np.clip((col[lo] - q0) / max(q25 - q0, 1e-10) * 64.0, 0, 64)
        c[mid] = 64 + (col[mid] - q25) / max(q75 - q25, 1e-10) * 128.0
        c[hi] = np.clip(192 + (col[hi] - q75) / max(q100 - q75, 1e-10) * 63.0,
                        192, 255)
        data[j] = np.clip(np.round(c), 0, 255).astype(np.uint8)
    return mn, rng, hdr, data


def write_matrix(f, mat: np.ndarray, compress: bool = False) -> None:
    f.write(b"\x00B")
    if compress:
        mn, rng, hdr, data = _compress(np.asarray(mat, np.float32))
        f.write(b"CM ")
        f.write(struct.pack("<ff", mn, rng))
        f.write(struct.pack("<ii", mat.shape[0], mat.shape[1]))
        f.write(hdr.tobytes())
        f.write(data.tobytes())
    else:
        f.write(b"FM ")
        _write_basic_int32(f, mat.shape[0])
        _write_basic_int32(f, mat.shape[1])
        f.write(np.asarray(mat, "<f4").tobytes())


def read_int_vector(f) -> np.ndarray:
    _expect_binary(f)
    n = _read_basic_int32(f)
    out = np.empty((n,), np.int32)
    for i in range(n):
        out[i] = _read_basic_int32(f)
    return out


def write_int_vector(f, vec) -> None:
    f.write(b"\x00B")
    _write_basic_int32(f, len(vec))
    for v in vec:
        _write_basic_int32(f, int(v))


def _read_key(f) -> str:
    key = b""
    while True:
        c = f.read(1)
        if not c:
            return ""
        if c == b" ":
            break
        key += c
    return key.decode()


def read_ark(path: str, reader=read_matrix) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, value) over a binary ark file."""
    with open(path, "rb") as f:
        while True:
            key = _read_key(f)
            if not key:
                return
            yield key, reader(f)


def write_ark(path: str, items, scp_path: str = None,
              compress: bool = False, writer=write_matrix) -> None:
    """items: iterable of (key, array).  Optionally writes the scp index."""
    scp = open(scp_path, "w") if scp_path else None
    with open(path, "wb") as f:
        for key, val in items:
            f.write(key.encode() + b" ")
            offset = f.tell()
            if scp:
                scp.write(f"{key} {path}:{offset}\n")
            if writer is write_matrix:
                writer(f, val, compress=compress)
            else:
                writer(f, val)
    if scp:
        scp.close()


def read_scp(path: str) -> List[Tuple[str, str, int]]:
    """[(key, ark_path, offset)]."""
    out = []
    for line in open(path):
        key, loc = line.strip().split(None, 1)
        ark, off = loc.rsplit(":", 1)
        out.append((key, ark, int(off)))
    return out


def load_scp_matrix(entry: Tuple[str, str, int]) -> np.ndarray:
    _, ark, off = entry
    with open(ark, "rb") as f:
        f.seek(off)
        return read_matrix(f)
