"""Build and load the native egs loader, the native supervision builder
and the native decoders (port of ``tdnnf_nas_tpu.data.native``: the
loader half, `data/native.py:22-72, 117-122` there, the builder half,
`:135-207, 423-433`, and the decoder half, `:88-114, 209-420`).

Compiles the port's own copy of the loader, ``csrc/egs_loader.cc`` (the
reference's ``native/egs_loader.cc`` with its two lost wake-ups
repaired), alone into one library; ``native/egs_builder.cc`` as it is
(with OpenMP) into another; and ``native/decoder.cc``,
``native/lattice.cc`` and ``native/beam_sparse.cc`` together into a
third, each with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``tdnnf_nas_torch/_build/`` (git-ignored), named by a hash of its
sources and the flags, written to a temporary name and renamed into
place, as ``ops/cuda_build.py`` does for the kernels.  It never loads
the JAX package's ``native/libegs.so``.

Unlike the reference, which returns None when the build or the load
fails (and whose callers then fall back to numpy), a failed build raises
with the compiler's output.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_NATIVE = _PKG.parent / "native"
SOURCE = _PKG / "csrc" / "egs_loader.cc"
BUILDER_SOURCES = (_NATIVE / "egs_builder.cc",)
DECODER_SOURCES = tuple(_NATIVE / s for s in ("decoder.cc", "lattice.cc",
                                              "beam_sparse.cc"))
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# egs_builder.cc parallelises over the batch with OpenMP
BUILDER_FLAGS = CXX_FLAGS + ("-fopenmp",)


def library_path(srcs=(SOURCE,), stem: str = "egs_loader",
                 flags=CXX_FLAGS) -> Path:
    """Where the library of ``srcs`` lives, keyed on its sources and
    flags."""
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(srcs=(SOURCE,), stem: str = "egs_loader",
          flags=CXX_FLAGS) -> Path:
    """Compile ``srcs`` into one library unless it exists; return the
    library's path.  Raises RuntimeError with the compiler's output on
    failure."""
    so = library_path(srcs, stem, flags)
    if so.exists():
        return so
    names = ", ".join(s.name for s in srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [CXX, *flags, "-o", tmp, *(str(s) for s in srcs)],
                capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX!r} to build {names}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed on {names} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loader's library, built at first use, with every entry point's
    argument and return types declared."""
    return bind_loader(ctypes.CDLL(str(build())))


def bind_loader(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the loader's entry points' argument and return types on a
    library built from a loader source; returns it."""
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.egs_loader_create.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_uint64]
    lib.egs_loader_create.restype = ctypes.c_void_p
    lib.egs_loader_next.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, f32p,
                                    f32p, u8p]
    lib.egs_loader_next.restype = ctypes.c_int32
    lib.egs_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.egs_loader_destroy.restype = None
    return lib


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


@functools.lru_cache(maxsize=None)
def get_builder_lib() -> ctypes.CDLL:
    """The supervision builder's library (``build_supervision_batch``,
    ``edit_distance_batch``), built at first use, with both entry points'
    argument and return types declared."""
    lib = ctypes.CDLL(str(build(BUILDER_SOURCES, "egs_builder",
                                BUILDER_FLAGS)))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    c_i32 = ctypes.c_int32
    lib.build_supervision_batch.argtypes = [
        i32p, i32p, i32p, i32p, f32p, i32p, i32p, f32p, f32p,
        ctypes.c_float, c_i32, c_i32, c_i32, c_i32, c_i32,
        f32p, i32p, f32p, f32p, f32p,
    ]
    lib.build_supervision_batch.restype = None
    lib.edit_distance_batch.argtypes = [i32p, i32p, i32p, i32p, c_i32, i32p]
    lib.edit_distance_batch.restype = None
    return lib


def _ragged(seqs: Sequence[Sequence[int]]):
    """(flat int32 values, [N+1] int32 offsets) of ragged sequences."""
    offsets = np.zeros(len(seqs) + 1, np.int32)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    flat = np.asarray([x for s in seqs for x in s], np.int32)
    if flat.size == 0:
        flat = np.zeros(1, np.int32)
    return flat, offsets


def build_supervision_batch_native(
    phone_seqs: Sequence[Sequence[int]],
    begin_seqs: Optional[Sequence[Sequence[int]]],
    end_seqs: Optional[Sequence[Sequence[int]]],
    lm_probs: np.ndarray,  # [P+1, P]
    fwd_pdf_table: np.ndarray,  # [P+1, P] int32
    self_pdf_table: np.ndarray,  # [P] int32
    den_init_enter: Optional[np.ndarray],  # [P] or None
    den_init_loop: Optional[np.ndarray],
    self_loop_prob: float,
    tol: int,
    num_frames: int,
    max_states: int,
) -> dict:
    """Batched dense numerator graphs from ``native/egs_builder.cc``: a
    dict of [B, ...] arrays ``trans`` [B, S, S], ``state_pdf``, ``init``,
    ``final`` [B, S] and ``mask`` [B, T, S], laid out as
    ``graphs.supervision.make_chunk_supervision`` lays out one chunk (a
    bigram LM and a tree of at most one left phone).  ``begin_seqs`` None
    builds unaligned graphs (every state allowed at every frame)."""
    lib = get_builder_lib()
    b = len(phone_seqs)
    p = lm_probs.shape[1]
    s, t = max_states, num_frames
    phones, offsets = _ragged(phone_seqs)
    null_i = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    null_f = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    bp = ep = null_i
    if begin_seqs is not None:
        begins, boff = _ragged(begin_seqs)
        ends, eoff = _ragged(end_seqs)
        if not ((boff == offsets).all() and (eoff == offsets).all()):
            raise ValueError("begin/end sequences must match the phones' "
                             "lengths")
        bp, ep = _i32p(begins), _i32p(ends)
    lm = np.ascontiguousarray(lm_probs, np.float32)
    fwd = np.ascontiguousarray(fwd_pdf_table, np.int32)
    slf = np.ascontiguousarray(self_pdf_table, np.int32)
    de = (None if den_init_enter is None
          else np.ascontiguousarray(den_init_enter, np.float32))
    dl = (None if den_init_loop is None
          else np.ascontiguousarray(den_init_loop, np.float32))
    out = {"trans": np.zeros((b, s, s), np.float32),
           "state_pdf": np.zeros((b, s), np.int32),
           "init": np.zeros((b, s), np.float32),
           "final": np.zeros((b, s), np.float32),
           "mask": np.zeros((b, t, s), np.float32)}
    lib.build_supervision_batch(
        _i32p(phones), _i32p(offsets), bp, ep, _f32p(lm), _i32p(fwd),
        _i32p(slf), null_f if de is None else _f32p(de),
        null_f if dl is None else _f32p(dl),
        ctypes.c_float(self_loop_prob), tol, t, s, p, b,
        _f32p(out["trans"]), _i32p(out["state_pdf"]), _f32p(out["init"]),
        _f32p(out["final"]), _f32p(out["mask"]))
    return out


def tree_tables(tree, num_phones: int):
    """(fwd_pdf_table [P+1, P], self_pdf_table [P]) of a tree: the forward
    pdf of each phone after each left phone (row 0: no left phone) and
    each phone's self-loop pdf."""
    fwd = np.zeros((num_phones + 1, num_phones), np.int32)
    for left in range(-1, num_phones):
        for p in range(num_phones):
            fwd[left + 1, p] = tree.forward_pdf(p, left)
    slf = np.asarray([tree.self_loop_pdf(p) for p in range(num_phones)],
                     np.int32)
    return fwd, slf


def den_init_tables(den_graph, num_phones: int):
    """(enter [P], loop [P]) den init probs of the CI den-graph layout."""
    g = den_graph
    if g.num_states != 2 * num_phones:
        raise ValueError("den_init_tables supports the CI den layout only")
    return (np.asarray(g.init[:num_phones], np.float32),
            np.asarray(g.init[num_phones:], np.float32))


def edit_distance_batch_native(refs: List[Sequence[int]],
                               hyps: List[Sequence[int]]) -> np.ndarray:
    """[N, 4] int32 counts (sub, ins, del, hits) of each (ref, hyp)
    pair."""
    lib = get_builder_lib()
    r, ro = _ragged(refs)
    h, ho = _ragged(hyps)
    out = np.zeros((len(refs), 4), np.int32)
    lib.edit_distance_batch(_i32p(r), _i32p(ro), _i32p(h), _i32p(ho),
                            len(refs), _i32p(out))
    return out


@functools.lru_cache(maxsize=None)
def get_decoder_lib() -> ctypes.CDLL:
    """The decoders' library (``decode_nbest``, ``generate_lattice``,
    ``beam_decode_sparse_native``), built at first use, with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build(DECODER_SOURCES, "decoders")))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    c_i32, c_f32 = ctypes.c_int32, ctypes.c_float
    lib.decode_nbest.argtypes = [
        f32p, c_i32, c_i32,
        i32p, i32p, f32p, i32p, f32p, f32p, i32p,
        c_i32, c_i32, c_f32,
        c_i32, c_i32, i32p, i32p, f32p,
    ]
    lib.decode_nbest.restype = c_i32
    lib.generate_lattice.argtypes = [
        f32p, c_i32, c_i32,
        i32p, i32p, f32p, i32p, f32p, f32p, i32p,
        c_i32, c_f32, c_f32, c_f32,
        c_i32, c_i32,
        i32p, i32p, i32p, i32p, f32p, f32p, i32p,
    ]
    lib.generate_lattice.restype = c_i32
    lib.beam_decode_sparse_native.argtypes = [
        f32p, c_i32, c_i32,
        i64p, i32p, f32p, i32p, i32p, f32p,
        c_i32, c_i32,
        c_f32, c_f32, c_i32,
        c_i32, c_f32,
        c_i32, i32p, i32p, f32p,
        c_i32, c_i32,
        i32p, i32p, i32p, i32p, f32p, f32p, i32p, f32p,
    ]
    lib.beam_decode_sparse_native.restype = c_i32
    return lib


def _graph_csr(decoding_graph):
    """(log arrays + CSR successors) for a DecodingGraph's StateGraph:
    (offsets, dst, logw, state_pdf, log_init, log_final)."""
    from tdnnf_nas_torch.decode.viterbi import log_weights

    g = decoding_graph.graph
    s = g.num_states
    lt, li, lf = log_weights(g.trans, g.init, g.final)
    offsets = np.zeros((s + 1,), np.int32)
    dsts, ws = [], []
    for st in range(s):
        nz = np.nonzero(g.trans[st] > 0)[0]
        offsets[st + 1] = offsets[st] + len(nz)
        dsts.append(nz)
        ws.append(lt[st, nz])
    dst = np.concatenate(dsts).astype(np.int32) if dsts else np.zeros(1, np.int32)
    logw = np.concatenate(ws).astype(np.float32) if ws else np.zeros(1, np.float32)
    return (offsets, dst, logw,
            np.ascontiguousarray(g.state_pdf, np.int32),
            np.ascontiguousarray(li, np.float32),
            np.ascontiguousarray(lf, np.float32))


def generate_lattice_native(
    obs_logprob: np.ndarray,  # [T, P]
    decoding_graph,  # decode.wfst.DecodingGraph
    acoustic_scale: float = 1.0,
    beam: float = 16.0,
    lattice_beam: float = 8.0,
):
    """Native lattice generation; same semantics as
    decode.lattice.generate_lattice (tested equivalent)."""
    from tdnnf_nas_torch.decode.lattice import Lattice

    lib = get_decoder_lib()
    offsets, dst, logw, spdf, li, lf = _graph_csr(decoding_graph)
    s = decoding_graph.graph.num_states
    obs = np.ascontiguousarray(obs_logprob, np.float32)
    t, p = obs.shape
    wos = np.ascontiguousarray(decoding_graph.word_of_state, np.int32)
    # modest initial bounds (beam pruning keeps survivors far below T*S);
    # the rc == -2 retry doubles them on demand, capped within int32
    i32_max = 2**31 - 16
    max_nodes = min(t * s + 2, 64 * t + 2, i32_max)
    max_arcs = min(4 * t * int(offsets[-1]) + 2 * s + 16, 2048 * t + 16,
                   i32_max)
    while True:
        node_time = np.zeros((max_nodes,), np.int32)
        arc_src = np.zeros((max_arcs,), np.int32)
        arc_dst = np.zeros((max_arcs,), np.int32)
        arc_word = np.zeros((max_arcs,), np.int32)
        arc_am = np.zeros((max_arcs,), np.float32)
        arc_gs = np.zeros((max_arcs,), np.float32)
        counts = np.zeros((2,), np.int32)
        rc = lib.generate_lattice(
            _f32p(obs), t, p, _i32p(offsets), _i32p(dst), _f32p(logw),
            _i32p(spdf), _f32p(li), _f32p(lf), _i32p(wos), s,
            ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
            ctypes.c_float(lattice_beam), max_nodes, max_arcs,
            _i32p(node_time), _i32p(arc_src), _i32p(arc_dst), _i32p(arc_word),
            _f32p(arc_am), _f32p(arc_gs), _i32p(counts),
        )
        if rc == -1:
            raise ValueError("no complete path survived the beam")
        if rc == -2:
            if max_nodes >= i32_max and max_arcs >= i32_max:
                raise MemoryError("lattice exceeds int32 node/arc bounds")
            max_nodes = min(max_nodes * 2, i32_max)
            max_arcs = min(max_arcs * 2, i32_max)
            continue
        break
    n_nodes, n_arcs = int(counts[0]), int(counts[1])
    return Lattice(
        num_nodes=n_nodes,
        node_time=node_time[:n_nodes].copy(),
        arc_src=arc_src[:n_arcs].copy(),
        arc_dst=arc_dst[:n_arcs].copy(),
        arc_word=arc_word[:n_arcs].copy(),
        arc_am=arc_am[:n_arcs].copy(),
        arc_gs=arc_gs[:n_arcs].copy(),
    )


def nbest_decode_native(
    obs_logprob: np.ndarray,  # [T, P]
    decoding_graph,  # decode.wfst.DecodingGraph
    n: int = 10,
    acoustic_scale: float = 1.0,
    max_pops: int = 200000,
    max_words: int = 128,
):
    """Native n-best decode; same semantics as decode.nbest.nbest_decode
    (tested equivalent).  Returns [(words, score)] best-first."""
    lib = get_decoder_lib()
    offsets, dst, logw, spdf, li, lf = _graph_csr(decoding_graph)
    obs = np.ascontiguousarray(obs_logprob, np.float32)
    t, p = obs.shape
    out_words = np.zeros((n, max_words), np.int32)
    out_lens = np.zeros((n,), np.int32)
    out_scores = np.zeros((n,), np.float32)
    found = lib.decode_nbest(
        _f32p(obs), t, p, _i32p(offsets), _i32p(dst), _f32p(logw),
        _i32p(spdf), _f32p(li), _f32p(lf),
        _i32p(np.ascontiguousarray(decoding_graph.word_of_state, np.int32)),
        decoding_graph.graph.num_states, n, ctypes.c_float(acoustic_scale),
        max_pops, max_words, _i32p(out_words), _i32p(out_lens),
        _f32p(out_scores),
    )
    return [(out_words[i, : out_lens[i]].tolist(), float(out_scores[i]))
            for i in range(found)]


def beam_decode_sparse_csr_native(
    obs_logprob: np.ndarray,  # [T, P]
    g,  # decode.graph_sparse.SparseDecodingGraph
    acoustic_scale: float = 1.0,
    beam: float = 16.0,
    max_active: int = 7000,
    lattice: bool = False,
    lattice_beam: float = 8.0,
):
    """Native beam search over a SparseDecodingGraph — same semantics as
    decode.beam._beam_decode_once (parity-tested).  Returns (words, score,
    Lattice|None, mean active tokens); raises decode.beam.BeamSearchDied
    when no token survives a frame (the caller's retry-beam loop handles
    it)."""
    from tdnnf_nas_torch.decode.beam import BeamSearchDied
    from tdnnf_nas_torch.decode.lattice import Lattice

    lib = get_decoder_lib()
    obs = np.ascontiguousarray(obs_logprob, np.float32)
    t, p = obs.shape
    out_start = np.ascontiguousarray(g.out_start, np.int64)
    arc_dst = np.ascontiguousarray(g.arc_dst, np.int32)
    arc_w = np.ascontiguousarray(g.arc_w, np.float32)
    arc_word = np.ascontiguousarray(g.arc_word, np.int32)
    spdf = np.ascontiguousarray(g.state_pdf, np.int32)
    finw = np.ascontiguousarray(g.final_w, np.float32)

    max_words = max(16, 4 * t)
    max_nodes = (t * min(max_active, 4096) + 2) if lattice else 2
    max_arcs = (32 * max_nodes + 16) if lattice else 2
    while True:
        out_words = np.zeros((max_words,), np.int32)
        out_n = np.zeros((1,), np.int32)
        out_score = np.zeros((1,), np.float32)
        node_time = np.zeros((max_nodes,), np.int32)
        l_src = np.zeros((max_arcs,), np.int32)
        l_dst = np.zeros((max_arcs,), np.int32)
        l_word = np.zeros((max_arcs,), np.int32)
        l_am = np.zeros((max_arcs,), np.float32)
        l_gs = np.zeros((max_arcs,), np.float32)
        counts = np.zeros((2,), np.int32)
        mean_active = np.zeros((1,), np.float32)
        rc = lib.beam_decode_sparse_native(
            _f32p(obs), t, p, _i64p(out_start), _i32p(arc_dst), _f32p(arc_w),
            _i32p(arc_word), _i32p(spdf), _f32p(finw),
            int(g.num_states), int(g.start_state),
            ctypes.c_float(acoustic_scale), ctypes.c_float(beam),
            int(max_active), int(bool(lattice)), ctypes.c_float(lattice_beam),
            int(max_words), _i32p(out_words), _i32p(out_n), _f32p(out_score),
            int(max_nodes), int(max_arcs), _i32p(node_time), _i32p(l_src),
            _i32p(l_dst), _i32p(l_word), _f32p(l_am), _f32p(l_gs),
            _i32p(counts), _f32p(mean_active),
        )
        if rc == -1:
            raise BeamSearchDied("beam search died (native)")
        if rc == -2:
            max_words *= 2
            max_nodes = max(max_nodes * 2, 1024)
            max_arcs = max(max_arcs * 2, 16384)
            continue
        break
    words = out_words[: int(out_n[0])].tolist()
    lat = None
    if lattice:
        n_nodes, n_arcs = int(counts[0]), int(counts[1])
        order = np.argsort(l_src[:n_arcs], kind="stable")
        lat = Lattice(
            num_nodes=n_nodes,
            node_time=node_time[:n_nodes].copy(),
            arc_src=l_src[:n_arcs][order].copy(),
            arc_dst=l_dst[:n_arcs][order].copy(),
            arc_word=l_word[:n_arcs][order].copy(),
            arc_am=l_am[:n_arcs][order].copy(),
            arc_gs=l_gs[:n_arcs][order].copy(),
        )
    return words, float(out_score[0]), lat, float(mean_active[0])
