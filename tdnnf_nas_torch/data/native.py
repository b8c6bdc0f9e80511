"""Build and load the native egs loader (port of the loader half of
``tdnnf_nas_tpu.data.native``, `data/native.py:22-72,117-122` there).

Compiles the repository's ``native/egs_loader.cc`` alone with ``g++ -O3
-shared -fPIC -std=c++17 -pthread`` into ``tdnnf_nas_torch/_build/``
(git-ignored), named by a hash of the source and the flags, written to a
temporary name and renamed into place, as ``ops/cuda_build.py`` does for
the kernels.  It never loads the JAX package's ``native/libegs.so``.  The
supervision builder and the decoders of ``native/`` wait for the slices
that call them.

Unlike the reference, which returns None when the build or the load
fails (and whose bench then streams from host RAM instead), a failed
build raises with the compiler's output.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "egs_loader.cc"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path(src: Path = SOURCE) -> Path:
    """Where the library of ``src`` lives, keyed on its source and flags."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{digest[:16]}.so"


def build(src: Path = SOURCE) -> Path:
    """Compile ``src`` unless its library exists; return the library's
    path.  Raises RuntimeError with the compiler's output on failure."""
    so = library_path(src)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX!r} to build {src.name}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed on {src.name} (exit "
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
    lib = ctypes.CDLL(str(build()))
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
