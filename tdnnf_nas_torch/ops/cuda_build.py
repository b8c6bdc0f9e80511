"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a plain-C shared library under ``tdnnf_nas_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused.  A library is written
to a temporary name and renamed into place, so processes that build at
the same time never load a half-written file.  ``build()`` compiles every source at once, one
``nvcc`` per source started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (CSRC / "blocked_den.cu", CSRC / "dense_den.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def library_path(src: Path) -> Path:
    """Where the library of ``src`` lives, keyed on its source and flags."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{digest[:16]}.so"


def build(sources=SOURCES) -> List[Path]:
    """Compile every source whose library is missing, all at once, and
    return the libraries' paths.  Raises if any nvcc fails."""
    sos = [library_path(Path(src)) for src in sources]
    todo = [(Path(src), so) for src, so in zip(sources, sos)
            if not so.exists()]
    if not todo:
        return sos
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src, so in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((src, so, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)])))
        failed = [src.name for src, _, _, proc in jobs if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        for _, so, tmp, _ in jobs:
            os.replace(tmp, so)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return sos


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` if its library is missing, then load it."""
    so, = build((src,))
    return ctypes.CDLL(str(so))


def ptr(x) -> ctypes.c_void_p:
    """A tensor's device address, as the libraries' C calls take it."""
    return ctypes.c_void_p(x.data_ptr())
