"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a plain-C shared library under ``tdnnf_nas_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused.  A library is written
to a temporary name and renamed into place, so processes that build at
the same time never load a half-written file.  ``build()`` compiles every
source at once, one ``nvcc`` per source started together; a source listed
in ``UNITS`` is compiled as that many translation units (``-DBD_UNIT=k``),
one ``nvcc -c`` each, all started with the rest, and linked into its
library.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (CSRC / "blocked_den.cu", CSRC / "dense_den.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# sources compiled as several translation units at once (stem -> units)
UNITS = {"blocked_den": 8}


def library_path(src: Path) -> Path:
    """Where the library of ``src`` lives, keyed on its source, flags and
    units."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        + str(UNITS.get(src.stem, 0)).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{digest[:16]}.so"


def _temp(suffix: str) -> str:
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp


def build(sources=SOURCES) -> List[Path]:
    """Compile every source whose library is missing, all at once, and
    return the libraries' paths.  Raises if any nvcc fails."""
    sos = [library_path(Path(src)) for src in sources]
    todo = [(Path(src), so) for src, so in zip(sources, sos)
            if not so.exists()]
    if not todo:
        return sos
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    temps, procs = [], []

    def start(name, cmd):
        procs.append((name, subprocess.Popen(cmd)))

    try:
        links = []  # (so, tmp library, unit objects)
        for src, so in todo:
            tmp = _temp(".so")
            temps.append(tmp)
            units = UNITS.get(src.stem, 0)
            if not units:
                start(src.name, [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)])
                links.append((so, tmp, None))
                continue
            objs = [_temp(".o") for _ in range(units)]
            temps += objs
            for k, obj in enumerate(objs):
                # a unit uses only some of the file's helpers: no warning
                # #177 (declared but never referenced) for the others
                start(f"{src.name} unit {k}", [nvcc, *compile_flags, "-c",
                                               "-diag-suppress", "177",
                                               f"-DBD_UNIT={k}", "-o", obj,
                                               str(src)])
            links.append((so, tmp, objs))
        failed = [name for name, proc in procs if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        for so, tmp, objs in links:
            if objs:
                start(so.name, [nvcc, *NVCC_FLAGS, "-o", tmp, *objs])
                if procs[-1][1].wait() != 0:
                    raise RuntimeError(f"nvcc failed to link {so.name}")
        for so, tmp, _ in links:
            os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in temps:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return sos


def load(src: Path) -> ctypes.CDLL:
    """Build ``src`` if its library is missing, then load it."""
    so, = build((src,))
    return ctypes.CDLL(str(so))


def buffer(x, shape, dtype, dev, name):
    """A kernel wrapper's output or scratch: the caller's ``x`` (an
    ``out=``/``scratch=`` argument), checked, or a new tensor when it is
    None."""
    if x is None:
        return torch.empty(shape, dtype=dtype, device=dev)
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
            or x.device != dev or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {dev}")
    return x


def ptr(x) -> ctypes.c_void_p:
    """A tensor's device address, as the libraries' C calls take it."""
    return ctypes.c_void_p(x.data_ptr())
