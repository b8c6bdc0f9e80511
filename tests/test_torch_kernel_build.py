"""The kernels' build (``ops/cuda_build.py``) on the CPU, with a stand-in
``nvcc`` on PATH that writes its ``-o`` target and logs its arguments."""

import os
import stat

import pytest

from tdnnf_nas_torch.ops import cuda_build

_FAKE = """#!/bin/sh
echo "$@" >> "{log}"
for a in "$@"; do
  case "$a" in {fail}) exit 1;; esac
done
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
echo built > "$out"
"""


def _fake_nvcc(tmp_path, monkeypatch, fail="NO_SUCH_ARGUMENT"):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE.format(log=log, fail=fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return log


def test_units_are_compiled_apart_and_linked(tmp_path, monkeypatch):
    """blocked_den.cu is compiled as its units, one ``nvcc -c`` each with
    its BD_UNIT, and the objects linked into one library; dense_den.cu as
    one shared library; nothing left in the build directory but the two
    libraries, which a second build reuses."""
    log = _fake_nvcc(tmp_path, monkeypatch)
    sos = cuda_build.build()
    assert [so.exists() for so in sos] == [True, True]
    calls = [line.split() for line in log.read_text().splitlines()]
    units = cuda_build.UNITS["blocked_den"]
    compiles = [c for c in calls if "-c" in c]
    assert sorted(c[c.index("-diag-suppress") + 2] for c in compiles) == [
        f"-DBD_UNIT={k}" for k in range(units)]
    assert all("-shared" not in c and c[-1].endswith("blocked_den.cu")
               for c in compiles)
    links = [c for c in calls if "-c" not in c and "-shared" in c]
    objs = sorted(c[c.index("-o") + 1] for c in compiles)
    blocked_link = [c for c in links if c[-1].endswith(".o")]
    assert len(blocked_link) == 1
    assert sorted(blocked_link[0][-units:]) == objs
    assert any(c[-1].endswith("dense_den.cu") for c in links)
    assert sorted(p.name for p in cuda_build.BUILD_DIR.iterdir()) == sorted(
        so.name for so in sos)
    n = len(calls)
    assert cuda_build.build() == sos
    assert len(log.read_text().splitlines()) == n


def test_a_failed_unit_names_itself(tmp_path, monkeypatch):
    """A unit whose nvcc fails raises, naming the unit, and leaves neither
    a library nor an object behind."""
    _fake_nvcc(tmp_path, monkeypatch, fail="-DBD_UNIT=3")
    with pytest.raises(RuntimeError, match="blocked_den.cu unit 3"):
        cuda_build.build()
    assert list(cuda_build.BUILD_DIR.iterdir()) == []


def test_the_units_key_the_library(tmp_path, monkeypatch):
    """The library's name changes with its unit count, so a library built
    as one unit is never taken for one built as several."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    src = cuda_build.SOURCES[0]
    split = cuda_build.library_path(src)
    monkeypatch.setattr(cuda_build, "UNITS", {})
    assert cuda_build.library_path(src) != split
