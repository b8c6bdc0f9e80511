"""No run imports the JAX package, and the plain reference imports
nothing of the port; a run without a card, or in a directory holding
only the benchmark's files, prints no result and fails."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = harness.PKG
FORBIDDEN = {"jax", "jaxlib", "flax", "tdnnf_nas_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch", "typing",
                        "portbench"}, path
        assert all(m.startswith("portbench.reference")
                   for m in _imports(path) if m.startswith("portbench"))


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's, and is not it
    import tdnnf_nas_torch  # noqa: F401

    assert harness.forbidden_modules() == []


CELL = harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"][0][
    "name"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return dict(env, CUDA_VISIBLE_DEVICES="", **extra)


def _cli(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd,
        env=_env(), capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    res = _cli(harness.ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_only_benchmark_files_fail(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
    # past the card's check (here on the CPU) the run needs the program,
    # which such a directory does not hold
    code = ("import sys, time, torch; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            f"harness.run({CELL!r}, 7, 1, False, torch.device('cpu'), "
            "time.perf_counter())")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "No module named 'tdnnf_nas_torch'" in res.stderr


def test_result_line_is_json_last():
    # the entry prints the card line first and the result line last
    src = (PB / "harness.py").read_text()
    assert src.rindex("print(json.dumps(out)") > src.rindex("check {k}")
    json.loads(json.dumps({"checks": {}}))
