"""The port and chip_smoke.py import neither jax nor the JAX package:
not when imported, and not lazily inside a function either."""

import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "tdnnf_nas_tpu")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any "import jax..." now raises
sys.modules["tdnnf_nas_tpu"] = None  # and so does the JAX package
import tdnnf_nas_torch
names = [m.name for m in pkgutil.walk_packages(tdnnf_nas_torch.__path__,
                                               "tdnnf_nas_torch.")]
for name in names:
    importlib.import_module(name)
smoke = importlib.import_module("chip_smoke")
assert callable(smoke.main)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "tdnnf_nas_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 64


def forbidden_imports(source: str, filename: str = "<source>"):
    """(line, module) of every import statement of jax, jaxlib or the JAX
    package in ``source``, at any depth (inside functions and classes
    too), and of every ``importlib.import_module`` or ``__import__`` call
    that names one with a literal string."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and (getattr(node.func, "attr", None) == "import_module"
                   or getattr(node.func, "id", None) == "__import__")):
            mods = [node.args[0].value]
        found += [(node.lineno, m) for m in mods
                  if m.split(".")[0] in _FORBIDDEN]
    return found


def _port_sources():
    files = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(_REPO, "tdnnf_nas_torch")):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def test_no_port_source_imports_jax_anywhere():
    """Every .py of the port, and chip_smoke.py, scanned statement by
    statement: the import probe above cannot see an import that sits in
    a function it never calls."""
    files = _port_sources()
    assert len(files) >= 66
    bad = {}
    for path in files:
        with open(path) as f:
            hits = forbidden_imports(f.read(), path)
        if hits:
            bad[os.path.relpath(path, _REPO)] = hits
    assert not bad, bad


@pytest.mark.parametrize("name", ["search_sanity_planted",
                                  "search_planted_table", "e2e_wer_pipeline",
                                  "lhuc_regularized", "rnnlm_fair_fight",
                                  "context_compare", "wpd_compare",
                                  "wer_synthetic", "profile_components",
                                  "profile_den", "bench_triphone_den",
                                  "bench_sparse_decode", "bench_scaling",
                                  "bench_dense_den"])
def test_search_tools_import_neither_jax_nor_scripts(name):
    """The search tools, the comparison drivers and the profile and bench
    tools are scanned with the rest of the port, and carry their own
    copies of the reference scripts' numpy pieces: no import of
    ``scripts`` either."""
    path = os.path.join(_REPO, "tdnnf_nas_torch", "tools", f"{name}.py")
    assert path in _port_sources()
    with open(path) as f:
        source = f.read()
    assert forbidden_imports(source, path) == []
    mods = []
    for node in ast.walk(ast.parse(source, path)):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods and not [m for m in mods if m.split(".")[0] == "scripts"]


@pytest.mark.parametrize("source, want", [
    ("def f():\n    import jax.numpy as jnp\n", [(2, "jax.numpy")]),
    ("def f():\n    if 1:\n        from tdnnf_nas_tpu.decode.beam import "
     "beam_decode_sparse\n", [(3, "tdnnf_nas_tpu.decode.beam")]),
    ("class C:\n    def m(self):\n        import jaxlib, os\n",
     [(3, "jaxlib")]),
    ("import importlib\nm = importlib.import_module('jax')\n", [(2, "jax")]),
    ("m = __import__('tdnnf_nas_tpu.lm')\n", [(1, "tdnnf_nas_tpu.lm")]),
    ("import jaxtyping\nfrom .jax import x\n# import jax\n"
     "s = 'import jax'\n", []),
])
def test_forbidden_import_scan(source, want):
    """The scan finds a lazy import inside a function or a method, and
    takes no other name, relative import, comment or string for one."""
    assert forbidden_imports(source) == want
