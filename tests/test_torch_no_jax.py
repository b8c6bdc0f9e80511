"""The port and chip_smoke.py import neither jax nor the JAX package."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    assert int(out.stdout.strip().splitlines()[-1]) >= 20
