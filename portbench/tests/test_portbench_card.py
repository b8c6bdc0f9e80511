"""On the card: one short run of each cell, correct and with every
metric its cell lists.  Skips without a card (decided inside the test).

    python -m pytest portbench/tests/test_portbench_card.py
"""

import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = __import__("json").loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    c = harness.load_cell(cell)
    names = {m["name"] for m in (c["per_layer"] if trace
                                 else c["end_to_end"])}
    assert names <= set(out["metrics"])
