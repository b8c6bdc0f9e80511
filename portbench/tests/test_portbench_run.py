"""Whole runs of the tiny cells on the CPU: the plain reference agrees
with the port, and ``correct`` comes out false with the timed path
broken underneath (the faults the training cells can have) and with the
fp8 control in the program's place."""

import time

import pytest
import torch

from portbench import calibrate, faults, harness
from portbench.tests import tiny

CELLS = [f"{c}.{t}" for c, t in tiny.CELLS]
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    bench = tiny.write_checkout(
        root, harness.load_json(harness.ROOT / "BENCHMARK.json"))
    return root, bench


def _run(checkout, cell, trace=False, fault=None, seconds=0.3):
    root, bench = checkout
    return harness.run(cell, SEED, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), bench=bench, root=root,
                       tmpdir=str(root), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(checkout, cell):
    out = _run(checkout, cell)
    assert out["correct"], out["checks"]
    assert all(v["value"] < 1e-4 for v in out["checks"].values())
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"audio_s_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_step_is_not_correct(checkout, cell, fault):
    out = _run(checkout, cell, fault=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_fp8_control_fails_a_number(checkout, cell):
    root, bench = checkout
    c = harness.load_cell(cell, bench, root)
    kind = harness.kind_module(c["config"])
    setup = kind.host_setup(c["config"])
    got = calibrate.readings(c, kind, setup, SEED, torch.device("cpu"),
                             control=True)
    assert any(v > c["limits"]["limits"][k]
               for k, v in got["numbers"].items())


def test_traced_run_reports_per_layer_metrics(checkout):
    out = _run(checkout, CELLS[0], trace=True)
    # the CPU has no device trace: only the host-side readers report
    assert {"host_setup_s", "warmup_s", "mfu"} <= set(out["metrics"])
    assert "gemm_ms" not in out["metrics"]


def test_loader_cell_reports_input_wait(checkout):
    out = _run(checkout, CELLS[2], trace=True)
    assert out["metrics"]["input_wait_ms"]["value"] >= 0.0
