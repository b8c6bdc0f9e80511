"""The benchmark's files: BENCHMARK.json against the contract's limits,
every cell's configuration, traffic and limits, every metric's reader,
and a cell dropped in as files alone."""

import importlib
import json
import re

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # each listed cell reports the end-to-end metric the metric moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                              cells))
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == c["cell"]["config"]
    kind = harness.kind_module(c["config"])
    assert c["traffic"]["feed"] in ("resident", "loader")
    assert set(c["limits"]["limits"]) == {"grad_gap", "grad_diff",
                                          "change_gap"}
    spec = kind.weights_spec(c["config"])
    n = sum(int(__import__("numpy").prod(s)) for _, s, _ in spec)
    assert n == c["config"]["params"]
    assert c["cell"]["chips"] == 1 and len(c["cell"]["why"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(importlib.import_module(f"portbench.metrics.{metric}")
                    .read)


def test_config_entries_match_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_new_cell_is_found_by_its_files(tmp_path):
    """A configuration, a traffic mix and a cell added as files only."""
    bench = tiny.write_checkout(tmp_path)
    for cell in (f"{c}.{t}" for c, t in tiny.CELLS):
        c = harness.load_cell(cell, bench, tmp_path)
        assert c["config"]["name"] == cell.split(".")[0]
    with pytest.raises(SystemExit):
        harness.load_cell("absent.cell", bench, tmp_path)
