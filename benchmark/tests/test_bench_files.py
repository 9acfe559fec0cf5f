"""Every cell, configuration and per-layer metric of BENCHMARK.json is
found by name, and the file keeps to the benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from tiny import BENCH, harness

ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    bench, entry, cfg, wl = harness.cell_files(cell)
    assert entry["chips"] == 1
    assert wl["why"] == entry["why"] and len(entry["why"]) <= 200
    driver = importlib.import_module(f"drivers.{wl['kind']}")
    assert callable(driver.run) and callable(driver.control)
    e2e, per = harness.cell_metrics(bench, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_by_path(BENCH / "metrics" / f"{metric}.py", "m")
    assert callable(mod.read)


def test_names_units_and_references():
    configs = {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    names = [c["name"] for c in SPEC["configs"]] + list(cells) + list(e2e) + [
        m["name"] for m in SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    assert {w["config"] for w in SPEC["workloads"]} == configs
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
