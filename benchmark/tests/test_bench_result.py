"""Tiny runs of every cell on the CPU: the result line has exactly the
contract's keys, the reference agrees with the port, and no module of JAX
or the JAX package is loaded."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_and_agreement(cell, trace):
    res, _ = tiny.run(cell, trace=trace)
    keys = LINE_KEYS[:-1] + (["breakdown"] if trace else []) + LINE_KEYS[-1:]
    assert sorted(res) == sorted(keys) and list(res)[-1] == "checks"
    json.dumps(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    bench = tiny.harness.load_json(tiny.BENCH.parent / "BENCHMARK.json")
    e2e, per = tiny.harness.cell_metrics(bench, cell)
    names = {m["name"] for m in (per if trace else e2e)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names


def test_no_jax_module_loaded():
    code = ("import tiny, sys; tiny.run('idu_views.flux1024'); tops = {m.split('.')[0] "
            "for m in sys.modules}; print('skyfall_gs_tpu_torch' in tops, "
            "sorted(tops & {'jax', 'jaxlib', 'flax', 'skyfall_gs_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tiny.BENCH / "tests"),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "skyfall_gs_tpu_torch_x", object())
    assert tiny.harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "skyfall_gs_tpu.ops", object())
    assert tiny.harness.forbidden_modules() == ["skyfall_gs_tpu"]
