"""Tiny traced runs of every cell on the CPU: each metric read from the
program's own spans and counters (``skyfall_gs_tpu_torch.utils.trace``)
reads a number, and a share lies in (0, 100]."""

from __future__ import annotations

import pytest

import tiny

SPEC = tiny.harness.load_json(tiny.BENCH.parent / "BENCHMARK.json")
TRACED = {m["name"]: m for m in SPEC["per_layer"]
          if "utils.trace" in (tiny.BENCH / "metrics" / f"{m['name']}.py").read_text()}


def test_sixteen_readers_of_the_program_trace():
    assert len(TRACED) == 16
    assert all(m["source"] == "program_span" for m in TRACED.values())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_trace_metric_reads_a_number(cell):
    res, _ = tiny.run(cell, trace=True)
    assert res["correct"], res["checks"]
    names = [n for n, m in TRACED.items() if cell in m["workloads"]]
    assert names
    got = res["metrics"]
    assert set(names) <= set(got), sorted(set(names) - set(got))
    for n in names:
        v = got[n]["value"]
        assert v > 0, (n, v)
        if n.startswith("bin_fill."):
            assert v <= 100.0, (n, v)
