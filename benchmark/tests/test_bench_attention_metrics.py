"""The readers of FLUX's attention span and counter: a tiny traced run of
the view-generation cell on the CPU reads the span's device time and a
fused share of 0 (the CPU takes the plain version), and both readers give
None on a traced window without the span."""

from __future__ import annotations

import torch

import tiny

NAMES = ("attention_ms.idu", "attention_fused.idu")
CELL = "idu_views.flux1024"


def _reader(name: str):
    return tiny.harness.load_by_path(tiny.BENCH / "metrics" / f"{name}.py",
                                     "metric_" + name.replace(".", "_"))


def test_attention_readers_on_a_tiny_traced_run():
    spec = {m["name"]: m for m in tiny.harness.load_json(
        tiny.BENCH.parent / "BENCHMARK.json")["per_layer"]}
    for n in NAMES:
        assert spec[n]["workloads"] == [CELL] and spec[n]["moves"] == "idu_views_per_min"
    res, _ = tiny.run(CELL, trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["attention_ms.idu"]["value"] > 0
    assert got["attention_fused.idu"]["value"] == 0.0


def test_attention_readers_without_the_span():
    from skyfall_gs_tpu_torch.utils.trace import span

    class Run:
        class trace:
            units = 2

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("something.else"):
            pass
    for n in NAMES:
        assert _reader(n).read(Run()) is None
