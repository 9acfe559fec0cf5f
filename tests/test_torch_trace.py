"""The port's tracer (``utils/trace.py``): spans and counters that do
nothing without a profiler, and with one land in the chrome trace and in
``report()``; the Trainer's and the IDU orchestrator's spans and counters;
``profile_dir``'s trace record."""

import json
import os

import numpy as np
import pytest
import torch

from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu_torch.io import synthetic as tsyn
from skyfall_gs_tpu_torch.model.gaussians import flat_fields
from skyfall_gs_tpu_torch.model.render import _activated
from skyfall_gs_tpu_torch.ops.binning import count_entries
from skyfall_gs_tpu_torch.ops.projection import project_gaussians
from skyfall_gs_tpu_torch.priors import RenderDepthPredictor
from skyfall_gs_tpu_torch.priors.flowedit import FlowEditRefiner
from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator
from skyfall_gs_tpu_torch.train.loop import Trainer
from skyfall_gs_tpu_torch.utils import trace

torch.set_num_threads(1)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def registry(monkeypatch):
    """A fresh registry, so no other test's profiled window shows."""
    monkeypatch.setattr(trace, "_R", trace._Registry())


def _profiled():
    return torch.profiler.profile(activities=CPU)


def test_off_enters_no_record_function_and_reports_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)

    @trace.span("decorated")
    def f(x):
        return x + 1

    with trace.span("outer", 3):
        with trace.span("inner"):
            assert f(1) == 2
        trace.count("c", torch.tensor(4))
        trace.count("c", 2)
    assert trace.report() == {"spans": {}, "counters": {}}


def test_nested_spans_in_chrome_trace_and_report(tmp_path):
    @trace.span("leaf")
    def leaf():
        return torch.ones(64).sum()

    with _profiled() as prof:
        with trace.span("outer", 7):
            for _ in range(2):
                with trace.span("inner"):
                    leaf()
            leaf()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(ann) == ["inner", "inner", "leaf", "leaf", "leaf", "outer"]

    r = trace.report()["spans"]
    assert {k: (v["count"], v["parent"]) for k, v in r.items()} == {
        "outer": (1, None), "inner": (2, "outer"), "leaf": (3, "inner")}
    # On the CPU the device time is the host time.
    for v in r.values():
        assert v["device_s"] == pytest.approx(v["host_s"], abs=1e-12)
        assert 0 <= v["self_host_s"] <= v["host_s"]
    assert r["leaf"]["self_host_s"] == pytest.approx(r["leaf"]["host_s"], abs=1e-12)


def test_self_time_is_total_minus_children():
    with _profiled():
        with trace.span("a"):
            with trace.span("b"):
                torch.ones(8).sum()
            with trace.span("c"):
                torch.ones(8).sum()
                with trace.span("b"):
                    torch.ones(8).sum()
    r = trace.report()["spans"]
    a, b, c = r["a"], r["b"], r["c"]
    assert (b["count"], b["parent"], c["parent"]) == (2, "a", "a")
    # a's children are the first b and c, c's child the second b, and b's
    # total is both b's: so a's children take b's total plus c's self time.
    assert a["host_s"] - a["self_host_s"] == pytest.approx(b["host_s"] + c["self_host_s"],
                                                           abs=1e-12)
    assert b["self_host_s"] == pytest.approx(b["host_s"], abs=1e-12)
    assert 0 < c["self_host_s"] < c["host_s"]


def test_counters_sum_device_tensors_without_a_sync(monkeypatch):
    def no_read(self):
        raise AssertionError("a counter read the device")

    with _profiled(), monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", no_read)
        for v in range(1, 2 * trace._BATCH + 3):     # past two buffers' worth
            trace.count("n", torch.tensor(v, dtype=torch.int64))
        trace.count("n", 5)
        trace.count("f", torch.tensor(0.25))
        trace.count("f", 0.5)
    n = 2 * trace._BATCH + 2
    assert trace.report()["counters"] == {"n": n * (n + 1) // 2 + 5, "f": 0.75}


def test_registry_restarts_after_an_off_stretch():
    with _profiled():
        with trace.span("first"):
            trace.count("c", 1)
    with trace.span("untraced"):
        trace.count("c", 10)
    # The last profiled window is still the first one.
    assert set(trace.report()["spans"]) == {"first"}
    with _profiled():
        with trace.span("second"):
            trace.count("c", 2)
    r = trace.report()
    assert set(r["spans"]) == {"second"} and r["counters"] == {"c": 2}


# ----------------------------------------------------------------------------
# The program's spans and counters
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return tsyn.make_city_scene(str(tmp_path_factory.mktemp("city")), n_views=5, size=32,
                                n_points=200, n_test=1)


def _trainer(scene, path, **opt):
    base = dict(iterations=30, densify_from_iter=10 ** 9, densify_until_iter=0,
                opacity_reset_interval=10 ** 9, lambda_depth=0.1)
    base.update(opt)
    return Trainer(ModelConfig(model_path=str(path)), OptimizationConfig(**base),
                   PipelineConfig(), scene, rng_seed=4)


def _entries_before_each_step(trainer, log):
    """Wraps the Trainer's steps: each appends the entry count of its own
    view (``count_entries``) at the state it trains from."""
    orig = trainer._get_step_fn

    def get_step_fn(*a, **k):
        fn = orig(*a, **k)

        def step(state, cam, *args, **kw):
            with torch.no_grad():
                m = state.model
                scales, opac = _activated(m, True)
                p = project_gaussians(m.params.xyz, scales, m.params.rotation, opac, cam,
                                      kernel_size=trainer.model_cfg.kernel_size,
                                      mask=m.aux.alive)
                log.append(int(count_entries(p.mean2d, p.radius, cam.height, cam.width,
                                             radius_xy=p.radius_xy)))
            return fn(state, cam, *args, **kw)

        return step

    trainer._get_step_fn = get_step_fn


def test_trainer_spans_entries_and_unchanged_training(scene, tmp_path):
    plain = _trainer(scene, tmp_path / "plain")
    ref = plain.train(plain.init_state(), iterations=3)

    tr = _trainer(scene, tmp_path / "traced")
    entries = []
    _entries_before_each_step(tr, entries)
    state = tr.init_state()
    with _profiled():
        state = tr.train(state, iterations=3)
    r = trace.report()
    spans, counters = r["spans"], r["counters"]
    for name in ("train.iteration", "train.loss", "train.backward", "train.adam", "render",
                 "render.colors", "render.project", "render.composite", "render.bin"):
        assert spans[name]["count"] == 3, name
    assert spans["render"]["parent"] == "train.iteration"
    assert spans["render.bin"]["parent"] == "render.composite"
    assert counters["render.entries"] == sum(entries) > 0
    assert counters["render.entries"] <= counters["render.sorted"] == 3 * tr.bin_capacity
    # Tracing does not change a bit of the training.
    for (k, a), (_, b) in zip(flat_fields(state.model.params), flat_fields(ref.model.params)):
        assert torch.equal(a, b), k


def test_profile_dir_writes_the_trace_and_its_record(scene, tmp_path):
    tr = _trainer(scene, tmp_path / "m")
    tr.profile_dir, tr.profile_steps = str(tmp_path / "prof"), 2
    tr.train(tr.init_state(), iterations=24)
    with open(tmp_path / "prof" / "trace.json") as f:
        ann = [e["name"] for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"]
    assert ann.count("train.iteration") == 2 and ann.count("train.adam") == 2
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f if '"trace"' in ln]
    assert len(recs) == 1 and recs[0]["type"] == "trace"
    assert recs[0]["iter"] == 22 and recs[0]["iterations"] == 2
    assert recs[0]["spans"]["train.iteration"]["count"] == 2
    assert recs[0]["counters"]["render.entries"] > 0


def test_idu_views_flowedit_steps_and_writes(scene, tmp_path):
    tr = _trainer(scene, tmp_path, idu_render_size=32, idu_num_cams=2,
                  idu_num_samples_per_view=2, idu_refine=True, idu_flow_edit_n_min=1,
                  idu_flow_edit_n_max=3, idu_flow_edit_n_max_end=-1, idu_flow_edit_n_avg=1)
    refiner = FlowEditRefiner(velocity_fn=lambda z, t, c: 0.1 * z, num_steps=4, batch_size=3,
                              device="cpu")
    orch = IDUOrchestrator(tr, refiner, RenderDepthPredictor())
    state = tr.init_state()
    with _profiled():
        views = orch.generate_idu_views(state, [[0.0, 0.0, 0.0]], 60.0, 3.5, 60.0, "tag")
    spans = trace.report()["spans"]
    batches = -(-len(views) // refiner.batch_size)
    assert len(views) == 4 and batches == 2
    assert spans["flowedit.step"]["count"] == (3 - 1) * batches
    assert spans["flowedit.encode"]["count"] == spans["flowedit.decode"]["count"] == batches
    files = [f for _, _, fs in os.walk(tmp_path / "idu" / "tag") for f in fs]
    assert len(files) == 2 * len(views) + 1
    assert spans["idu.write"]["count"] == len(files)
    for name in ("idu.render", "idu.refine", "idu.depth"):
        assert spans[name]["count"] == 1, name
    assert spans["flowedit.step"]["parent"] == "idu.refine"
    assert np.isfinite(np.stack([v.image for v in views])).all()
