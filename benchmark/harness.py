"""The benchmark's harness: one run of one cell, one JSON line.

``run.py`` is the command; this module finds the cell's files by name,
checks the card, hands the cell to its traffic kind's driver
(``drivers/<kind>.py``), traces the driver's traced window, reads the
per-layer metrics (``metrics/<name>.py``), checks that nothing of JAX was
loaded, and prints the result.  Everything that belongs to one
configuration, traffic mix or metric is a file of its own:

  BENCHMARK.json                   cells, metrics, configurations
  benchmark/configs/<config>.json  sizes of one configuration
  benchmark/workloads/<cell>.json  traffic of one cell: its kind, parameters
                                   and the limits of its correctness numbers
  benchmark/drivers/<kind>.py      ``run(ctx) -> Outcome``
  benchmark/metrics/<metric>.py    ``read(run) -> float | None``
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "skyfall_gs_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class BenchError(RuntimeError):
    """A run that cannot produce a result; ``code`` is its exit code."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str) -> tuple:
    """``(BENCHMARK.json, its workload entry, the configuration's file,
    the workload file)`` of cell ``name``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json ({', '.join(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return bench, entry, config, workload


def cell_metrics(bench: dict, cell: str) -> tuple:
    """The end-to-end and per-layer metric entries that cell ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def load_by_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------------
# The profiler trace of a traced window
# ----------------------------------------------------------------------------

@dataclass
class Trace:
    """Device operations and host operations of one traced window (seconds,
    on the profiler's clock)."""

    window_s: float
    device_ops: list          # (name, start_s, dur_s), device work only
    host_ops: list            # (name, start_s, dur_s), CPU operators
    units: int                # steps or frames inside the window

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (intervals merged)."""
        total, end = 0.0, -math.inf
        for _, s, d in sorted(self.device_ops, key=lambda e: e[1]):
            if s + d <= end:
                continue
            total += s + d - max(s, end)
            end = s + d
        return total

    def kernel_s(self, match: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.device_ops if match(n))

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device_ops if match(n))

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, _, d in self.device_ops:
            by[n] = by.get(n, 0.0) + d
        return [[n[:120], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10, min_s: float = 20e-6) -> list:
        """Device idle gaps of at least ``min_s``, summed by the innermost
        host operator running at each gap's middle."""
        ops = sorted(self.device_ops, key=lambda e: e[1])
        host = sorted(self.host_ops, key=lambda e: e[1])
        starts = [h[1] for h in host]
        by: dict = {}
        end = ops[0][1] + ops[0][2] if ops else 0.0
        for _, s, d in ops[1:]:
            if s - end >= min_s:
                mid = 0.5 * (s + end)
                name = "host (no operator)"
                # The latest-starting operator that covers the middle is the
                # innermost of the nested ones there.
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 5000, -1), -1):
                    if host[j][1] + host[j][2] >= mid:
                        name = host[j][0]
                        break
                by[name] = by.get(name, 0.0) + (s - end)
            end = max(end, s + d)
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def read_chrome_trace(path: str, window_s: float, units: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        row = (e.get("name", ""), float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(row)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(row)
    return Trace(window_s=window_s, device_ops=dev, host_ops=host, units=units)


# ----------------------------------------------------------------------------
# What a driver gets and gives back
# ----------------------------------------------------------------------------

@dataclass
class Outcome:
    """A driver's report: units attempted and failed in the window, its
    end-to-end values by metric name, the correctness numbers as
    ``name -> value`` (limits come from the workload file), and what the
    per-layer readers read."""

    attempted: int
    failed: int
    metrics: dict
    checks: dict
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    work: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


@dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    workload: dict
    t0: float                       # process start, perf_counter seconds
    scratch: str                    # a directory under TMPDIR, removed at exit

    def setup_s(self) -> float:
        return time.perf_counter() - self.t0

    def sync(self) -> None:
        import torch
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def profile(self):
        """A context manager tracing the block with torch.profiler (host and
        device); its ``result(units)`` after the block is the ``Trace``."""
        return _Profile(self)


class _Profile:
    def __init__(self, ctx: Context):
        self.ctx = ctx

    def __enter__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.ctx.device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.ctx.sync()
        self.prof.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ctx.sync()
        self.window_s = time.perf_counter() - self.t
        self.prof.__exit__(*exc)
        return False

    def result(self, units: int) -> Trace:
        path = os.path.join(self.ctx.scratch, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            return read_chrome_trace(path, self.window_s, units)
        finally:
            os.remove(path)


# ----------------------------------------------------------------------------
# One run
# ----------------------------------------------------------------------------

def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, config: Optional[dict] = None,
             workload: Optional[dict] = None) -> tuple:
    """Run one cell once; returns the result line's object and the driver's
    notes.  ``config`` and ``workload`` replace the cell's files (the tests
    run tiny ones on the CPU); ``device`` "cpu" skips the look for a card."""
    t0 = time.perf_counter() if t0 is None else t0
    bench, entry, cfg, wl = cell_files(cell)
    cfg, wl = config or cfg, workload or wl
    chips = int(entry["chips"])
    e2e, per = cell_metrics(bench, cell)
    kind = device
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false: no result")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} GPUs, {torch.cuda.device_count()} visible")
        kind = torch.cuda.get_device_name(0)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        program = importlib.import_module("skyfall_gs_tpu_torch")
    except ImportError as e:
        raise BenchError(f"the program is not in this checkout: {e}") from e
    if ROOT not in Path(program.__file__).resolve().parents:
        raise BenchError(f"the program was imported from {program.__file__}, "
                         f"outside this checkout {ROOT}")
    driver = importlib.import_module(f"drivers.{wl['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench_") as scratch:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                      config=cfg, workload=wl, t0=t0, scratch=scratch)
        out: Outcome = driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", 3)

    limits = wl.get("limits", {})
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in out.checks.items()}
    correct = bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed}
    if trace:
        metrics = {}
        for m in per:
            mod = load_by_path(BENCH_DIR / "metrics" / f"{m['name']}.py",
                               "metric_" + m["name"].replace(".", "_"))
            v = mod.read(out)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {}
        for m in e2e:
            if m["name"] not in out.metrics:
                raise BenchError(f"the driver gave no {m['name']}", 4)
            metrics[m["name"]] = {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(), "idle_gaps": out.trace.idle_gaps()}
    result["device"] = dev
    result["checks"] = checks
    return result, out.notes


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        res, notes = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return e.code
    for n in notes:
        print(n, file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
