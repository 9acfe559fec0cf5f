"""Run chip_smoke.py's phase 11 (view-parallel training) alone, on a GPU.

    python3 scripts/view_parallel_phase.py

Builds the compositing kernels, times phase 3's single-device step at the
bench workload (median of 20 after 3 warm-up steps, CUDA events) for the
comparison phase 11 prints, writes phase 6's 512 px satellite scene, trains
one ``cli.train`` seed on it (1500 iterations, its checkpoint for 11c and
11d), then runs ``chip_smoke.parallel_phase``: 11a NCCL at
min(device_count, 2) ranks, 11b-11d on two gloo ranks sharing cuda:0, and
``cli.train --data_parallel 1``.  Prints the card's name and power limit
first.  Exits non-zero without a GPU or when a gate of phase 11 fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def phase3_step_ms(torch, dev) -> float:
    from skyfall_gs_tpu_torch.config import OptimizationConfig
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity
    from skyfall_gs_tpu_torch.train.step import init_train_state, make_train_step

    rng = np.random.default_rng(0)
    state, cams = cs.bench_scene(rng, dev, cs.N_GAUSSIANS, cs.IMG)
    ts = init_train_state(state)
    gt = torch.from_numpy(rng.uniform(0, 1, (cs.IMG, cs.IMG, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((cs.IMG, cs.IMG), device=dev)
    depth = torch.from_numpy(rng.uniform(1, 500, (cs.IMG, cs.IMG)).astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)
    cap = measure_bin_capacity(ts.model, cams, kernel_size=0.1)
    step = make_train_step(OptimizationConfig(), use_depth=True, bin_capacity=cap)
    n = cs.WARMUP_STEPS + cs.MEASURE_STEPS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    for i in range(n):
        events[i].record()
        ts, _ = step(ts, cams[i % len(cams)], gt, mask, depth, bg, 1e-4, 0.1)
    events[n].record()
    torch.cuda.synchronize()
    return float(np.median([events[i].elapsed_time(events[i + 1])
                            for i in range(cs.WARMUP_STEPS, n)]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("view_parallel_phase: no CUDA device", file=sys.stderr)
        return 1
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[{card}] devices {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    rt.LIBRARY.load()
    dev = torch.device(cs.DEVICE)
    med = phase3_step_ms(torch, dev)
    print(f"phase 3 step median {med:.3f} ms on [{card}]", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="skyfall_p11_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=dev, **cs.SAT_SCENE)
        train_cli.main(["-s", str(tmp / "scene"), "-m", str(tmp / "model0"), *cs.TRAIN_FLAGS,
                        "--device", cs.DEVICE, "--seed", "0", "--test_iterations",
                        str(cs.TRAIN_ITERS), "--save_iterations", str(cs.TRAIN_ITERS),
                        "--checkpoint_iterations", str(cs.TRAIN_ITERS), "--quiet"])
        torch.cuda.empty_cache()
        sat = {"scene": tmp / "scene", "median": {"model": tmp / "model0"}}
        t0 = time.perf_counter()
        launches = cs.parallel_phase(torch, dev, card, tmp, sat, med)
        print(f"phase 11 alone {time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
