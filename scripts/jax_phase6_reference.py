"""The JAX package's result on chip_smoke.py's phase 6 work, on the CPU.

    python3 scripts/jax_phase6_reference.py [--seeds 0 1 2] [--jobs 2] [--out DIR]

Writes phase 6's 512 px satellite scene with the JAX package's
``scripts/make_synthetic_satellite.py`` (``chip_smoke.SAT_SCENE``), then
trains ``skyfall_gs_tpu.cli.train`` on it once per seed with phase 6's
flags (``TRAIN_FLAGS``, ``TRAIN_ITERS``) and prints each seed's final test
PSNR, splat count and wall time, then one JSON line with the seeds'
median.  This is the reference that ``PSNR_FLOOR_DB`` stands on: the
median of seeds 0-2 minus 1 dB.  Every run is a JAX process of its own
pinned to the CPU (Pallas in interpret mode); ``--jobs`` runs that many
seeds at once, each on its share of the cores: about 2.6 hours per seed
with two at once on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's chip_smoke.py, for its phase 6 constants."""
    spec = importlib.util.spec_from_file_location("chip_smoke_constants",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _final_test(model: Path) -> tuple[float, int]:
    with open(model / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    psnr = [r["psnr"] for r in records if r["type"] == "eval" and r["split"] == "test"]
    alive = [r["n_alive"] for r in records if r["type"] == "step"]
    return psnr[-1], int(alive[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--jobs", type=int, default=1, help="seeds trained at once")
    ap.add_argument("--out", default=None, help="scene and model directories (default: a temp dir)")
    ap.add_argument("--iterations", type=int, default=None,
                    help="train this many iterations instead of phase 6's (a rehearsal)")
    args = ap.parse_args()
    cs = _chip_smoke()
    iters = args.iterations or cs.TRAIN_ITERS
    flags = list(cs.TRAIN_FLAGS)
    flags[flags.index("--iterations") + 1] = str(iters)
    out = Path(args.out or tempfile.mkdtemp(prefix="jax_phase6_"))
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", SKYFALL_INTERPRET="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))

    scene = out / "scene"
    if not (scene / "transforms_train.json").exists():
        sc = cs.SAT_SCENE
        subprocess.run([sys.executable, str(ROOT / "scripts" / "make_synthetic_satellite.py"),
                        "--out", str(scene), "--size", str(sc["size"]),
                        "--n_points", str(sc["n_points"]), "--n_views", str(sc["n_views"]),
                        "--seed", str(sc["seed"])], check=True, env=env)

    cores = sorted(os.sched_getaffinity(0))
    share = max(1, len(cores) // args.jobs)
    pending = list(args.seeds)
    running: dict[int, tuple[subprocess.Popen, int, float]] = {}   # seed -> (proc, slot, t0)
    results = {}
    while pending or running:
        while pending and len(running) < args.jobs:
            seed = pending.pop(0)
            slot = min(set(range(args.jobs)) - {r[1] for r in running.values()})
            mine = ",".join(str(c) for c in cores[slot * share:(slot + 1) * share])
            model = out / f"model{seed}"
            cmd = ["taskset", "-c", mine, sys.executable, "-m", "skyfall_gs_tpu.cli.train",
                   "-s", str(scene), "-m", str(model), *flags, "--seed", str(seed),
                   "--test_iterations", str(iters), "--save_iterations", str(iters),
                   "--checkpoint_iterations", str(iters), "--quiet"]
            with open(out / f"seed{seed}.log", "w") as log:
                proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
            running[seed] = (proc, slot, time.perf_counter())
        time.sleep(5)
        for seed, (proc, _, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            del running[seed]
            if proc.returncode != 0:
                print(f"seed {seed}: cli.train exited {proc.returncode}; see "
                      f"{out / f'seed{seed}.log'}", file=sys.stderr)
                return 1
            psnr, n = _final_test(out / f"model{seed}")
            results[seed] = {"psnr": psnr, "n_splats": n, "wall_s": time.perf_counter() - t0}
            print(f"seed {seed}: test PSNR {psnr:.3f} dB, {n} splats, "
                  f"{results[seed]['wall_s'] / 60:.1f} min", flush=True)
    psnrs = [results[s]["psnr"] for s in args.seeds]
    print(json.dumps({"iterations": iters, "seeds": args.seeds,
                      "psnr": psnrs, "median_psnr": float(np.median(psnrs)),
                      "n_splats": [results[s]["n_splats"] for s in args.seeds],
                      "wall_s": [results[s]["wall_s"] for s in args.seeds]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
