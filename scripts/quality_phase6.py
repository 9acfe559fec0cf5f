"""Run chip_smoke.py's phase 6 quality gate alone, on a GPU, for one tree.

    python3 scripts/quality_phase6.py [--tree DIR] [--seeds 0 1 2 3 4 5]

Writes phase 6's 512 px satellite scene, trains ``cli.train`` of DIR's
``skyfall_gs_tpu_torch`` (default: this checkout) on it with phase 6's
flags once per seed, and prints each seed's final test PSNR, the median of
seeds 0-2 (what phase 6 holds against PSNR_FLOOR_DB) and the median of all
seeds.  The scene, flags, iterations and floor are this checkout's
``chip_smoke.py`` constants whatever DIR is, so two trees (one unpacked
with ``git archive`` into a gitignored directory) are compared on the same
work: run them in turns within one call.  The last line is one JSON
object.  Exits non-zero without a GPU; the floor is reported, not gated.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose skyfall_gs_tpu_torch trains")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("quality_phase6: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

    assert Path(rt.__file__).resolve().is_relative_to(tree), rt.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[{card}] tree {tree} torch {torch.__version__}", flush=True)
    rt.build_library()
    rt._library()
    psnr = {}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="skyfall_q6_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=torch.device(cs.DEVICE),
                              **cs.SAT_SCENE)
        for seed in args.seeds:
            model = tmp / f"model{seed}"
            t0 = time.perf_counter()
            train_cli.main(["-s", str(tmp / "scene"), "-m", str(model), *cs.TRAIN_FLAGS,
                            "--device", cs.DEVICE, "--seed", str(seed), "--test_iterations",
                            str(cs.TRAIN_ITERS), "--quiet"])
            with open(model / "metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            psnr[seed] = [r["psnr"] for r in records
                          if r["type"] == "eval" and r["split"] == "test"][-1]
            print(f"seed {seed}: test PSNR {psnr[seed]:.3f} dB in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    gate = [psnr[s] for s in cs.SAT_SEEDS if s in psnr]
    out = {"tree": str(tree), "card": card, "psnr": psnr,
           "median_gate_seeds": float(np.median(gate)) if len(gate) == len(cs.SAT_SEEDS)
           else None,
           "median_all": float(np.median(list(psnr.values()))),
           "floor": cs.PSNR_FLOOR_DB, "seconds": time.perf_counter() - t_start}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
