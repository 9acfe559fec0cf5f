"""Run chip_smoke.py's phase 6 quality gate alone, on a GPU, for one tree.

    python3 scripts/quality_phase6.py [--tree DIR] [--seeds 0 1 2 3 4 5] [--repeats R]

Writes phase 6's 512 px satellite scene, trains ``cli.train`` of DIR's
``skyfall_gs_tpu_torch`` (default: this checkout) on it with phase 6's
flags once per seed (``--repeats`` times over), and prints each seed's
final test PSNR, the median of the gate seeds (``SAT_SEEDS``, what phase 6
holds against ``PSNR_FLOOR_DB``) and the median of all runs, then
``p_gate_fail``: the share of all ways of taking ``--per_seed`` runs of
each gate seed whose median is under the floor, the gate's failure rate on
this tree as far as the repeats sample it.  The scene, flags, iterations
and floor are this checkout's ``chip_smoke.py`` constants whatever DIR is,
so two trees (one unpacked with ``git archive`` into a gitignored
directory) are compared on the same work: run them in turns within one
call.  The last line is one JSON object.  Exits non-zero without a GPU;
the floor is reported, not gated.  ``--from_json LOG`` recomputes the
statistics from an earlier run's log (``--floor``, ``--per_seed``,
``--shift``) on the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
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


def gate_failure_rate(runs: list[list[float]], floor: float, per_seed: int = 1) -> float:
    """Share of the picks of ``per_seed`` distinct runs of each gate seed
    (``runs[i]`` holds seed i's runs) whose median is under ``floor``."""
    picks = [np.array(list(itertools.combinations(r, per_seed))) for r in runs]
    n_fail = n_all = 0
    for pick in itertools.product(*picks):
        n_fail += np.median(np.concatenate(pick)) < floor
        n_all += 1
    return n_fail / n_all


def summary(psnr: dict[int, list[float]], seeds, floor: float, per_seed: int) -> dict:
    """The gate's statistics over ``psnr`` (seed -> its runs' test PSNRs)."""
    repeats = min(len(v) for v in psnr.values())
    gated = set(seeds) <= set(psnr)
    return {"psnr": psnr,
            "median_gate_seeds": [float(np.median([psnr[s][r] for s in seeds]))
                                  for r in range(repeats)] if gated else None,
            "median_all": float(np.median([v for vs in psnr.values() for v in vs])),
            "floor": floor, "per_seed": per_seed,
            "p_gate_fail": gate_failure_rate([psnr[s] for s in seeds], floor, per_seed)
            if gated and repeats >= per_seed else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose skyfall_gs_tpu_torch trains")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--repeats", type=int, default=1, help="train every seed this many times")
    ap.add_argument("--floor", type=float, default=None,
                    help="the floor p_gate_fail reads (default chip_smoke.PSNR_FLOOR_DB)")
    ap.add_argument("--per_seed", type=int, default=None,
                    help="runs of each gate seed in the gate's median (default: "
                         "chip_smoke.SAT_SEEDS' count of each)")
    ap.add_argument("--from_json", default=None,
                    help="read the runs from the last line an earlier run printed and train "
                         "nothing (needs no GPU)")
    ap.add_argument("--shift", type=float, default=0.0,
                    help="with --from_json: add this many dB to every run first (how a tree "
                         "that much worse or better would fare)")
    args = ap.parse_args()
    cs = _chip_smoke()
    seeds = sorted(set(cs.SAT_SEEDS))
    floor = cs.PSNR_FLOOR_DB if args.floor is None else args.floor
    per_seed = args.per_seed or cs.SAT_SEEDS.count(seeds[0])
    if args.from_json:
        with open(args.from_json) as f:
            last = [line for line in f if line.startswith("{")][-1]
        psnr = {int(k): [x + args.shift for x in v]
                for k, v in json.loads(last)["psnr"].items()}
        print(json.dumps(summary(psnr, seeds, floor, per_seed)))
        return 0
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("quality_phase6: no CUDA device", file=sys.stderr)
        return 1
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

    assert Path(rt.__file__).resolve().is_relative_to(tree), rt.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[{card}] tree {tree} torch {torch.__version__}", flush=True)
    psnr: dict[int, list[float]] = {seed: [] for seed in args.seeds}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="skyfall_q6_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=torch.device(cs.DEVICE),
                              **cs.SAT_SCENE)
        for seed in [s for _ in range(args.repeats) for s in args.seeds]:
            model = tmp / f"model{seed}_{len(psnr[seed])}"
            t0 = time.perf_counter()
            train_cli.main(["-s", str(tmp / "scene"), "-m", str(model), *cs.TRAIN_FLAGS,
                            "--device", cs.DEVICE, "--seed", str(seed), "--test_iterations",
                            str(cs.TRAIN_ITERS), "--quiet"])
            with open(model / "metrics.jsonl") as f:
                records = [json.loads(line) for line in f]
            psnr[seed].append([r["psnr"] for r in records
                               if r["type"] == "eval" and r["split"] == "test"][-1])
            print(f"seed {seed}: test PSNR {psnr[seed][-1]:.3f} dB in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {"tree": str(tree), "card": card, **summary(psnr, seeds, floor, per_seed),
           "seconds": time.perf_counter() - t_start}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
