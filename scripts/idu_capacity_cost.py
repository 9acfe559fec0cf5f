"""Time an IDU episode with and without its per-step binning-capacity measure, on one GPU.

    python3 scripts/idu_capacity_cost.py [--episodes 1]

Runs chip_smoke.py's phase-8a Stage 1 (its 512 px satellite scene, pseudo
views) through ``cli.train``, then the first ``--episodes`` IDU episodes
from its checkpoint four times, in turns: ``measured`` (the default: each
step measures its own view and raises the capacity when short), ``pinned``,
``pinned``, ``measured``.  A pinned run passes ``--bin_capacity`` at the
largest capacity the first measured run's steps used, so it skips the
measure; it bins every step at that capacity, and its overflow is printed
(it follows its own trajectory).  Each run prints its training it/s (the
view generation excluded), step capacity and overflow, with the card's
name and power limit.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=1)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("idu_capacity_cost: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene

    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene, stage1 = tmp / "scene", tmp / "stage1"
        write_satellite_scene(str(scene), device=cs.DEVICE, **cs.SAT_SCENE)
        common = ["-s", str(scene), "--eval", "--device", cs.DEVICE, "--seed", "0", "--quiet",
                  "--lambda_pseudo_depth", "0.5", "--depth_model", "render"]
        train_cli.main(common + ["-m", str(stage1)] + cs.flag_list(cs.S1_FLAGS) + [
            "--checkpoint_iterations", str(cs.S1_ITERS), "--test_iterations",
            str(cs.S1_ITERS), "--save_iterations", str(cs.S1_ITERS)])
        ckpt = stage1 / f"chkpnt{cs.S1_ITERS}.npz"

        rows, pinned = [], None
        for k, mode in enumerate(("measured", "pinned", "pinned", "measured")):
            extra = ["--bin_capacity", str(pinned)] if mode == "pinned" else []
            orch, _ = train_cli.main(common + [
                "-m", str(tmp / f"stage2_{k}"), "--iterative_datasets_update",
                "--start_checkpoint", str(ckpt), "--refiner", "identity",
                "--idu_episodes", str(opts.episodes)] + cs.flag_list(cs.IDU_FLAGS) + extra)
            eps = orch.episodes
            row = {"mode": mode, "iterations": sum(e["iterations"] for e in eps),
                   "train_s": sum(e["train_s"] for e in eps),
                   "step_capacity": max(e["step_capacity"] for e in eps),
                   "overflow": orch.max_overflow}
            row["it_per_s"] = row["iterations"] / row["train_s"]
            if pinned is None:
                pinned = row["step_capacity"]
            rows.append(row)
            print(f"idu_capacity_cost: {mode} run {k} on [{card}]: {row['iterations']} "
                  f"iterations in {row['train_s']:.3f} s ({row['it_per_s']:.3f} it/s), step "
                  f"capacity up to {row['step_capacity']}, overflow {row['overflow']}",
                  flush=True)
            del orch
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
