"""Run chip_smoke.py's phase 12 (gaussian-sharded training) alone, on a GPU.

    python3 scripts/gauss_shard_phase.py

Builds the compositing kernels, times phase 3's single-device step at the
bench workload (``view_parallel_phase.phase3_step_ms``) for the comparison
phase 12 prints, writes phase 6's 512 px satellite scene, trains one
``cli.train`` seed on it (1500 iterations, its checkpoint for 12b's IDU
episode), then runs ``chip_smoke.gauss_phase``: 12a at min(device_count, 2)
NCCL ranks and on two gloo ranks sharing cuda:0, 12b on those gloo ranks and
``cli.train --shard_gaussians 1``, 12c the (2, 2) grid on four gloo ranks.
Prints the card's name and power limit first.  Exits non-zero without a GPU
or when a gate of phase 12 fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

from view_parallel_phase import cs, phase3_step_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gauss_shard_phase: no CUDA device", file=sys.stderr)
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
    with tempfile.TemporaryDirectory(prefix="skyfall_p12_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=dev, **cs.SAT_SCENE)
        train_cli.main(["-s", str(tmp / "scene"), "-m", str(tmp / "model0"), *cs.TRAIN_FLAGS,
                        "--device", cs.DEVICE, "--seed", "0", "--test_iterations",
                        str(cs.TRAIN_ITERS), "--save_iterations", str(cs.TRAIN_ITERS),
                        "--checkpoint_iterations", str(cs.TRAIN_ITERS), "--quiet"])
        torch.cuda.empty_cache()
        sat = {"scene": tmp / "scene", "median": {"model": tmp / "model0"}}
        t0 = time.perf_counter()
        launches = cs.gauss_phase(torch, dev, card, tmp, sat, med)
        print(f"phase 12 alone {time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
