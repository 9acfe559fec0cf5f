"""Run chip_smoke.py's phase 13 (tensor-parallel FLUX) alone, on a GPU.

    python3 scripts/flux_shard_phase.py

Builds the compositing kernels, writes phase 6's 512 px satellite scene,
trains one ``cli.train`` seed on it (1500 iterations, its checkpoint for
the IDU episodes of 13c and 13d), renders two 1024^2 orbit views from that checkpoint
(elevation 85, radius 300: the first jax_v1 episode's ring), runs
``chip_smoke.flux_phase`` (8b) on them for the unsharded FLUX.1-dev's
velocity and refined frames, frees that model, then runs
``chip_smoke.flux_tp_phase``: 13a-13d on two gloo ranks sharing cuda:0
and 13a on NCCL at min(device_count, 2) ranks.  Prints the card's name and
power limit first.  Exits non-zero without a GPU or when a gate of phase 8b
or 13 fails.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flux_shard_phase: no CUDA device", file=sys.stderr)
        return 1
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
    from skyfall_gs_tpu_torch.core.camera import orbit_cameras
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[{card}] devices {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    rt.LIBRARY.load()
    dev = torch.device(cs.DEVICE)
    with tempfile.TemporaryDirectory(prefix="skyfall_p13_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=dev, **cs.SAT_SCENE)
        train_cli.main(["-s", str(tmp / "scene"), "-m", str(tmp / "model0"), *cs.TRAIN_FLAGS,
                        "--device", cs.DEVICE, "--seed", "0", "--test_iterations",
                        str(cs.TRAIN_ITERS), "--save_iterations", str(cs.TRAIN_ITERS),
                        "--checkpoint_iterations", str(cs.TRAIN_ITERS), "--quiet"])
        model, _ = load_state_from_checkpoint(
            str(tmp / "model0" / f"chkpnt{cs.TRAIN_ITERS}.npz"), device=dev)
        cams = orbit_cameras([0, 0, 0], 85.0, 300.0, num_cams=2, width=1024, height=1024,
                             fov_deg=60.0, device=dev)
        cap = measure_bin_capacity(model, cams, kernel_size=0.1)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            frames = [torch.clamp(render(model, c, bg, testing=True, bin_capacity=cap).color,
                                  0.0, 1.0).cpu().numpy() for c in cams]
        del model
        refiner, _, handoff = cs.flux_phase(torch, dev, card, frames)
        del refiner
        torch.cuda.empty_cache()
        sat = {"scene": tmp / "scene", "median": {"model": tmp / "model0"}}
        t0 = time.perf_counter()
        launches = cs.flux_tp_phase(torch, card, tmp, sat, handoff)
        print(f"phase 13 alone {time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
