"""Hold band renders against the full frame on trained checkpoints, on a GPU.

    python3 scripts/band_render_check.py [--seeds 0 1 2 3 4 5 6 7] [--cams 8]

Writes chip_smoke.py's phase 6 satellite scene, trains ``cli.train`` on it
with phase 6's flags once per seed, and renders each checkpoint from phase
11d's 1920x1080 orbit (elevation 45, radius 300, fov 60) at ``--cams``
azimuths: the full frame, and the frame stacked from two
``core.camera.band_camera`` bands (what ``make_tile_parallel_render``
gathers).  Each band is rendered twice: with the full frame's EWA clamp
window (``band_camera`` as it is) and with the band's own field of view
(``clamp_window=None``, the JAX package's band).  Prints the max and mean
absolute difference from the full frame per seed and camera, then one JSON
object as the last line; phase 11d's gate (max 6e-2, mean 5e-3) reads
camera 0.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's chip_smoke.py, for its phase 6 and 11d constants."""
    spec = importlib.util.spec_from_file_location("chip_smoke_constants",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--cams", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("band_render_check: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
    from skyfall_gs_tpu_torch.core.camera import band_camera, orbit_cameras
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"[{card}] torch {torch.__version__}", flush=True)
    rt.LIBRARY.load()
    v, bg = cs.P_VIEW, torch.zeros(3, device=cs.DEVICE)

    def draw(model, cam):
        cap = measure_bin_capacity(model, [cam], kernel_size=0.1)
        out = render(model, cam, bg, testing=True, inference=True, bin_capacity=cap)
        assert int(out.overflow) == 0
        return out.color

    results = {}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="skyfall_band_") as tmp:
        tmp = Path(tmp)
        write_satellite_scene(str(tmp / "scene"), device=torch.device(cs.DEVICE),
                              **cs.SAT_SCENE)
        for seed in args.seeds:
            model_dir = tmp / f"model{seed}"
            train_cli.main(["-s", str(tmp / "scene"), "-m", str(model_dir), *cs.TRAIN_FLAGS,
                            "--device", cs.DEVICE, "--seed", str(seed), "--test_iterations",
                            str(cs.TRAIN_ITERS), "--checkpoint_iterations",
                            str(cs.TRAIN_ITERS), "--quiet"])
            model, _ = load_state_from_checkpoint(
                str(model_dir / f"chkpnt{cs.TRAIN_ITERS}.npz"), device=cs.DEVICE)
            cams = orbit_cameras([0, 0, 0], v["elevation"], v["radius"], num_cams=args.cams,
                                 width=v["width"], height=v["height"], fov_deg=v["fov_deg"],
                                 device=cs.DEVICE)
            rows = []
            with torch.no_grad():
                for i, cam in enumerate(cams):
                    full = draw(model, cam)
                    row = {}
                    for name, own in (("full_window", False), ("band_fov", True)):
                        bands = []
                        for k in range(2):
                            b = band_camera(cam, k, 2)
                            if own:
                                b = dataclasses.replace(b, clamp_window=None)
                            bands.append(draw(model, b))
                        diff = (torch.cat(bands) - full).abs()
                        row[name] = [float(diff.max()), float(diff.mean())]
                    rows.append(row)
                    print(f"seed {seed} camera {i}: full frame's window max "
                          f"{row['full_window'][0]:.3e} mean {row['full_window'][1]:.3e}; "
                          f"band's own FoV max {row['band_fov'][0]:.3e} mean "
                          f"{row['band_fov'][1]:.3e}", flush=True)
            results[seed] = {"splats": int(model.num_alive), "cameras": rows}
            del model
            torch.cuda.empty_cache()
    worst = {name: max(r[name][0] for s in results.values() for r in s["cameras"])
             for name in ("full_window", "band_fov")}
    gate = {name: [s["cameras"][0][name] for s in results.values()]
            for name in ("full_window", "band_fov")}
    over = {name: sum(m > cs.P_BAND_MAX or a > cs.P_BAND_MEAN for m, a in gate[name])
            for name in gate}
    print(json.dumps({"card": card, "seeds": args.seeds, "worst_max": worst,
                      "camera0_over_gate": over, "bounds": [cs.P_BAND_MAX, cs.P_BAND_MEAN],
                      "results": results, "seconds": time.perf_counter() - t_start}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
