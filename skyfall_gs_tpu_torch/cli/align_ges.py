"""Google-Earth-Studio alignment: search the orbit target altitude that best
matches reference GES frames.

Port of ``skyfall_gs_tpu/cli/align_ges.py`` (reference align_ges.py): a
ternary search over the look-at altitude in [``--alt_lo``, ``--alt_hi``];
each candidate renders the orbit of ``--num_frames`` cameras at the
reference frames' size and scores the mean SSIM against them; the best
altitude's 240-frame orbit is written as a trajectory JSON.

The reference frames move to ``--device`` once (default ``cuda``; there is
no fallback to the CPU), and every render and SSIM stays there: a score
reads one float back.

Usage:
    python -m skyfall_gs_tpu_torch.cli.align_ges --checkpoint out/chkpnt30000.npz \\
        --ges_frames ges/ --out_path aligned_path.json
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _load_frames(folder: str, limit: int) -> list:
    import cv2

    names = sorted(os.listdir(folder))[:limit]
    out = []
    for n in names:
        img = cv2.imread(os.path.join(folder, n))
        if img is not None:
            out.append(img[..., ::-1].astype(np.float32) / 255.0)
    return out


@torch.no_grad()
def score_alignment(state, target_alt: float, args, ref_frames: torch.Tensor) -> float:
    """Mean SSIM of the orbit around (target_x, target_y, target_alt)
    against ``ref_frames``, an (F, 3, H, W) tensor on the state's device.
    Raises if a render overflowed its binning capacity."""
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
    from skyfall_gs_tpu_torch.ops.ssim import ssim
    from skyfall_gs_tpu_torch.viz.paths import gen_orbit_path, parse_trajectory_json

    dev = state.params.xyz.device
    target = [args.target_x, args.target_y, target_alt]
    path = {
        "_target": target,
        "_radius": args.radius,
        "_elevation": args.elevation,
        "render_height": ref_frames.shape[2],
        "render_width": ref_frames.shape[3],
        "fps": 24,
        "camera_path": [
            {"camera_to_world": c.flatten().tolist(), "fov": args.fov, "aspect": 1}
            for c in gen_orbit_path(target, args.elevation, args.radius, len(ref_frames))
        ],
    }
    cams, _ = parse_trajectory_json(path, device=dev)
    cap = measure_bin_capacity(state, cams)
    bg = torch.zeros(3, device=dev)
    scores, overflow = [], []
    for cam, ref in zip(cams, ref_frames):
        out = render(state, cam, bg, testing=True, bin_capacity=cap, inference=True)
        scores.append(ssim(torch.clamp(out.color, 0.0, 1.0).permute(2, 0, 1), ref))
        overflow.append(out.overflow)
    if int(torch.stack(overflow).max()):
        raise RuntimeError(f"binning overflow in an orbit render at capacity {cap}")
    return float(torch.stack(scores).mean())


def main(argv=None) -> float:
    """Search and write the path; returns the best target altitude."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--ges_frames", required=True)
    parser.add_argument("--target_x", type=float, default=0.0)
    parser.add_argument("--target_y", type=float, default=0.0)
    parser.add_argument("--alt_lo", type=float, default=-50.0)
    parser.add_argument("--alt_hi", type=float, default=150.0)
    parser.add_argument("--elevation", type=float, default=45.0)
    parser.add_argument("--radius", type=float, default=200.0)
    parser.add_argument("--fov", type=float, default=60.0)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--num_frames", type=int, default=8)
    parser.add_argument("--out_path", default="aligned_path.json")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
    from skyfall_gs_tpu_torch.cli.train import resolve_device
    from skyfall_gs_tpu_torch.viz.paths import save_orbit_path

    device = resolve_device(args.device)
    state, _ = load_state_from_checkpoint(args.checkpoint, device=device)
    ref = _load_frames(args.ges_frames, args.num_frames)
    if not ref:
        parser.error("no reference frames found")
    ref_dev = torch.from_numpy(np.stack(ref)).permute(0, 3, 1, 2).contiguous().to(device)

    lo, hi = args.alt_lo, args.alt_hi
    # golden-section-ish ternary search on SSIM(altitude)
    for it in range(args.iters):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        s1 = score_alignment(state, m1, args, ref_dev)
        s2 = score_alignment(state, m2, args, ref_dev)
        print(f"[{it}] alt {m1:.2f}: ssim {s1:.4f} | alt {m2:.2f}: ssim {s2:.4f}")
        if s1 < s2:
            lo = m1
        else:
            hi = m2
    best = 0.5 * (lo + hi)
    print(f"best target altitude: {best:.2f}")
    save_orbit_path(args.out_path, [args.target_x, args.target_y, best],
                    args.elevation, args.radius, 240, args.fov,
                    ref[0].shape[1], ref[0].shape[0])
    print("wrote", args.out_path)
    return best


if __name__ == "__main__":
    main()
