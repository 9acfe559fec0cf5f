"""Trajectory video rendering CLI (checkpoint- or PLY-sourced).

Port of ``skyfall_gs_tpu/cli/render_video.py``: render a JSON trajectory
from a training checkpoint or a standalone gaussian PLY (standard or
fused; the 3D filter is recomputed from the trajectory cameras where the
file has none), RGB or colourized depth, optionally under an entry budget,
with optional scale-histogram diagnostics, to an MP4 (or a PNG directory
where OpenCV is missing).  ``--device`` defaults to ``cuda``; there is no
fallback to the CPU.

Usage:
    python -m skyfall_gs_tpu_torch.cli.render_video \
        --checkpoint out/chkpnt30000.npz --camera_path path.json --out fly.mp4
    python -m skyfall_gs_tpu_torch.cli.render_video \
        --ply out/point_cloud/iteration_30000/point_cloud.ply \
        --camera_path path.json --out fly.mp4 --mode depth
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_state_from_ply(ply_path: str, device="cpu"):
    """A render-ready GaussianModelState from a gaussian PLY; returns
    (state, whether the file carried a 3D filter)."""
    from skyfall_gs_tpu_torch.io.gaussian_ply import load_gaussian_ply
    from skyfall_gs_tpu_torch.model.gaussians import state_from_numpy

    d = load_gaussian_ply(ply_path)
    n = d["xyz"].shape[0]
    has_filter = d["filter_3d"] is not None
    zeros = np.zeros(n, np.float32)
    state = state_from_numpy({
        "xyz": d["xyz"], "features_dc": d["features_dc"],
        "features_rest": d["features_rest"], "scaling": d["scaling"],
        "rotation": d["rotation"], "opacity": d["opacity"],
        "alive": np.ones(n, bool),
        "filter_3d": d["filter_3d"] if has_filter else zeros,
        "max_radii2d": zeros, "grad_accum": zeros, "grad_accum_abs": zeros,
        "grad_accum_abs_max": zeros, "denom": zeros,
        "active_sh_degree": d["sh_degree"], "max_sh_degree": d["sh_degree"],
    }, device=device)
    return state, has_filter


def load_state_from_checkpoint(ckpt_path: str, device="cpu"):
    """The model state of a training checkpoint (either package's), loaded
    into a template built from 8 dummy points and the checkpoint's meta.
    Returns (state, iteration)."""
    from skyfall_gs_tpu_torch.model.appearance import AppearanceConfig
    from skyfall_gs_tpu_torch.model.gaussians import create_from_points
    from skyfall_gs_tpu_torch.train.checkpoint import load_checkpoint, peek_checkpoint_meta
    from skyfall_gs_tpu_torch.train.step import init_train_state

    meta = peek_checkpoint_meta(ckpt_path)
    app = AppearanceConfig(*meta["appearance"])
    rng = np.random.default_rng(0)
    dummy_pts = rng.normal(size=(8, 3)).astype(np.float32)
    dummy_cols = np.zeros((8, 3), np.float32)
    template = init_train_state(create_from_points(
        dummy_pts, dummy_cols, max_sh_degree=meta["max_sh_degree"], appearance=app,
        num_cameras=max(meta.get("num_cameras", 1), 1), capacity=meta["capacity"],
        device=device))
    state, it = load_checkpoint(ckpt_path, template)
    return state.model, it


def scale_histogram(state, out: str) -> None:
    """Per-splat max-scale statistics, and a histogram PNG beside ``out``
    where matplotlib is installed."""
    from skyfall_gs_tpu_torch.model.gaussians import get_scaling

    s = get_scaling(state.params).amax(dim=1)[state.aux.alive].cpu().numpy()
    print(f"splats: {s.shape[0]}")
    print(f"Min:    {s.min():.6f}")
    print(f"Max:    {s.max():.6f}")
    print(f"Mean:   {s.mean():.6f}")
    print(f"Std:    {s.std():.6f}")
    print(f"Median: {np.median(s):.6f}")
    print(f"Q99:    {np.percentile(s, 99):.6f}")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 6))
        plt.hist(s, bins=480, range=(0, 30), edgecolor="black")
        plt.title("Gaussian max-scale histogram")
        plt.xlabel("scale")
        plt.ylabel("frequency")
        plt.grid(True, alpha=0.3)
        hist_path = os.path.splitext(out)[0] + "_scale_hist.png"
        plt.savefig(hist_path, dpi=150, bbox_inches="tight")
        plt.close()
        print(f"histogram saved to {hist_path}")
    except Exception as e:  # matplotlib is optional
        print(f"(histogram PNG skipped: {e})")


def main(argv=None):
    """Render and write; returns (frames, measured FPS)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str)
    parser.add_argument("--ply", type=str)
    parser.add_argument("--camera_path", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--mode", choices=["rgb", "depth"], default="rgb")
    parser.add_argument("--kernel_size", type=float, default=0.1)
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--scale_histogram", action="store_true")
    parser.add_argument(
        "--entry_budget", type=int, default=None,
        help="LOD cap on duplicated (splat, tile) entries per frame; splats "
             "are kept greedily by contribution per entry. Bounds render "
             "cost on dense scenes (a lossy speed/quality trade).")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from skyfall_gs_tpu_torch.cli.train import resolve_device
    from skyfall_gs_tpu_torch.viz.paths import load_trajectory
    from skyfall_gs_tpu_torch.viz.video import (
        recompute_filter_for_trajectory,
        render_trajectory,
        write_video,
    )

    if not (args.ply or args.checkpoint):
        parser.error("need --checkpoint or --ply")
    device = resolve_device(args.device)
    cams, _, fps = load_trajectory(args.camera_path, device=device)
    if args.ply:
        state, has_filter = load_state_from_ply(args.ply, device=device)
        if not has_filter:
            state = recompute_filter_for_trajectory(state, cams)
    else:
        state, it = load_state_from_checkpoint(args.checkpoint, device=device)
        print(f"loaded checkpoint at iteration {it}")
        state = recompute_filter_for_trajectory(state, cams)

    if args.scale_histogram:
        scale_histogram(state, args.out)

    bg = torch.full((3,), 1.0 if args.white_background else 0.0, device=device)
    frames, fps_measured = render_trajectory(
        state, cams, bg=bg, kernel_size=args.kernel_size, mode=args.mode,
        entry_budget=args.entry_budget)
    write_video(args.out, frames, fps=fps)
    print(f"wrote {args.out}: {len(frames)} frames, render {fps_measured:.1f} FPS")
    return frames, fps_measured


if __name__ == "__main__":
    main()
