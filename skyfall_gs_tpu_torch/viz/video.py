"""Trajectory rendering: the fly-through / FPS benchmark path.

Port of ``skyfall_gs_tpu/viz/video.py``: render every camera of a path
with the forward kernel alone (``inference=True``), RGB or colourized
depth, at a binning capacity measured for the path (or the entry budget's),
and write an MP4 or a PNG directory.

The FPS means what it means in the JAX package: one warm-up frame, then
every frame rendered and kept on the device, timed between two device
synchronizations; frames move to the host after the clock stops.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.io.png import write_png
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianModelState,
    camera_filter_arrays,
    compute_3d_filter,
)
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
from skyfall_gs_tpu_torch.viz.colormap import colorize_depth


def _to_uint8(frame: np.ndarray) -> np.ndarray:
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def write_video(path: str, frames: List[np.ndarray], fps: int = 24) -> str:
    """Write (H, W, 3) float [0,1] frames to an MP4 through OpenCV; where
    OpenCV is missing or its writer does not open, write the frames as
    ``<path without extension>/00000.png ...`` instead.  Prints and returns
    what it wrote."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = None
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            writer = None
    if writer is None:
        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(base, f"{i:05d}.png"), _to_uint8(f))
        print(f"wrote {len(frames)} PNG frames to {base}/ (no MP4 writer)", flush=True)
        return base
    for f in frames:
        writer.write(_to_uint8(f[..., ::-1]))
    writer.release()
    print(f"wrote MP4 {path}", flush=True)
    return path


@torch.no_grad()
def recompute_filter_for_trajectory(state: GaussianModelState,
                                    cameras: List[Camera]) -> GaussianModelState:
    """Refresh the 3D filter from the trajectory cameras (a standalone PLY
    has no training cameras around), in place."""
    state.aux.filter_3d.copy_(compute_3d_filter(state.params.xyz, state.aux.alive,
                                                *camera_filter_arrays(cameras)))
    return state


@torch.no_grad()
def render_trajectory(
    state: GaussianModelState,
    cameras: List[Camera],
    bg: Optional[torch.Tensor] = None,
    kernel_size: float = 0.1,
    mode: str = "rgb",                    # "rgb" | "depth"
    backend: str = "tiled",
    with_3d_filter: bool = True,
    report_fps: bool = True,
    entry_budget: Optional[int] = None,
) -> tuple[List[np.ndarray], float]:
    """Render every camera; returns (frames, frames per second measured).

    The binning capacity is measured over the path (the shape-only default
    drops most entries of a dense scene at 1080p), except under
    ``entry_budget``, where the budget is the capacity.  Raises if any frame
    overflowed its capacity (splats would be missing from it).
    """
    dev = state.params.xyz.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    cap = None
    if entry_budget is None:
        cap = measure_bin_capacity(state, cameras, kernel_size=kernel_size,
                                   with_3d_filter=with_3d_filter)

    def rfn(camera):
        out = render(state, camera, bg, kernel_size=kernel_size, testing=True,
                     backend=backend, with_3d_filter=with_3d_filter, bin_capacity=cap,
                     inference=(backend == "tiled"), entry_budget=entry_budget)
        return torch.clamp(out.color, 0.0, 1.0), out.depth, out.alpha, out.overflow

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rfn(cameras[0])                       # warm-up
    sync()
    t0 = time.perf_counter()
    outs = [rfn(cam) for cam in cameras]
    sync()
    fps = len(cameras) / max(time.perf_counter() - t0, 1e-9)

    if outs[0][3] is not None:
        overflow = int(torch.stack([o[3] for o in outs]).max())
        if overflow:
            raise RuntimeError(f"binning overflow: {overflow} entries dropped from a frame "
                               f"at capacity {cap or entry_budget}")
    frames: List[np.ndarray] = []
    for color, depth, alpha, _ in outs:
        if mode == "depth":
            frames.append(colorize_depth(depth.cpu().numpy(),
                                         mask=alpha.cpu().numpy() > 0.01))
        else:
            frames.append(color.cpu().numpy())
    if report_fps:
        print(f"rendered {len(cameras)} frames @ {fps:.1f} FPS "
              f"({cameras[0].width}x{cameras[0].height})", flush=True)
    return frames, fps
