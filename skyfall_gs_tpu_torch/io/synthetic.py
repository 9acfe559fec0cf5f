"""Synthetic scenes for smoke tests, the quality gate and the CLI chain.

Port of ``skyfall_gs_tpu/io/synthetic.py`` and of
``scripts/make_synthetic_satellite.py``: ground-truth Gaussians render the
"captures", and training must recover them from a corrupted
initialization.  The numpy draws are the JAX package's, in the same order,
so the scene geometry, colors and initial point cloud are identical; the
ground truth is rendered by the port's rasterizer on ``device``.
``make_city_scene`` builds a scene in memory; ``write_satellite_scene``
writes one to disk in the satellite layout the readers consume.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import orbit_cameras
from skyfall_gs_tpu_torch.io.colmap import write_points3d_text
from skyfall_gs_tpu_torch.io.png import write_png
from skyfall_gs_tpu_torch.io.scene import SceneData, View
from skyfall_gs_tpu_torch.model.gaussians import create_from_points
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render


def make_city_scene(
    tmpdir: str,
    n_views: int = 12,
    size: int = 64,
    n_points: int = 400,
    seed: int = 0,
    n_test: int = 2,
    device="cpu",
) -> SceneData:
    """Procedural city block: GT splats render the views; the init is a
    noisy half-density subsample with gray colors (what a degraded SfM
    cloud looks like).  Views and train groups live on ``device``."""
    rng = np.random.default_rng(seed)
    ground = np.stack([
        rng.uniform(-1.5, 1.5, n_points // 2),
        rng.uniform(-1.5, 1.5, n_points // 2),
        np.zeros(n_points // 2),
    ], axis=1)
    towers = np.stack([
        rng.choice([-0.7, 0.0, 0.8], n_points // 2)
        + rng.normal(0, 0.05, n_points // 2),
        rng.choice([-0.6, 0.3, 0.9], n_points // 2)
        + rng.normal(0, 0.05, n_points // 2),
        rng.uniform(0, 0.8, n_points // 2),
    ], axis=1)
    pts = np.concatenate([ground, towers]).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n_points, 3)).astype(np.float32)

    cap = -(-n_points // 1024) * 1024
    gt_state = create_from_points(pts, cols, capacity=cap, init_opacity=0.9, device=device)
    cams = orbit_cameras([0, 0, 0.2], 40.0, 4.0, num_cams=n_views, width=size,
                         height=size, fov_deg=60.0, uid_base=0, device=device)
    bg = torch.zeros(3, device=device)
    views = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            out = render(gt_state, cam, bg, with_3d_filter=False, inference=True)
            views.append(View(camera=cam,
                              image=torch.clamp(out.color, 0, 1).cpu().numpy(),
                              mask=np.ones((size, size), np.float32),
                              depth=out.depth.cpu().numpy(), image_name=f"v{i}"))

    sub = rng.choice(n_points, n_points // 2, replace=False)
    init_pts = pts[sub] + rng.normal(0, 0.05, (len(sub), 3)).astype(np.float32)
    init_cols = np.full((len(sub), 3), 0.5, np.float32)

    scene = SceneData(
        source_path=tmpdir, scene_type="synthetic",
        points=init_pts, colors=init_cols,
        train_views=views[:-n_test], test_views=views[-n_test:],
        cameras_extent=4.4, device=str(device),
    )
    scene.build_groups()
    return scene


@torch.no_grad()
def test_psnr(trainer, scene: SceneData, state) -> float:
    """Mean test-view PSNR under the trainer's eval render."""
    vals = []
    for v in scene.test_views:
        out = trainer._eval_render(state.model, v.camera, trainer.bg)
        img = torch.clamp(out.color, 0, 1)
        gt = torch.tensor(v.image, device=img.device)
        mse = torch.mean((img - gt) ** 2)
        vals.append(float(-10 * torch.log10(torch.clamp_min(mse, 1e-10))))
    return float(np.mean(vals))


def satellite_city(rng: np.random.Generator, n: int):
    """The ground-truth Gaussian centres and colours of
    ``write_satellite_scene``'s city block (a ground disk of radius 220 m
    and 30 buildings 10-60 m tall), drawn from ``rng`` in the script's
    order: (n, 3) float32 points (x east, y north, z up, metres) and (n, 3)
    float32 colours."""
    r = 220 * np.sqrt(rng.uniform(0, 1, n // 2))
    th = rng.uniform(0, 2 * np.pi, n // 2)
    ground = np.stack([r * np.cos(th), r * np.sin(th), rng.normal(0, 0.5, n // 2)], 1)
    n_bld = 30
    centers = rng.uniform(-180, 180, (n_bld, 2))
    heights = rng.uniform(10, 60, n_bld)
    bidx = rng.integers(0, n_bld, n - n // 2)
    bld = np.stack([
        centers[bidx, 0] + rng.normal(0, 8, n - n // 2),
        centers[bidx, 1] + rng.normal(0, 8, n - n // 2),
        heights[bidx] * rng.uniform(0, 1, n - n // 2),
    ], 1)
    pts = np.concatenate([ground, bld]).astype(np.float32)
    cols = rng.uniform(0.15, 0.85, (n, 3)).astype(np.float32)
    return pts, cols


@torch.no_grad()
def write_satellite_scene(out: str, size: int = 256, n_points: int = 40_000,
                          n_views: int = 16, seed: int = 0, device="cpu") -> int:
    """Write a procedural city block in the satellite layout: images
    (PNG), ``masks/*.npy``, ``depths_moge/*.npy``, ``transforms_{train,test}
    .json`` (fl/cx/cy and an identity global R/T fix) and a noisy
    ``points3D.txt`` init cloud of ``n_points // 3`` points.  The recipe and
    draws are ``scripts/make_synthetic_satellite.py``'s; the ground truth is
    rendered on ``device`` (the forward kernel on a GPU).  Returns the
    init cloud's point count.

    The ground truth renders at a binning capacity measured over the views:
    the script renders at the shape-only default, which at 512 px drops
    ~16% of the entries of each view (the highest-index splats, i.e.
    buildings) from its ground truth."""
    rng = np.random.default_rng(seed)
    n = n_points
    pts, cols = satellite_city(rng, n)

    gt = create_from_points(pts, cols, capacity=-(-n // 1024) * 1024, init_opacity=0.9,
                            device=device)
    gt.aux.filter_3d.fill_(0.5)
    cams = orbit_cameras([0, 0, 0], 70.0, 600.0, num_cams=n_views, width=size,
                         height=size, fov_deg=45.0, uid_base=0, device=device)
    bg = torch.zeros(3, device=device)
    cap = measure_bin_capacity(gt, cams)

    for sub in ("masks", "depths_moge"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    frames = []
    focal = size / (2 * np.tan(np.radians(45.0) / 2))
    for i, cam in enumerate(cams):
        rendered = render(gt, cam, bg, inference=True, testing=True, bin_capacity=cap)
        img = np.clip(rendered.color.cpu().numpy(), 0, 1)
        alpha = rendered.alpha.cpu().numpy()
        depth = rendered.depth.cpu().numpy() / np.maximum(alpha, 1e-6)
        name = f"img_{i:03d}"
        write_png(os.path.join(out, name + ".png"), (img * 255).astype(np.uint8))
        np.save(os.path.join(out, "masks", name + ".npy"), (alpha > 0.5).astype(np.uint8))
        np.save(os.path.join(out, "depths_moge", name + ".npy"), depth.astype(np.float32))
        c2w = np.linalg.inv(cam.world_view.cpu().numpy().astype(np.float64))
        frames.append({
            "file_path": name + ".png",
            "transform_matrix_rotated": c2w.tolist(),
            "fl_x": focal, "fl_y": focal,
            "cx": size / 2, "cy": size / 2,
        })

    n_test = max(n_views // 8, 1)
    base = {"R": np.eye(3).tolist(), "T": [0.0, 0.0, 0.0]}
    with open(os.path.join(out, "transforms_train.json"), "w") as f:
        json.dump({**base, "frames": frames[n_test:]}, f)
    with open(os.path.join(out, "transforms_test.json"), "w") as f:
        json.dump({**base, "frames": frames[:n_test]}, f)

    # noisy sparse init cloud
    sub = rng.choice(n, n // 3, replace=False)
    noisy = pts[sub] + rng.normal(0, 1.0, (len(sub), 3)).astype(np.float32)
    write_points3d_text(os.path.join(out, "points3D.txt"), noisy, cols[sub] * 255)
    return len(sub)
