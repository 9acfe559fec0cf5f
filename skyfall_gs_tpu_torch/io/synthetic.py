"""In-memory synthetic scenes for smoke tests and the quality gate.

Port of ``skyfall_gs_tpu/io/synthetic.py``: ground-truth Gaussians render
the "captures", and training must recover them from a corrupted
initialization.  The numpy draws are the JAX package's, in the same order,
so the scene geometry, colors and initial point cloud are identical; the
ground truth is rendered by the port's rasterizer on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import orbit_cameras
from skyfall_gs_tpu_torch.io.scene import SceneData, View
from skyfall_gs_tpu_torch.model.gaussians import create_from_points
from skyfall_gs_tpu_torch.model.render import render


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
