"""Geometric evaluation CLI: DSM altitude accuracy against lidar truth.

Port of ``skyfall_gs_tpu/cli/eval_geometry.py`` (reference
evaluate_gs_geometry.py:610-1008): render depth from a checkpoint over the
training or trajectory cameras (the forward kernel on the card), backproject
to a UTM point cloud using the scene's ENU origin, rasterize a DSM on the
GT ROI grid, register with DSMR (water-masked), and report
MAE/RMSE/completeness.  ``--device`` defaults to ``cuda``; there is no
fallback to the CPU.  Unlike the JAX package, a depth render that overflows
its binning capacity raises (splats would be missing from the DSM).

GT inputs per scene (DFC2019 layout):
    <gt_dir>/<AOI>_DSM.tif        lidar DSM
    <gt_dir>/<AOI>_DSM.txt        ROI metadata (xoff yoff size resolution)
    <gt_dir>/<AOI>_CLS[_v2].tif   classification raster (water == 9)
    <scene>/enu_observer_origin.json  [lat, lon, alt]

Usage:
    python -m skyfall_gs_tpu_torch.cli.eval_geometry --checkpoint out/chkpnt30000.npz \
        -s <scene> --gt_dir <DFC2019 truth dir> --aoi_id JAX_004 [--csv out.csv]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _read_raster(path: str) -> np.ndarray:
    """GeoTIFF band-1 read via cv2 (rasterio/GDAL are not required)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"could not read raster {path}")
    if img.ndim == 3:
        img = img[..., 0]
    return np.asarray(img, np.float64)


@torch.no_grad()
def evaluate_scene(checkpoint: str, source_path: str, gt_dir: str, aoi_id: str,
                   camera_path: str | None = None, out_dir: str | None = None,
                   device="cuda") -> dict:
    from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
    from skyfall_gs_tpu_torch.cli.train import resolve_device
    from skyfall_gs_tpu_torch.eval.geometry import (
        compute_dsm_metrics,
        depth_to_point_cloud,
        rasterize_dsm,
        read_roi_metadata,
        register_dsms,
    )
    from skyfall_gs_tpu_torch.io.scene import load_scene
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
    from skyfall_gs_tpu_torch.viz.paths import load_trajectory
    from skyfall_gs_tpu_torch.viz.video import recompute_filter_for_trajectory

    device = resolve_device(str(device))
    state, it = load_state_from_checkpoint(checkpoint, device=device)

    enu_origin = None
    origin_path = os.path.join(source_path, "enu_observer_origin.json")
    if os.path.exists(origin_path):
        with open(origin_path) as f:
            enu_origin = json.load(f)

    if camera_path:
        cams, _, _ = load_trajectory(camera_path, device=device)
        views = [(c, None) for c in cams]
    else:
        scene = load_scene(source_path, eval_split=False, shuffle=False, device=device)
        views = [(v.camera, v.mask) for v in scene.train_views]
    state = recompute_filter_for_trajectory(state, [c for c, _ in views])

    bg = torch.zeros(3, device=device)
    cap = measure_bin_capacity(state, [c for c, _ in views])

    clouds = []
    for cam, mask in views:
        out = render(state, cam, bg, testing=True, bin_capacity=cap, inference=True)
        if out.overflow is not None and int(out.overflow):
            raise RuntimeError(f"binning overflow: {int(out.overflow)} entries dropped from "
                               f"a depth render at capacity {cap}")
        # depth is already alpha-normalized; suppress near-empty pixels
        alpha = out.alpha.cpu().numpy()
        depth = np.where(alpha > 0.5, out.depth.cpu().numpy(), 0.0)
        w2c = cam.world_view.cpu().numpy()
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        clouds.append(depth_to_point_cloud(
            depth, R, T, float(cam.focal_x), float(cam.focal_y),
            float(cam.cx), float(cam.cy), mask=mask, enu_origin=enu_origin))
    cloud = np.concatenate([c for c in clouds if len(c)], axis=0)
    print(f"merged point cloud: {cloud.shape[0]} points")

    roi = read_roi_metadata(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"))
    gt_dsm = _read_raster(os.path.join(gt_dir, f"{aoi_id}_DSM.tif"))
    pred = rasterize_dsm(cloud, *roi)

    water_mask = None
    for suffix in ("_CLS_v2.tif", "_CLS.tif"):
        cls_path = os.path.join(gt_dir, aoi_id + suffix)
        if os.path.exists(cls_path):
            water_mask = _read_raster(cls_path) != 9
            break

    registered, shift = register_dsms(pred, gt_dsm, water_mask)
    metrics = compute_dsm_metrics(registered, gt_dsm, water_mask)
    metrics.update({"scene": aoi_id, "iteration": it, "cloud_points": int(cloud.shape[0]),
                    **{f"shift_{k}": v for k, v in shift.items()}})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{aoi_id}_dsm_pred.npy"), registered)
    return metrics


def main(argv=None) -> dict:
    """Evaluate one scene; returns its metrics."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--aoi_id", required=True, help="e.g. JAX_004")
    parser.add_argument("--camera_path", default=None)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--csv", default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    m = evaluate_scene(args.checkpoint, args.source_path, args.gt_dir, args.aoi_id,
                       args.camera_path, args.out_dir, device=args.device)
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in m.items()})
    if args.csv:
        from skyfall_gs_tpu_torch.eval.photometric import write_csv

        write_csv(args.csv, [m])
    return m


if __name__ == "__main__":
    main()
