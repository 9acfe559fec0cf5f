"""Geometric evaluation: rendered depth -> point cloud -> DSM -> altitude MAE.

Port of ``skyfall_gs_tpu/eval/geometry.py``, which is numpy only, so this
is the same code.

Capability parity: reference evaluate_gs_geometry.py —
  * depth_to_point_cloud backprojection with the normalized principal point
    (cx_px = cx/2*W + W/2) and camera-to-world transform (:132-215);
  * ENU -> UTM via the observer origin (:72-116) — the lat/lon -> UTM
    conversion is implemented here directly (standard WGS84 transverse
    Mercator series) since the `utm` package is not available;
  * SatNeRF-style DSM rasterization on the GT ROI grid (xoff/yoff/xsize/
    resolution metadata txt, max-height per cell) (:218-312) — vectorized
    with np.maximum.at instead of plyflatten;
  * DSMR registration with water masking (CLS==9) (:378-526, 595-608);
  * MAE / RMSE / completeness metrics (:550-585).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from skyfall_gs_tpu_torch.eval import dsmr

# ----------------------------------------------------------------------------
# WGS84 lat/lon -> UTM (standard Krueger series, public geodesy math)
# ----------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _WGS84_F * (2.0 - _WGS84_F)
_EP2 = _E2 / (1.0 - _E2)


def latlon_to_utm(lat_deg: float, lon_deg: float) -> Tuple[float, float, int, str]:
    """Convert WGS84 lat/lon to UTM easting/northing (+ zone)."""
    lat = math.radians(lat_deg)
    zone = int((lon_deg + 180.0) // 6.0) + 1
    lon0 = math.radians((zone - 1) * 6.0 - 180.0 + 3.0)
    lon = math.radians(lon_deg)

    n = _WGS84_A / math.sqrt(1.0 - _E2 * math.sin(lat) ** 2)
    t = math.tan(lat) ** 2
    c = _EP2 * math.cos(lat) ** 2
    a = math.cos(lat) * (lon - lon0)

    e4, e6 = _E2 ** 2, _E2 ** 3
    m = _WGS84_A * (
        (1 - _E2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat
        - (3 * _E2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * math.sin(2 * lat)
        + (15 * e4 / 256 + 45 * e6 / 1024) * math.sin(4 * lat)
        - (35 * e6 / 3072) * math.sin(6 * lat)
    )
    easting = _K0 * n * (
        a + (1 - t + c) * a ** 3 / 6
        + (5 - 18 * t + t ** 2 + 72 * c - 58 * _EP2) * a ** 5 / 120
    ) + 500000.0
    northing = _K0 * (
        m + n * math.tan(lat) * (
            a ** 2 / 2 + (5 - t + 9 * c + 4 * c ** 2) * a ** 4 / 24
            + (61 - 58 * t + t ** 2 + 600 * c - 330 * _EP2) * a ** 6 / 720
        )
    )
    if lat_deg < 0:
        northing += 10000000.0
    letters = "CDEFGHJKLMNPQRSTUVWXX"
    letter = letters[int((lat_deg + 80) // 8)] if -80 <= lat_deg <= 84 else "Z"
    return easting, northing, zone, letter


def enu_to_utm(points_enu: np.ndarray, enu_origin: Sequence[float]) -> np.ndarray:
    """Shift ENU points by the UTM coordinates of the ENU observer origin."""
    if points_enu.shape[0] == 0:
        return points_enu
    lat, lon, alt = enu_origin
    ox, oy, _, _ = latlon_to_utm(lat, lon)
    out = np.empty_like(points_enu)
    out[:, 0] = ox + points_enu[:, 0]
    out[:, 1] = oy + points_enu[:, 1]
    out[:, 2] = alt + points_enu[:, 2]
    return out


# ----------------------------------------------------------------------------
# Backprojection
# ----------------------------------------------------------------------------

def depth_to_point_cloud(
    depth: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
    focal_x: float,
    focal_y: float,
    cx_norm: float = 0.0,
    cy_norm: float = 0.0,
    mask: Optional[np.ndarray] = None,
    enu_origin: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Backproject a rendered depth map to a world-space point cloud.

    Args:
        depth: (H, W) metric view-space depth (alpha-normalized).
        R: (3, 3) camera-to-world rotation (transposed w2c, loader convention).
        T: (3,) world-to-camera translation.
        cx_norm/cy_norm: normalized principal-point shift.
        enu_origin: optional [lat, lon, alt] to output UTM coordinates.
    """
    depth = np.nan_to_num(np.asarray(depth, np.float64), nan=0.0,
                          posinf=0.0, neginf=0.0)
    if mask is not None:
        depth = depth * np.asarray(mask)
    h, w = depth.shape
    valid = depth > 0
    if not valid.any():
        return np.empty((0, 3))
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    cx = cx_norm / 2.0 * w + w / 2.0
    cy = cy_norm / 2.0 * h + h / 2.0
    z = depth[valid]
    x = (u[valid] - cx) * z / focal_x
    y = (v[valid] - cy) * z / focal_y
    pts_cam = np.stack([x, y, z], axis=-1)
    r_w2c = R.T
    cam_center = -R @ T  # -R_w2c^T @ T
    pts_world = pts_cam @ r_w2c + cam_center
    if enu_origin is not None:
        pts_world = enu_to_utm(pts_world, enu_origin)
    return pts_world


# ----------------------------------------------------------------------------
# DSM rasterization & metrics
# ----------------------------------------------------------------------------

def read_roi_metadata(path: str) -> Tuple[float, float, int, float]:
    """SatNeRF ROI txt: xoff, yoff, size, resolution."""
    vals = np.loadtxt(path)
    return float(vals[0]), float(vals[1]), int(vals[2]), float(vals[3])


def rasterize_dsm(
    points: np.ndarray,
    xoff: float,
    yoff: float,
    size: int,
    resolution: float,
) -> np.ndarray:
    """Max-height rasterization on the GT ROI grid (SatNeRF convention:
    yoff is pre-shifted by size*resolution; rows run north->south)."""
    yoff = yoff + size * resolution
    dsm = np.full((size, size), -np.inf)
    if points.shape[0]:
        gx = ((points[:, 0] - xoff) / resolution).astype(int)
        gy = ((yoff - points[:, 1]) / resolution).astype(int)
        ok = (gx >= 0) & (gx < size) & (gy >= 0) & (gy < size)
        np.maximum.at(dsm, (gy[ok], gx[ok]), points[ok, 2])
    dsm[~np.isfinite(dsm)] = np.nan
    return dsm


def register_dsms(pred: np.ndarray, gt: np.ndarray,
                  water_mask: Optional[np.ndarray] = None,
                  scaling: bool = False) -> Tuple[np.ndarray, dict]:
    """DSMR-register the predicted DSM onto the ground truth.

    water_mask: boolean, True = keep (non-water), parity with CLS != 9.
    """
    gt_m = gt.astype(np.float64).copy()
    pred_m = pred.astype(np.float64).copy()
    if water_mask is not None:
        gt_m[~water_mask] = np.nan
        pred_m[~water_mask] = np.nan
    dx, dy, a, b = dsmr.compute_shift_arrays(gt_m, pred_m, scaling=scaling)
    registered = dsmr.apply_shift_arrays(pred_m, dx, dy, a, b)
    return registered, {"dx": dx, "dy": dy, "a": a, "b": b}


def compute_dsm_metrics(pred: np.ndarray, gt: np.ndarray,
                        mask: Optional[np.ndarray] = None) -> Dict[str, float]:
    """MAE / RMSE / completeness (reference :550-585)."""
    pred = pred.astype(np.float64).copy()
    gt = gt.astype(np.float64).copy()
    if mask is not None:
        pred[~mask] = np.nan
        gt[~mask] = np.nan
    valid_gt = ~np.isnan(gt)
    both = ~np.isnan(pred) & valid_gt
    if both.sum() == 0:
        return {"mae": float("nan"), "rmse": float("nan"),
                "valid_pixels": 0, "completeness": 0.0}
    diff = pred[both] - gt[both]
    return {
        "mae": float(np.mean(np.abs(diff))),
        "rmse": float(np.sqrt(np.mean(diff ** 2))),
        "valid_pixels": int(both.sum()),
        "completeness": float(both.sum() / valid_gt.sum()),
    }


def evaluate_depth_views(
    views,                     # iterable of (depth, R, T, fx, fy, cx, cy, mask)
    gt_dsm: np.ndarray,
    roi: Tuple[float, float, int, float],
    enu_origin: Optional[Sequence[float]] = None,
    water_mask: Optional[np.ndarray] = None,
    scaling: bool = False,
) -> Dict[str, float]:
    """Full pipeline: merge per-view clouds, rasterize, register, score."""
    clouds = [depth_to_point_cloud(*v, enu_origin=enu_origin) for v in views]
    cloud = np.concatenate([c for c in clouds if len(c)], axis=0) \
        if any(len(c) for c in clouds) else np.empty((0, 3))
    pred = rasterize_dsm(cloud, *roi)
    registered, shift = register_dsms(pred, gt_dsm, water_mask, scaling)
    metrics = compute_dsm_metrics(registered, gt_dsm, water_mask)
    metrics.update({f"shift_{k}": v for k, v in shift.items()})
    return metrics
