"""Rigid/projective transforms and Gaussian covariance construction.

Port of ``skyfall_gs_tpu/core/transforms.py``.  Column-vector convention
(``x_cam = W @ [x; 1]``); the host-side matrix builders stay numpy, the
per-Gaussian functions work on tensors with leading batch dims.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Convert (possibly unnormalized) quaternions (..., 4) wxyz to rotation
    matrices (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_scaling_rotation(scaling: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): the Cholesky-like factor of the 3D covariance."""
    return quat_to_rotmat(rotation) * scaling[..., None, :]


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Full 3D covariance Σ = L Lᵀ, (..., 3, 3) symmetric PSD."""
    l = build_scaling_rotation(scaling_modifier * scaling, rotation)
    return l @ l.transpose(-1, -2)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None, scale: float = 1.0) -> np.ndarray:
    """Build the 4x4 world→camera matrix (column-vector convention).

    Args:
        R: (3, 3) the **camera-to-world rotation** (the transpose of the
           world-to-camera rotation), as COLMAP-style loaders hand it back.
        t: (3,) world-to-camera translation.
        translate/scale: optional recentering applied to the camera center.
    """
    Rt = np.eye(4, dtype=np.float64)
    Rt[:3, :3] = np.asarray(R, np.float64).T
    Rt[:3, 3] = np.asarray(t, np.float64).reshape(3)
    if translate is not None or scale != 1.0:
        tr = np.zeros(3) if translate is None else np.asarray(translate, np.float64)
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + tr) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float,
                      cx: float = 0.0, cy: float = 0.0) -> np.ndarray:
    """Perspective projection (column-vector convention) with a normalized
    principal-point shift ``cx``/``cy`` in NDC units."""
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / math.tan(fov_x / 2.0)
    p[1, 1] = 1.0 / math.tan(fov_y / 2.0)
    p[0, 2] = cx
    p[1, 2] = cy
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))
