"""Camera model: a dataclass of tensors plus host-side constructors.

Port of ``skyfall_gs_tpu/core/camera.py``.  The matrices are built in
numpy (float64, then float32) exactly as the JAX package builds them and
placed on ``device``; width and height are Python ints because they fix
the render's shapes.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.transforms import projection_matrix, world_to_view

FRUSTUM_CLAMP = 1.3  # EWA Jacobian focal clamp, in multiples of tan(fov/2)


@dataclass
class Camera:
    """A pinhole camera in column-vector convention (x_cam = W @ [x; 1])."""

    world_view: torch.Tensor  # (4, 4) world -> camera
    full_proj: torch.Tensor   # (4, 4) world -> clip (P @ W)
    cam_center: torch.Tensor  # (3,) camera position in world space
    tan_fovx: torch.Tensor    # () float32
    tan_fovy: torch.Tensor    # ()
    focal_x: torch.Tensor     # () pixels
    focal_y: torch.Tensor     # () pixels
    cx: torch.Tensor          # () normalized principal-point shift
    cy: torch.Tensor          # ()
    uid: int = 0              # appearance-embedding index
    znear: float = 0.01
    zfar: float = 100.0
    width: int = 0
    height: int = 0
    # The EWA Jacobian's clamp on x/z and y/z as (lo_x, hi_x, lo_y, hi_y);
    # None is FRUSTUM_CLAMP times this camera's own field of view.
    clamp_window: Optional[Tuple[float, float, float, float]] = None

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_camera(
    R: np.ndarray,
    T: np.ndarray,
    fov_x: float,
    fov_y: float,
    width: int,
    height: int,
    cx: float = 0.0,
    cy: float = 0.0,
    uid: int = 0,
    znear: float = 0.01,
    zfar: float = 100.0,
    device="cpu",
) -> Camera:
    """Build a Camera from COLMAP-style extrinsics.

    Args:
        R: (3, 3) camera-to-world rotation.
        T: (3,) world-to-camera translation.
        fov_x/fov_y: field of view in radians.
        cx/cy: normalized principal-point shift in NDC units.
    """
    w2c = world_to_view(R, T)
    full = (projection_matrix(znear, zfar, fov_x, fov_y, cx, cy) @ w2c).astype(np.float32)
    center = np.linalg.inv(w2c.astype(np.float64))[:3, 3].astype(np.float32)

    def scalar(v):
        return torch.tensor(np.float32(v), device=device)

    return Camera(
        world_view=torch.from_numpy(w2c).to(device),
        full_proj=torch.from_numpy(full).to(device),
        cam_center=torch.from_numpy(center).to(device),
        tan_fovx=scalar(math.tan(fov_x / 2.0)),
        tan_fovy=scalar(math.tan(fov_y / 2.0)),
        focal_x=scalar(width / (2.0 * math.tan(fov_x / 2.0))),
        focal_y=scalar(height / (2.0 * math.tan(fov_y / 2.0))),
        cx=scalar(cx),
        cy=scalar(cy),
        uid=int(uid),
        znear=znear,
        zfar=zfar,
        width=int(width),
        height=int(height),
    )


def camera_from_c2w(
    c2w: np.ndarray,
    fov_x: float,
    fov_y: float,
    width: int,
    height: int,
    **kwargs,
) -> Camera:
    """Build a Camera from a COLMAP-convention camera-to-world matrix."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    return make_camera(w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, width, height,
                       **kwargs)


def clamp_window(camera: Camera) -> tuple:
    """The EWA Jacobian's clamp window (lo_x, hi_x, lo_y, hi_y) on x/z and
    y/z: the camera's own ``clamp_window``, else FRUSTUM_CLAMP times its
    field of view about the principal point (tensors, no host sync)."""
    if camera.clamp_window is not None:
        return camera.clamp_window
    m = FRUSTUM_CLAMP
    return (camera.tan_fovx * (-m - camera.cx), camera.tan_fovx * (m - camera.cx),
            camera.tan_fovy * (-m - camera.cy), camera.tan_fovy * (m - camera.cy))


def band_camera(camera: Camera, band: int, num_bands: int) -> Camera:
    """An exact sub-camera for horizontal image band ``band`` of
    ``num_bands``: it renders rows [k*Hb, (k+1)*Hb) of the full image
    (the same world rays).  Focal lengths stay, the vertical FoV shrinks
    and the principal point shifts so that pixel (x, y) maps to global
    (x, y + k*Hb).  The band keeps the full frame's clamp window, so a
    splat centered outside the band projects as in the full frame (the JAX
    package's band clamps to the band's own FoV).  The height must divide
    into ``num_bands`` bands."""
    h = camera.height
    if h % num_bands != 0:
        raise ValueError(f"height {h} not divisible by {num_bands} bands")
    hb = h // num_bands
    dev = camera.world_view.device
    cy_new = ((float(camera.cy) + 1.0) * h - 2.0 * band * hb) / hb - 1.0
    tan_fovy_new = float(camera.tan_fovy) * hb / h
    fov_x = 2.0 * math.atan(float(camera.tan_fovx))
    w2c = camera.world_view.cpu().numpy().astype(np.float64)
    proj = projection_matrix(camera.znear, camera.zfar, fov_x, 2.0 * math.atan(tan_fovy_new),
                             float(camera.cx), cy_new)
    return dataclasses.replace(
        camera,
        world_view=torch.from_numpy(w2c.astype(np.float32)).to(dev),
        full_proj=torch.from_numpy((proj @ w2c).astype(np.float32)).to(dev),
        tan_fovy=torch.tensor(np.float32(tan_fovy_new), device=dev),
        cy=torch.tensor(np.float32(cy_new), device=dev),
        height=hb,
        clamp_window=tuple(float(v) for v in clamp_window(camera)))


def look_at_c2w(eye: Sequence[float], target: Sequence[float],
                up: Sequence[float] = (0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world matrix looking from ``eye`` at ``target``, built in
    OpenGL convention then flipped to COLMAP (+z forward, +y down)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    true_up = true_up / np.linalg.norm(true_up)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    c2w[:3, 1:3] *= -1.0  # OpenGL -> COLMAP
    return c2w


def orbit_cameras(
    target: Sequence[float],
    elevation_deg: float,
    radius: float,
    num_cams: int = 6,
    num_samples: int = 1,
    width: int = 512,
    height: int = 512,
    fov_deg: float = 60.0,
    uid_base: int = 1000,
    uids: Sequence[int] | None = None,
    device="cpu",
) -> List[Camera]:
    """A ring of ``num_cams`` azimuth-uniform cameras orbiting ``target`` at
    one elevation, each repeated ``num_samples`` times; view ``i`` gets
    ``uid = uid_base + i`` unless ``uids`` is given."""
    target = np.asarray(target, np.float64)
    fov = math.radians(fov_deg)
    phi = math.radians(elevation_deg)
    cams: List[Camera] = []
    flat = 0
    for i in range(num_cams):
        theta = 2.0 * math.pi * i / num_cams
        eye = target + radius * np.array(
            [math.cos(theta) * math.cos(phi),
             math.sin(theta) * math.cos(phi),
             math.sin(phi)]
        )
        c2w = look_at_c2w(eye, target)
        for _ in range(num_samples):
            uid = uids[flat] if uids is not None else uid_base + flat
            cams.append(camera_from_c2w(c2w, fov, fov, width, height,
                                        uid=int(uid), device=device))
            flat += 1
    return cams
