"""Camera trajectories: nerfstudio-style JSON paths + orbit generation.

Port of ``skyfall_gs_tpu/viz/paths.py`` (host-side numpy): clockwise orbit
paths in OpenGL convention, the Google-Earth-Studio altitude conversion,
the trajectory JSON schema, and the parser with the three.js vertical
fov -> focal conversion and the OpenGL -> COLMAP flip.  Parsed cameras are
placed on ``device``.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from skyfall_gs_tpu_torch.core.camera import Camera, camera_from_c2w
from skyfall_gs_tpu_torch.core.transforms import focal_to_fov


def _look_at_opengl(eye: np.ndarray, target: np.ndarray,
                    up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def gen_orbit_path(target: Sequence[float], elevation_deg: float,
                   radius: float, num_frames: int) -> List[np.ndarray]:
    """Clockwise orbit c2w matrices in OpenGL convention (the on-disk path
    format; the parser flips to COLMAP)."""
    target = np.asarray(target, np.float64)
    phi = math.radians(elevation_deg)
    c2ws = []
    for i in range(num_frames):
        theta = -2.0 * math.pi * i / num_frames
        eye = target + radius * np.array([
            math.cos(theta) * math.cos(phi),
            math.sin(theta) * math.cos(phi),
            math.sin(phi),
        ])
        c2ws.append(_look_at_opengl(eye, target))
    return c2ws


def ges_to_orbit(radius_ground: float, alt_target: float,
                 alt_camera: float) -> Tuple[float, float]:
    """Google-Earth-Studio altitudes -> (elevation_deg, slant radius)."""
    alt_delta = alt_camera - alt_target
    elevation = math.degrees(math.atan2(alt_delta, radius_ground))
    radius = math.sqrt(radius_ground ** 2 + alt_delta ** 2)
    return elevation, radius


def save_orbit_path(path: str, target: Sequence[float], elevation_deg: float,
                    radius: float, num_frames: int = 240, fov_deg: float = 60.0,
                    width: int = 512, height: int = 512, fps: int = 24) -> str:
    """Write the nerfstudio-style trajectory JSON (reference schema)."""
    out = {
        "_target": list(target),
        "_radius": radius,
        "_elevation": elevation_deg,
        "camera_type": "perspective",
        "render_height": height,
        "render_width": width,
        "fps": fps,
        "camera_path": [
            {"camera_to_world": c2w.flatten().tolist(),
             "fov": fov_deg, "aspect": 1}
            for c2w in gen_orbit_path(target, elevation_deg, radius, num_frames)
        ],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=4)
    return path


def parse_trajectory_json(camera_path: dict, device="cpu") -> Tuple[List[Camera], float]:
    """Trajectory JSON -> Camera list (+ the orbit radius for 3D-filter
    recomputation)."""
    height = camera_path["render_height"]
    width = camera_path["render_width"]
    radius = camera_path.get("_radius", 1.0)
    cams: List[Camera] = []
    for idx, frame in enumerate(camera_path["camera_path"]):
        c2w = np.array(frame["camera_to_world"], np.float64).reshape(4, 4)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
        fov = frame["fov"]
        # three.js: fov is vertical, in degrees
        focal = (height / 2.0) / math.tan(math.radians(fov) / 2.0)
        fov_x = focal_to_fov(focal, width)
        fov_y = focal_to_fov(focal, height)
        cams.append(camera_from_c2w(c2w, fov_x, fov_y, width, height, uid=idx,
                                    device=device))
    return cams, float(radius)


def load_trajectory(path: str, device="cpu") -> Tuple[List[Camera], float, int]:
    with open(path) as f:
        data = json.load(f)
    cams, radius = parse_trajectory_json(data, device=device)
    return cams, radius, int(data.get("fps", 24))
