"""Camera poses of the benchmark's cells.

Frozen copies, at commit a752ef2, of ``skyfall_gs_tpu_torch/core/camera.py``
``look_at_c2w`` / ``orbit_cameras`` (the training views' ring, COLMAP
convention) and of ``skyfall_gs_tpu_torch/viz/paths.py`` ``gen_orbit_path``
(the viewer's clockwise orbit in OpenGL convention) with the trajectory
format that ``parse_trajectory_json`` reads (vertical field of view in
degrees, as three.js writes it).
"""

from __future__ import annotations

import math

import numpy as np


def look_at_c2w(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """COLMAP-convention (+z forward, +y down) camera-to-world pose."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    true_up /= np.linalg.norm(true_up)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, eye
    c2w[:3, 1:3] *= -1.0
    return c2w


def orbit_ring(target, elevation_deg: float, radius: float, n: int) -> list:
    """``n`` azimuth-uniform COLMAP poses around ``target`` at one elevation."""
    phi = math.radians(elevation_deg)
    target = np.asarray(target, np.float64)
    out = []
    for i in range(n):
        th = 2.0 * math.pi * i / n
        eye = target + radius * np.array([math.cos(th) * math.cos(phi),
                                          math.sin(th) * math.cos(phi), math.sin(phi)])
        out.append(look_at_c2w(eye, target))
    return out


def gen_orbit_path(target, elevation_deg: float, radius: float, num_frames: int) -> list:
    """Clockwise orbit, OpenGL-convention camera-to-world matrices."""
    target = np.asarray(target, np.float64)
    phi = math.radians(elevation_deg)
    out = []
    for i in range(num_frames):
        th = -2.0 * math.pi * i / num_frames
        eye = target + radius * np.array([math.cos(th) * math.cos(phi),
                                          math.sin(th) * math.cos(phi), math.sin(phi)])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (right, np.cross(right, fwd),
                                                          -fwd, eye)
        out.append(c2w)
    return out


def trajectory(rings: list, width: int, height: int, fov_deg: float) -> dict:
    """A viewer trajectory in the nerfstudio-style JSON layout: one orbit per
    ``(elevation_deg, radius, frames)`` ring around the origin, concatenated."""
    frames = []
    for ele, rad, n in rings:
        frames += [{"camera_to_world": c2w.flatten().tolist(), "fov": fov_deg, "aspect": 1}
                   for c2w in gen_orbit_path((0.0, 0.0, 0.0), ele, rad, n)]
    return {"camera_type": "perspective", "render_height": height, "render_width": width,
            "fps": 24, "_radius": rings[0][1], "camera_path": frames}


def trajectory_poses(path: dict) -> list:
    """``(COLMAP c2w, fov_x, fov_y)`` per frame of a trajectory: the OpenGL
    pose's y and z axes flipped; the field of view is vertical."""
    h, w = path["render_height"], path["render_width"]
    out = []
    for fr in path["camera_path"]:
        c2w = np.array(fr["camera_to_world"], np.float64).reshape(4, 4)
        c2w[:3, 1:3] *= -1.0
        focal = (h / 2.0) / math.tan(math.radians(fr["fov"]) / 2.0)
        out.append((c2w, 2.0 * math.atan(w / (2.0 * focal)), 2.0 * math.atan(h / (2.0 * focal))))
    return out
