"""COLMAP sparse-reconstruction parsers (binary and text).

Port of ``skyfall_gs_tpu/io/colmap.py``, which is numpy only, so this is
the same code: cameras, images and points3D in the public COLMAP binary
and text formats, ``qvec_to_rotmat`` / ``rotmat_to_qvec`` and
``write_points3d_text``.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: (mid, n) for mid, (name, n) in _MODELS.items()}


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = R.flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(k)
    qvec = eigvecs[np.array([3, 0, 1, 2]), np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = _MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array(el[4:], dtype=np.float64),
            )
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 64, "idddddddi")
            iid = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            cam_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n2d,) = _read(f, 8, "Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3D_id)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode("utf-8"))
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for meta in lines[0::2]:
        el = meta.split()
        iid = int(el[0])
        images[iid] = ColmapImage(
            iid,
            np.array(el[1:5], dtype=np.float64),
            np.array(el[5:8], dtype=np.float64),
            int(el[8]),
            el[9],
        )
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            vals = _read(f, 43, "QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            rows.append([float(v) for v in el[1:8]])
    arr = np.array(rows, dtype=np.float64).reshape(-1, 7)
    return arr[:, 0:3], arr[:, 3:6], arr[:, 6]


def write_points3d_text(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a minimal points3D.txt (no tracks) — used by tests/tools."""
    with open(path, "w") as f:
        f.write("# 3D point list\n")
        for i in range(xyz.shape[0]):
            x, y, z = xyz[i]
            r, g, b = rgb[i].astype(int)
            f.write(f"{i + 1} {x} {y} {z} {r} {g} {b} 0.0\n")
