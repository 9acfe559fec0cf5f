"""Depth-map reading and writing (.npy, or .exr through OpenCV).

Port of ``skyfall_gs_tpu/io/exr.py``.  ``.npy`` depths are read with numpy;
``.exr`` needs OpenCV built with OpenEXR support, and raises an
``ImportError`` naming it where ``cv2`` is missing.
"""

from __future__ import annotations

import os

import numpy as np

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing .exr depth maps needs OpenCV (cv2), "
                          "which is not installed; store depths as .npy") from e
    return cv2


def read_depth(path: str) -> np.ndarray:
    """Read a single-channel float depth map from .exr or .npy."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    if img is None:
        raise IOError(f"could not read depth file: {path}")
    if img.ndim == 3:
        img = img[..., 0]
    return np.asarray(img, np.float32)


def write_depth_exr(path: str, depth: np.ndarray) -> None:
    ok = _cv2().imwrite(path, np.asarray(depth, np.float32))
    if not ok:
        raise IOError(f"could not write depth file: {path}")
