"""Depth colorization (Spectral disparity colormap).

Port of ``skyfall_gs_tpu/viz/colormap.py``: disparity = 1/depth, percentile
[2, 98] normalization over the masked region, the 'Spectral' colormap.  The
colormap is built here in numpy (ColorBrewer's 11 Spectral colors,
linearly interpolated into a 256-entry table and indexed as matplotlib's
``LinearSegmentedColormap`` does), so the port needs no matplotlib.
"""

from __future__ import annotations

import numpy as np

_SPECTRAL = np.array([
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (230, 245, 152), (171, 221, 164), (102, 194, 165),
    (50, 136, 189), (94, 79, 162)], np.float64) / 255.0
_LUT_SIZE = 256


def _spectral_lut() -> np.ndarray:
    """(256, 3) table: the control colors at evenly spaced positions in
    [0, 1], linearly interpolated at ``linspace(0, 1, 256)``."""
    x = np.linspace(0.0, 1.0, len(_SPECTRAL))
    xi = np.linspace(0.0, 1.0, _LUT_SIZE)
    ind = np.searchsorted(x, xi)[1:-1]
    frac = ((xi[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1]))[:, None]
    inner = frac * (_SPECTRAL[ind] - _SPECTRAL[ind - 1]) + _SPECTRAL[ind - 1]
    return np.clip(np.concatenate([_SPECTRAL[:1], inner, _SPECTRAL[-1:]]), 0.0, 1.0)


def colorize_depth(depth: np.ndarray, mask: np.ndarray | None = None,
                   normalize: bool = True) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) float RGB in [0, 1]."""
    depth = np.asarray(depth, np.float64)
    disp = 1.0 / np.maximum(depth, 1e-8)
    valid = np.isfinite(disp)
    if mask is not None:
        valid &= np.asarray(mask) > 0
    if normalize and valid.any():
        lo, hi = np.percentile(disp[valid], [2, 98])
        disp = (disp - lo) / max(hi - lo, 1e-12)
    disp = np.clip(np.where(valid, disp, 0.0), 0.0, 1.0)
    idx = np.minimum((disp * _LUT_SIZE).astype(np.int64), _LUT_SIZE - 1)
    colored = _spectral_lut()[idx]
    if mask is not None:
        colored = colored * (np.asarray(mask) > 0)[..., None]
    return colored.astype(np.float32)
