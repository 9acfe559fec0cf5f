"""DSM registration: multiscale NaN-aware normalized cross correlation.

Port of ``skyfall_gs_tpu/eval/dsmr.py``, which is numpy only, so this is
the same code.

Capability parity: reference dsmr.py (numba): downsample2x:16-46,
ncc/compute_ncc/recursive_ncc:91-135, compute_shift -> (dx, dy, a, b)
affine z-map:163-190, apply_shift:193-215.  Re-written as vectorized numpy
(no numba in this image, and the arrays are small enough that vectorized
shift-and-reduce beats a JIT'd scalar loop).

Convention note: a shift (dx, dy) means "compare u[j, i] against
v[j + dy, i + dx]" — identical to the reference's valnan indexing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def downsample2x(u: np.ndarray) -> np.ndarray:
    """NaN-aware 2x mean downsampling of (C, H, W)."""
    c, h, w = u.shape
    hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
    pad = np.full((c, hp, wp), np.nan, u.dtype)
    pad[:, :h, :w] = u
    blocks = pad.reshape(c, hp // 2, 2, wp // 2, 2)
    with np.errstate(invalid="ignore"):
        return np.nanmean(blocks, axis=(2, 4))


def _shifted(v: np.ndarray, dx: int, dy: int, shape: Tuple[int, int]) -> np.ndarray:
    """v sampled at (j + dy, i + dx) over a (H, W) grid, NaN outside."""
    h, w = shape
    out = np.full((h, w), np.nan, np.float64)
    src_y0, src_y1 = max(dy, 0), min(v.shape[-2], h + dy)
    src_x0, src_x1 = max(dx, 0), min(v.shape[-1], w + dx)
    if src_y1 <= src_y0 or src_x1 <= src_x0:
        return out
    out[src_y0 - dy:src_y1 - dy, src_x0 - dx:src_x1 - dx] = \
        v[src_y0:src_y1, src_x0:src_x1]
    return out


def mean_std(u: np.ndarray, v: np.ndarray, dx: int = 0, dy: int = 0):
    """Joint masked statistics of u and v shifted by (dx, dy)."""
    u2 = u[0] if u.ndim == 3 else u
    v2 = v[0] if v.ndim == 3 else v
    vs = _shifted(v2, dx, dy, u2.shape)
    m = np.isfinite(u2) & np.isfinite(vs)
    count = m.sum()
    if count == 0:
        return np.nan, np.nan, np.nan, np.nan, np.nan
    uu, vv = u2[m], vs[m]
    muu, muv = uu.mean(), vv.mean()
    du, dv = uu - muu, vv - muv
    sigu = np.sqrt(np.mean(du * du))
    sigv = np.sqrt(np.mean(dv * dv))
    xcorr = np.mean(du * dv)
    return muu, muv, sigu, sigv, xcorr


def ncc(u, v, dx=0, dy=0) -> float:
    muu, muv, sigu, sigv, xcorr = mean_std(u, v, dx, dy)
    denom = sigu * sigv
    # Degenerate flat patches (zero variance) carry no alignment signal:
    # return -inf so compute_ncc never selects them, instead of warning on
    # a 0/0 division.
    if not np.isfinite(denom) or denom == 0.0:
        return -np.inf
    return xcorr / denom


def compute_ncc(u, v, irange: int, initdx: int, initdy: int):
    best = (-np.inf, initdx, initdy)
    for y in range(initdy - irange, initdy + irange + 1):
        for x in range(initdx - irange, initdx + irange + 1):
            corr = ncc(u, v, x, y)
            if np.isfinite(corr) and corr > best[0]:
                best = (corr, x, y)
    return best[1], best[2]


def recursive_ncc(u, v, irange: int = 5, dx: int = 0, dy: int = 0):
    """Coarse-to-fine NCC displacement search."""
    u2 = u[0] if u.ndim == 3 else u
    if min(u2.shape) > 100:
        su = downsample2x(u if u.ndim == 3 else u[None])
        sv = downsample2x(v if v.ndim == 3 else v[None])
        dx, dy = recursive_ncc(su, sv, irange, dx // 2, dy // 2)
        dx, dy = dx * 2, dy * 2
    return compute_ncc(u, v, irange, dx, dy)


def compute_shift_arrays(u: np.ndarray, v: np.ndarray, scaling: bool = True):
    """Registration coefficients (dx, dy, a, b) so that
    ``a * v[j+dy, i+dx] + b`` best matches ``u[j, i]``."""
    if u.ndim == 2:
        u = u[None]
    if v.ndim == 2:
        v = v[None]
    dx, dy = recursive_ncc(u, v)
    muu, muv, sigu, sigv, _ = mean_std(u, v, dx, dy)
    a = sigu / sigv if (scaling and np.isfinite(sigv) and sigv > 0) else 1.0
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift_arrays(v: np.ndarray, dx=0, dy=0, a=1.0, b=0.0) -> np.ndarray:
    """Apply registration coefficients to a (H, W) or (C, H, W) DSM."""
    squeeze = v.ndim == 2
    if squeeze:
        v = v[None]
    out = np.stack([
        a * _shifted(v[c], dx, dy, v.shape[1:]) + b for c in range(v.shape[0])
    ])
    return out[0] if squeeze else out
