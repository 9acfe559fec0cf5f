"""Satellite geodesy utilities.

Port of ``skyfall_gs_tpu/eval/sat_utils.py``, which is numpy only, so this
is the same code.

Capability parity: reference sat_utils.py — RPC model rescaling (:39-57),
geodetic <-> ECEF conversions (:59-95), UTM conversion (:97-112, here via the
self-contained transverse-Mercator in eval/geometry.py), and the
DSM pointwise-difference pipeline (:114-219): crop the prediction to the GT
bounding box, apply the water mask, DSMR-register, and emit the error raster
plus MAE.

Geodesy formulas are the standard WGS84 closed forms.  No GDAL/rasterio/
pyproj dependencies: rasters are numpy arrays + the (xoff, yoff, size,
resolution) ROI metadata convention used throughout the DFC2019 tooling.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from skyfall_gs_tpu_torch.eval import dsmr
from skyfall_gs_tpu_torch.eval.geometry import latlon_to_utm

_A = 6378137.0
_FINV = 298.257223563
_E2 = 1.0 - (1.0 - 1.0 / _FINV) ** 2


@dataclass
class RPCModel:
    """Minimal rational-polynomial-camera scale/offset container.

    Holds the normalization parameters that image-space operations touch;
    the polynomial coefficients pass through untouched (they are defined on
    normalized coordinates and are resize-invariant).
    """

    row_scale: float
    row_offset: float
    col_scale: float
    col_offset: float
    lat_scale: float = 1.0
    lat_offset: float = 0.0
    lon_scale: float = 1.0
    lon_offset: float = 0.0
    alt_scale: float = 1.0
    alt_offset: float = 0.0
    coeffs: Optional[dict] = None


def rpc_scaling_params(v) -> Tuple[float, float]:
    """(scale, offset) normalizing a value range to [-1, 1]."""
    vec = np.asarray(v).ravel()
    scale = (vec.max() - vec.min()) / 2.0
    return float(scale), float(vec.min() + scale)


def rescale_rpc(rpc: RPCModel, alpha: float) -> RPCModel:
    """Scale an RPC model after an image resize by factor ``alpha``."""
    return replace(
        rpc,
        row_scale=rpc.row_scale * alpha,
        col_scale=rpc.col_scale * alpha,
        row_offset=rpc.row_offset * alpha,
        col_offset=rpc.col_offset * alpha,
    )


def latlon_to_ecef(lat, lon, alt):
    """Geodetic (deg, deg, m) -> geocentric ECEF (m)."""
    lat = np.radians(np.asarray(lat, np.float64))
    lon = np.radians(np.asarray(lon, np.float64))
    alt = np.asarray(alt, np.float64)
    v = _A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    x = (v + alt) * np.cos(lat) * np.cos(lon)
    y = (v + alt) * np.cos(lat) * np.sin(lon)
    z = (v * (1.0 - _E2) + alt) * np.sin(lat)
    return x, y, z


def ecef_to_latlon(x, y, z):
    """Geocentric ECEF (m) -> geodetic (deg, deg, m); Bowring's method."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    b = _A * np.sqrt(1.0 - _E2)
    ep2 = (_A ** 2 - b ** 2) / b ** 2
    p = np.sqrt(x ** 2 + y ** 2)
    th = np.arctan2(_A * z, b * p)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z + ep2 * b * np.sin(th) ** 3,
                     p - _E2 * _A * np.cos(th) ** 3)
    n = _A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.degrees(lat), np.degrees(lon), alt


def utm_from_latlon(lats, lons):
    """Vectorized lat/lon -> UTM easting/northing (zone of the first point)."""
    lats = np.atleast_1d(np.asarray(lats, np.float64))
    lons = np.atleast_1d(np.asarray(lons, np.float64))
    pairs = [latlon_to_utm(float(a), float(o)) for a, o in zip(lats, lons)]
    easts = np.array([p[0] for p in pairs])
    norths = np.array([p[1] for p in pairs])
    return easts, norths


def crop_to_roi(dsm: np.ndarray, dsm_origin: Tuple[float, float],
                dsm_resolution: float,
                roi: Tuple[float, float, int, float]) -> np.ndarray:
    """Crop a georeferenced DSM (origin = top-left easting/northing) to the
    (xoff, yoff, size, resolution) GT ROI grid (nearest-neighbor)."""
    xoff, yoff, size, res = roi
    top_northing = yoff + size * res
    e0, n0 = dsm_origin
    out = np.full((size, size), np.nan)
    cols = ((xoff + (np.arange(size) + 0.5) * res) - e0) / dsm_resolution
    rows = (n0 - (top_northing - (np.arange(size) + 0.5) * res)) / dsm_resolution
    ci = np.round(cols).astype(int)
    ri = np.round(rows).astype(int)
    ok_c = (ci >= 0) & (ci < dsm.shape[1])
    ok_r = (ri >= 0) & (ri < dsm.shape[0])
    rr, cc = np.meshgrid(ri[ok_r], ci[ok_c], indexing="ij")
    out[np.ix_(ok_r, ok_c)] = dsm[rr, cc]
    return out


def dsm_pointwise_diff(
    in_dsm: np.ndarray,
    gt_dsm: np.ndarray,
    water_mask: Optional[np.ndarray] = None,
    scaling: bool = False,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Register the predicted DSM on the GT and return the pointwise error.

    Returns:
        (registered_dsm, signed error raster, {'mae': ..., dx/dy/a/b}).
    """
    pred = in_dsm.astype(np.float64).copy()
    gt = gt_dsm.astype(np.float64).copy()
    if water_mask is not None:
        pred[~water_mask] = np.nan
        gt[~water_mask] = np.nan
    dx, dy, a, b = dsmr.compute_shift_arrays(gt, pred, scaling=scaling)
    registered = dsmr.apply_shift_arrays(pred, dx, dy, a, b)
    err = registered - gt
    mae = float(np.nanmean(np.abs(err)))
    return registered, err, {"mae": mae, "dx": dx, "dy": dy, "a": a, "b": b}
