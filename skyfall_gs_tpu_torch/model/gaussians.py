"""Gaussian scene state: padded dataclasses of tensors + Mip-Splatting filters.

Port of ``skyfall_gs_tpu/model/gaussians.py``.  State tensors have a fixed
**capacity** with an ``alive`` mask, as in the JAX package: shapes match
across the two packages, a state crosses between them through
``state_to_numpy`` / ``state_from_numpy``, and dead slots (opacity logit
-10, identity quaternions) render invisible and get exactly-zero grads.

Appearance-enabled states carry the per-Gaussian ``embeddings``, the
per-camera ``appearance_embeddings`` and the ``appearance_mlp`` dict of
tensors (model/appearance.py) as optional parameter fields; the helpers
below walk those nested fields like any other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.sh import rgb_to_sh
from skyfall_gs_tpu_torch.model.appearance import (
    AppearanceConfig,
    fourier_position_features,
    init_appearance,
)
from skyfall_gs_tpu_torch.ops.knn import mean_sq_dist_3nn_host
from skyfall_gs_tpu_torch.utils.general import inverse_sigmoid

_STATIC_FIELDS = ("active_sh_degree", "max_sh_degree", "spatial_lr_scale")


@dataclass
class GaussianParams:
    """Optimizable leaves.  Per-Gaussian tensors are padded to capacity C."""

    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log-scales
    rotation: torch.Tensor       # (C, 4) wxyz quaternions
    opacity: torch.Tensor        # (C, 1) logits
    embeddings: Optional[torch.Tensor] = None             # (C, 6F)
    appearance_embeddings: Optional[torch.Tensor] = None  # (M, D)
    appearance_mlp: Optional[dict] = None                 # l{0,1,2}/{w,b}

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)


@dataclass
class GaussianAux:
    """Non-optimized per-Gaussian state."""

    alive: torch.Tensor               # (C,) bool
    filter_3d: torch.Tensor           # (C,) Mip-Splatting 3D filter stddev
    max_radii2d: torch.Tensor         # (C,) float32
    grad_accum: torch.Tensor          # (C,) sum ||d mean2d||
    grad_accum_abs: torch.Tensor      # (C,) sum ||abs d mean2d||
    grad_accum_abs_max: torch.Tensor  # (C,) max ||abs d mean2d||
    denom: torch.Tensor               # (C,) visibility counts


@dataclass
class GaussianModelState:
    params: GaussianParams
    aux: GaussianAux
    active_sh_degree: int = 0
    max_sh_degree: int = 3
    appearance: AppearanceConfig = AppearanceConfig()
    spatial_lr_scale: float = 1.0

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.aux.alive)

    def one_up_sh_degree(self) -> None:
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1


def field_names(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def map_leaf(fn, v):
    """``fn`` applied to a leaf, to every leaf of a nested dict, or ``None``
    kept as ``None``."""
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: map_leaf(fn, x) for k, x in v.items()}
    return fn(v)


def map_fields(fn, obj):
    """A dataclass like ``obj`` with ``fn`` applied to every leaf (absent
    fields stay ``None``; nested dicts such as ``appearance_mlp`` are
    walked)."""
    return type(obj)(**{k: map_leaf(fn, getattr(obj, k)) for k in field_names(type(obj))})


def flat_fields(obj) -> list:
    """``(path, leaf)`` for every present leaf of a dataclass, with paths
    such as ``"xyz"`` or ``"appearance_mlp/l0/w"``, in a fixed order
    (fields in declaration order, dict keys sorted)."""
    out = []

    def walk(path, v):
        if v is None:
            return
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{path}/{k}", v[k])
        else:
            out.append((path, v))

    for k in field_names(type(obj)):
        walk(k, getattr(obj, k))
    return out


def from_flat(cls, pairs) -> Any:
    """Inverse of :func:`flat_fields`: a ``cls`` from ``(path, leaf)`` pairs
    (fields with no pair take their default)."""
    fields: dict = {}
    for path, v in pairs:
        *head, last = path.split("/")
        node = fields
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return cls(**fields)


# ----------------------------------------------------------------------------
# Activations (Mip-Splatting 3D filter variants)
# ----------------------------------------------------------------------------

def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity[:, 0])


def scaling_with_3d_filter(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """sqrt(s^2 + f^2): band-limit each Gaussian by its 3D filter."""
    s = get_scaling(params)
    return torch.sqrt(torch.square(s) + torch.square(filter_3d)[:, None])


def _safe_det_ratio_sqrt(det1: torch.Tensor, det2: torch.Tensor) -> torch.Tensor:
    """sqrt(det1 / det2) with a bounded gradient.

    det1 = prod(s^2) underflows to exactly 0 for tiny transient scales, and
    sqrt'(0) = inf turns a live cotangent into NaN parameters through Adam.
    Floor the argument at 1e-12 (gradient <= 5e5) and zero the forward
    below it: a coefficient < 1e-6 is far below visibility either way.
    """
    ratio = det1 / torch.clamp_min(det2, 1e-30)
    return torch.where(ratio > 1e-12, torch.sqrt(torch.clamp_min(ratio, 1e-12)),
                       torch.zeros_like(ratio))


def _filter_coef(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    s2 = torch.square(get_scaling(params))
    det1 = torch.prod(s2, dim=1)
    det2 = torch.prod(s2 + torch.square(filter_3d)[:, None], dim=1)
    return _safe_det_ratio_sqrt(det1, det2)


def opacity_with_3d_filter(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """Opacity compensated by sqrt(det(s^2) / det(s^2 + f^2))."""
    return get_opacity(params) * _filter_coef(params, filter_3d)


# ----------------------------------------------------------------------------
# 3D filter
# ----------------------------------------------------------------------------

@torch.no_grad()
def compute_3d_filter(
    xyz: torch.Tensor,
    alive: torch.Tensor,
    world_views: torch.Tensor,  # (M, 4, 4) world->camera
    focal_x: torch.Tensor,      # (M,)
    focal_y: torch.Tensor,      # (M,)
    cx_pix: torch.Tensor,       # (M,) principal point in pixels
    cy_pix: torch.Tensor,       # (M,)
    widths: torch.Tensor,       # (M,) float
    heights: torch.Tensor,      # (M,) float
    mesh=None,
) -> torch.Tensor:
    """Per-Gaussian 3D low-pass filter size (Mip-Splatting).

    filter = (min over covering cameras of camera-space z) / max focal *
    sqrt(0.2); points covered by no camera inherit the largest distance
    over covered live points (+-15% screen margin).  One camera at a time,
    so memory stays O(C) for any number of cameras; no host sync.  On a
    gaussian-sharded state (``mesh``) that largest distance is the
    shards' maximum.
    """
    distance = torch.full_like(xyz[:, 0], float("inf"))
    covered = torch.zeros_like(alive)
    for m in range(world_views.shape[0]):
        wv = world_views[m]
        t = xyz @ wv[:3, :3].T + wv[:3, 3]
        z = t[:, 2]
        zc = torch.clamp_min(z, 0.001)
        x = t[:, 0] / zc * focal_x[m] + cx_pix[m]
        y = t[:, 1] / zc * focal_y[m] + cy_pix[m]
        w, h = widths[m], heights[m]
        valid = ((z > 0.2) & (x >= -0.15 * w) & (x <= 1.15 * w)
                 & (y >= -0.15 * h) & (y <= 1.15 * h))
        distance = torch.minimum(distance, torch.where(valid, zc, float("inf")))
        covered |= valid
    max_dist = torch.max(torch.where(covered & alive, distance, float("-inf")))
    if mesh is not None:
        max_dist = mesh.all_reduce_(max_dist.reshape(1), "max")[0]
    max_dist = torch.where(torch.isfinite(max_dist), max_dist, 1.0)
    distance = torch.where(covered, distance, max_dist)
    return distance / torch.max(focal_x) * (0.2 ** 0.5)


def camera_filter_arrays(cameras) -> tuple:
    """Stack the per-camera scalars :func:`compute_3d_filter` needs."""
    dev = cameras[0].world_view.device
    wv = torch.stack([c.world_view for c in cameras])
    fx = torch.stack([c.focal_x for c in cameras])
    fy = torch.stack([c.focal_y for c in cameras])
    w = torch.tensor([float(c.width) for c in cameras], dtype=torch.float32, device=dev)
    h = torch.tensor([float(c.height) for c in cameras], dtype=torch.float32, device=dev)
    cx = torch.stack([c.cx for c in cameras]) / 2.0 * w + w / 2.0
    cy = torch.stack([c.cy for c in cameras]) / 2.0 * h + h / 2.0
    return wv, fx, fy, cx, cy, w, h


# ----------------------------------------------------------------------------
# Construction and exchange with the JAX package
# ----------------------------------------------------------------------------

def _round_capacity(n: int, multiple: int = 1024) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def create_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int = 3,
    appearance: AppearanceConfig = AppearanceConfig(),
    num_cameras: int = 0,
    spatial_lr_scale: float = 1.0,
    init_opacity: float = 0.5,
    capacity: Optional[int] = None,
    seed: int = 0,
    device="cpu",
) -> GaussianModelState:
    """Initialize the model from a colored point cloud: log-scale from the
    3-NN mean squared distance, identity rotations, opacity ``init_opacity``,
    DC features from RGB.  Dead padding slots get opacity logit -10 and
    identity quaternions so their activations stay finite.

    With appearance enabled, the Gaussian embeddings are Fourier position
    features plus N(0, 1e-4) jitter from ``np.random.default_rng(seed)``
    (the JAX package's draws), and the MLP and camera embeddings come from
    a ``torch.Generator`` seeded with ``seed``."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    n = points.shape[0]
    cap = capacity if capacity is not None else _round_capacity(int(n * 1.5))
    k = (max_sh_degree + 1) ** 2

    dist2 = np.maximum(mean_sq_dist_3nn_host(points), 1e-7)
    log_scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1).astype(np.float32)
    logit = inverse_sigmoid(init_opacity).item()

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.from_numpy(out).to(device)

    emb = mlp = cam_emb = None
    if appearance.enabled:
        feat = fourier_position_features(points, appearance.n_fourier_freqs)
        rng = np.random.default_rng(seed)
        emb = pad(feat + rng.normal(0, 1e-4, feat.shape).astype(np.float32))
        mlp, cam_emb = init_appearance(torch.Generator().manual_seed(seed), appearance,
                                       max(num_cameras, 1), device=device)

    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    rotation = pad(rotation)
    rotation[n:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(points),
        features_dc=pad(rgb_to_sh(colors).reshape(n, 1, 3)),
        features_rest=pad(np.zeros((n, k - 1, 3), np.float32)),
        scaling=pad(log_scales),
        rotation=rotation,
        opacity=pad(np.full((n, 1), logit, np.float32), fill=-10.0),
        embeddings=emb,
        appearance_embeddings=cam_emb,
        appearance_mlp=mlp,
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True

    def zeros():
        return torch.zeros(cap, dtype=torch.float32, device=device)

    aux = GaussianAux(alive=alive, filter_3d=zeros(), max_radii2d=zeros(),
                      grad_accum=zeros(), grad_accum_abs=zeros(),
                      grad_accum_abs_max=zeros(), denom=zeros())
    return GaussianModelState(params=params, aux=aux, active_sh_degree=0,
                              max_sh_degree=max_sh_degree, appearance=appearance,
                              spatial_lr_scale=float(spatial_lr_scale))


def state_from_numpy(d: dict, device="cpu") -> GaussianModelState:
    """Build a state from a dict of numpy arrays keyed by the JAX field names
    (GaussianParams and GaussianAux fields; ``appearance_mlp`` a nested dict
    ``l{0,1,2}/{w,b}``; absent appearance fields missing or ``None``), plus
    the optional static ``active_sh_degree`` / ``max_sh_degree`` /
    ``spatial_lr_scale`` and ``appearance`` (an AppearanceConfig tuple;
    without it, appearance is enabled exactly when the MLP is present and
    its sizes come from the arrays)."""

    def tensor(x):
        return torch.from_numpy(np.array(x)).to(device)

    params = GaussianParams(**{k: map_leaf(tensor, d.get(k))
                               for k in field_names(GaussianParams)})
    aux = GaussianAux(**{k: tensor(d[k]) for k in field_names(GaussianAux)})
    aux.alive = aux.alive.to(torch.bool)
    static = {k: type(getattr(GaussianModelState, k))(d[k])
              for k in _STATIC_FIELDS if k in d}
    if d.get("appearance") is not None:
        appearance = AppearanceConfig(*d["appearance"])
    elif params.appearance_mlp is not None:
        appearance = AppearanceConfig(
            enabled=True, n_fourier_freqs=params.embeddings.shape[1] // 6,
            embedding_dim=params.appearance_embeddings.shape[1],
            hidden=params.appearance_mlp["l0"]["w"].shape[1])
    else:
        appearance = AppearanceConfig()
    return GaussianModelState(params=params, aux=aux, appearance=appearance, **static)


def state_to_numpy(state: GaussianModelState) -> dict:
    """Inverse of :func:`state_from_numpy` (absent appearance fields map to
    ``None``).  The arrays are copies: later in-place updates of the state
    do not reach them."""
    out = {}
    for part in (state.params, state.aux):
        for k in field_names(type(part)):
            out[k] = map_leaf(lambda t: t.detach().to("cpu", copy=True).numpy(),
                              getattr(part, k))
    for k in _STATIC_FIELDS:
        out[k] = getattr(state, k)
    out["appearance"] = tuple(state.appearance)
    return out


# ----------------------------------------------------------------------------
# Opacity reset & radius prune
# ----------------------------------------------------------------------------

@torch.no_grad()
def reset_opacity(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """New opacity logits (C, 1): clamp the filtered opacity to <= 0.01,
    then undo the 3D-filter compensation."""
    new = torch.clamp_max(opacity_with_3d_filter(params, filter_3d), 0.01)
    new = new / torch.clamp_min(_filter_coef(params, filter_3d), 1e-12)
    new = torch.clamp(new, 1e-7, 1.0 - 1e-7)
    return inverse_sigmoid(new)[:, None]


@torch.no_grad()
def prune_by_radius(params: GaussianParams, radius: float) -> torch.Tensor:
    """Opacity logits with points farther than ``radius`` from the origin
    made invisible."""
    dist = torch.linalg.norm(params.xyz, dim=1)
    low = inverse_sigmoid(1e-8).to(params.opacity.device)
    return torch.where((dist > radius)[:, None], low, params.opacity)
