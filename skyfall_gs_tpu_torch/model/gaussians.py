"""Gaussian scene state: padded dataclasses of tensors + Mip-Splatting filters.

Port of ``skyfall_gs_tpu/model/gaussians.py``.  State tensors have a fixed
**capacity** with an ``alive`` mask, as in the JAX package: shapes match
across the two packages, a state crosses between them through
``state_to_numpy`` / ``state_from_numpy``, and dead slots (opacity logit
-10, identity quaternions) render invisible and get exactly-zero grads.

Appearance modeling is not ported yet: appearance-enabled states raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.sh import rgb_to_sh
from skyfall_gs_tpu_torch.ops.knn import mean_sq_dist_3nn_host
from skyfall_gs_tpu_torch.utils.general import inverse_sigmoid

_APPEARANCE_FIELDS = ("embeddings", "appearance_embeddings", "appearance_mlp")
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
    spatial_lr_scale: float = 1.0

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.aux.alive)


def field_names(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def map_fields(fn, obj):
    """A dataclass like ``obj`` with ``fn`` applied to every field."""
    return type(obj)(**{k: fn(getattr(obj, k)) for k in field_names(type(obj))})


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


def opacity_with_3d_filter(params: GaussianParams, filter_3d: torch.Tensor) -> torch.Tensor:
    """Opacity compensated by sqrt(det(s^2) / det(s^2 + f^2))."""
    s2 = torch.square(get_scaling(params))
    det1 = torch.prod(s2, dim=1)
    det2 = torch.prod(s2 + torch.square(filter_3d)[:, None], dim=1)
    return get_opacity(params) * _safe_det_ratio_sqrt(det1, det2)


# ----------------------------------------------------------------------------
# Construction and exchange with the JAX package
# ----------------------------------------------------------------------------

def _round_capacity(n: int, multiple: int = 1024) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def create_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    max_sh_degree: int = 3,
    spatial_lr_scale: float = 1.0,
    init_opacity: float = 0.5,
    capacity: Optional[int] = None,
    device="cpu",
) -> GaussianModelState:
    """Initialize the model from a colored point cloud: log-scale from the
    3-NN mean squared distance, identity rotations, opacity ``init_opacity``,
    DC features from RGB.  Dead padding slots get opacity logit -10 and
    identity quaternions so their activations stay finite."""
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
    )
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True

    def zeros():
        return torch.zeros(cap, dtype=torch.float32, device=device)

    aux = GaussianAux(alive=alive, filter_3d=zeros(), max_radii2d=zeros(),
                      grad_accum=zeros(), grad_accum_abs=zeros(),
                      grad_accum_abs_max=zeros(), denom=zeros())
    return GaussianModelState(params=params, aux=aux, active_sh_degree=0,
                              max_sh_degree=max_sh_degree,
                              spatial_lr_scale=float(spatial_lr_scale))


def state_from_numpy(d: dict, device="cpu") -> GaussianModelState:
    """Build a state from a dict of numpy arrays keyed by the JAX field names
    (GaussianParams and GaussianAux fields, plus the optional static
    ``active_sh_degree`` / ``max_sh_degree`` / ``spatial_lr_scale``)."""
    if any(d.get(k) is not None for k in _APPEARANCE_FIELDS):
        raise NotImplementedError("appearance-enabled states are not ported yet")

    def tensor(k):
        return torch.from_numpy(np.array(d[k])).to(device)

    params = GaussianParams(**{k: tensor(k) for k in field_names(GaussianParams)})
    aux = GaussianAux(**{k: tensor(k) for k in field_names(GaussianAux)})
    aux.alive = aux.alive.to(torch.bool)
    static = {k: type(getattr(GaussianModelState, k))(d[k])
              for k in _STATIC_FIELDS if k in d}
    return GaussianModelState(params=params, aux=aux, **static)


def state_to_numpy(state: GaussianModelState) -> dict:
    """Inverse of :func:`state_from_numpy`."""
    out = {}
    for part in (state.params, state.aux):
        for k in field_names(type(part)):
            out[k] = getattr(part, k).detach().cpu().numpy()
    for k in _STATIC_FIELDS:
        out[k] = getattr(state, k)
    return out
