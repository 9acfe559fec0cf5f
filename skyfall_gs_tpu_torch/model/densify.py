"""Adaptive density control as shape-preserving masked writes.

Port of ``skyfall_gs_tpu/model/densify.py``:

  * the AbsGS dynamic threshold Q = quantile(grads_abs, 1 - ratio), where
    ratio is the fraction of live points whose signed screen gradient
    reaches ``max_grad``; with no accumulated statistics Q is +inf
    (abs-based selection off) instead of 0 (everything selected);
  * clone for small Gaussians, split (2 children drawn from the parent
    Gaussian, scale / 1.6) for large ones;
  * prune by opacity < ``min_opacity`` or world-space scale > 0.1 * extent,
    with the split children's predicate evaluated at child scale.  The
    screen-radius prune reads an all-zero ``max_radii2d`` (the reference
    resets it before the prune reads it) and so never fires; it is kept;
  * all densification statistics reset to zero afterwards.

Capacity is fixed: children are written into dead slots (dead slots in
index order, clones first, then split pairs), children that find no free
slot are dropped and counted in ``n_dropped``, Adam moments are zeroed at
every written slot, and children inherit the parent's ``filter_3d`` until
the next recompute.  The pass updates the state IN PLACE and makes no host
sync; the caller grows capacity host-side (:func:`grow_capacity`, which
allocates new tensors) when free space runs low.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from skyfall_gs_tpu_torch.core.transforms import quat_to_rotmat
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianAux,
    GaussianParams,
    get_opacity,
    get_scaling,
    map_fields,
)
from skyfall_gs_tpu_torch.model.optim import AdamState

_PER_GAUSSIAN_FIELDS = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
    "embeddings",
)


class DensifyStats(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor   # children lost to capacity overflow
    n_alive: torch.Tensor


@torch.no_grad()
def densification_terms(
    aux: GaussianAux,
    mean2d_grad: torch.Tensor,      # (C, 2) d loss / d pixel-space mean
    mean2d_abs_grad: torch.Tensor,  # (C, 2) AbsGS absolute pixel-space grad
    radii: torch.Tensor,            # (C,) int32
    width: int,
    height: int,
) -> tuple:
    """One view's terms of the screen-space gradient statistics, each
    (C,) float32: the gradient norms of the visible live Gaussians
    rescaled to NDC units (x W/2, H/2, so the reference's
    ``densify_grad_threshold`` calibration carries over), the AbsGS norms,
    the visibility (0 or 1) and the radii (0 where not visible)."""
    def ndc_norm(g):
        return torch.sqrt((g[:, 0] * (0.5 * width)) ** 2 + (g[:, 1] * (0.5 * height)) ** 2)

    update = (radii > 0) & aux.alive
    return (torch.where(update, ndc_norm(mean2d_grad), 0.0),
            torch.where(update, ndc_norm(mean2d_abs_grad), 0.0),
            update.to(aux.denom.dtype),
            torch.where(update, radii.to(torch.float32), 0.0))


@torch.no_grad()
def accumulate_densification_stats(aux: GaussianAux, grad: torch.Tensor,
                                   grad_abs: torch.Tensor, visible: torch.Tensor,
                                   radii: torch.Tensor, grad_abs_max=None) -> None:
    """Add terms of :func:`densification_terms` to ``aux`` IN PLACE: sums
    into the accumulators and the visibility counts, maxima into
    ``grad_accum_abs_max`` (from ``grad_abs_max``, default ``grad_abs``)
    and ``max_radii2d``.  A view-parallel step passes the terms summed,
    and the maxima taken, over its views."""
    aux.grad_accum.add_(grad)
    aux.grad_accum_abs.add_(grad_abs)
    torch.maximum(aux.grad_accum_abs_max, grad_abs if grad_abs_max is None else grad_abs_max,
                  out=aux.grad_accum_abs_max)
    aux.denom.add_(visible)
    torch.maximum(aux.max_radii2d, radii, out=aux.max_radii2d)


def add_densification_stats(
    aux: GaussianAux,
    mean2d_grad: torch.Tensor,      # (C, 2) d loss / d pixel-space mean
    mean2d_abs_grad: torch.Tensor,  # (C, 2) AbsGS absolute pixel-space grad
    radii: torch.Tensor,            # (C,) int32
    width: int,
    height: int,
) -> None:
    """Accumulate one view's screen-space gradient statistics for visible
    Gaussians, IN PLACE on ``aux``."""
    accumulate_densification_stats(
        aux, *densification_terms(aux, mean2d_grad, mean2d_abs_grad, radii, width, height))


def _masked_quantile(values: torch.Tensor, mask: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation quantile over the masked entries (0.99 when
    none is masked), with no host sync."""
    c = values.shape[0]
    svals = torch.sort(torch.where(mask, values, float("inf"))).values
    n = torch.sum(mask)
    n_last = torch.clamp_min(n - 1, 0)
    pos = torch.clamp(q, 0.0, 1.0) * n_last.to(torch.float32)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.minimum(i0 + 1, n_last)
    frac = pos - i0.to(torch.float32)
    out = (svals[torch.clamp(i0, 0, c - 1)] * (1.0 - frac)
           + svals[torch.clamp(i1, 0, c - 1)] * frac)
    return torch.where(n > 0, out, 0.99)


def _scatter_rows(arr: torch.Tensor, dest: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr`` with ``arr[dest[i]] = vals[i]`` wherever ``dest[i] < C``;
    rows aimed at ``C`` are dropped.  The write goes through one spare row
    so it needs no host sync (valid destinations are distinct)."""
    ext = torch.cat([arr, arr[:1]])
    return ext.index_copy_(0, dest, vals.expand_as(arr))[:-1]


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    aux: GaussianAux,
    opt_state: AdamState,
    generator: torch.Generator,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
) -> DensifyStats:
    """One clone/split/prune pass, IN PLACE on ``params``, ``aux`` and the
    Adam moments.  The split offsets are N(0, 1) draws from ``generator``
    (one (C, 3) draw per child, first child first), scaled by the parent's
    scale and rotated by its rotation.  Returns device-tensor statistics."""
    cap = params.capacity
    dev = params.xyz.device
    alive = aux.alive.clone()
    seen = (aux.denom > 0) & alive
    denom = torch.clamp_min(aux.denom, 1)
    grads = torch.where(seen, aux.grad_accum / denom, 0.0)
    grads_abs = torch.where(seen, aux.grad_accum_abs / denom, 0.0)

    n_alive0 = torch.sum(alive)
    ratio = torch.sum((grads >= max_grad) & alive) / torch.clamp_min(n_alive0, 1)
    q_thresh = _masked_quantile(grads_abs, alive, 1.0 - ratio)
    q_thresh = torch.where(torch.sum(grads_abs) > 0.0, q_thresh, float("inf"))

    scaling = get_scaling(params)
    scale_max = torch.max(scaling, dim=1).values
    grad_cond = ((grads >= max_grad) | (grads_abs >= q_thresh)) & alive
    clone_mask = grad_cond & (scale_max <= percent_dense * extent)
    split_mask = grad_cond & (scale_max > percent_dense * extent)

    opacity = get_opacity(params)
    prune_pred_parent = opacity < min_opacity
    if max_screen_size:
        # The radius term reads the post-reset (all-zero) max_radii2d.
        prune_zero_radii = torch.zeros_like(aux.max_radii2d)
        prune_pred_parent = (prune_pred_parent | (prune_zero_radii > max_screen_size)
                             | (scale_max > 0.1 * extent))

    # --- destination slots in the dead region --------------------------------
    alive_after_kill = alive & ~split_mask & ~(alive & prune_pred_parent)
    free_order = torch.sort(alive_after_kill.to(torch.int8), stable=True).indices
    n_free = cap - torch.sum(alive_after_kill)

    clone_keep = clone_mask & ~prune_pred_parent
    pos_clone = torch.cumsum(clone_keep, 0) - 1
    n_clone = torch.sum(clone_keep)

    child_scaling = scaling / (0.8 * 2.0)
    child_pred = opacity < min_opacity
    if max_screen_size:
        child_pred = child_pred | (torch.max(child_scaling, dim=1).values > 0.1 * extent)
    split_keep = split_mask & ~child_pred
    pos_split = torch.cumsum(split_keep, 0) - 1
    n_split = torch.sum(split_keep)

    def slot(linear_pos, valid):
        idx = torch.where(valid & (linear_pos < n_free), linear_pos, cap)
        return torch.where(idx < cap, free_order[torch.clamp(idx, 0, cap - 1)], cap)

    dest_clone = slot(pos_clone, clone_keep)
    dest_s0 = slot(n_clone + 2 * pos_split, split_keep)
    dest_s1 = slot(n_clone + 2 * pos_split + 1, split_keep)
    dests = (dest_clone, dest_s0, dest_s1)
    n_dropped = torch.clamp_min(n_clone + 2 * n_split - n_free, 0)

    # --- child values and the writes -----------------------------------------
    rot = quat_to_rotmat(params.rotation)                 # (C, 3, 3)

    def split_child():
        noise = torch.randn((cap, 3), generator=generator, device=dev) * scaling
        return params.xyz + torch.einsum("nij,nj->ni", rot, noise)

    split_values = {
        "xyz": (split_child(), split_child()),
        "scaling": (torch.log(torch.clamp_min(child_scaling, 1e-12)),) * 2,
    }
    for name in _PER_GAUSSIAN_FIELDS:
        src = getattr(params, name)
        if src is None:
            continue
        s0, s1 = split_values.get(name, (src, src))
        out = _scatter_rows(src, dest_clone, src)
        out = _scatter_rows(out, dest_s0, s0)
        src.copy_(_scatter_rows(out, dest_s1, s1))
        for moments in (opt_state.mu, opt_state.nu):
            m = getattr(moments, name)
            for dest in dests:
                m.copy_(_scatter_rows(m, dest, m.new_zeros((1,) + m.shape[1:])))

    # --- alive mask and statistics reset -------------------------------------
    written = torch.zeros(cap, dtype=torch.bool, device=dev)
    for dest in dests:
        written = _scatter_rows(written, dest, written.new_ones(1))
    aux.alive.copy_(alive_after_kill | written)
    aux.filter_3d.copy_(write_children_filter(aux.filter_3d, *dests))
    for t in (aux.grad_accum, aux.grad_accum_abs, aux.grad_accum_abs_max, aux.denom,
              aux.max_radii2d):
        t.zero_()

    n_pruned = torch.sum(alive & prune_pred_parent) + torch.sum(split_mask & ~prune_pred_parent)
    return DensifyStats(n_cloned=n_clone, n_split=n_split, n_pruned=n_pruned,
                        n_dropped=n_dropped, n_alive=torch.sum(aux.alive))


def write_children_filter(filter_3d, dest_clone, dest_s0, dest_s1):
    """Children inherit the parent's 3D filter until the next recompute."""
    out = filter_3d
    for dest in (dest_clone, dest_s0, dest_s1):
        out = _scatter_rows(out, dest, filter_3d)
    return out


@torch.no_grad()
def grow_capacity(state, opt_state: AdamState, new_capacity: int):
    """Host-side capacity growth: pad every per-Gaussian tensor with dead
    slots (opacity logit -10, identity quaternions, zero elsewhere).

    Returns a new ``(state, opt_state)``: every per-Gaussian tensor is
    reallocated, so anything holding the old tensors must take the new
    ones.  The Adam moments of the padding are zero in EVERY field (a -10
    opacity fill in ``nu`` would be sqrt(-x) = NaN on the next step).
    """
    cap = state.params.capacity
    if new_capacity <= cap:
        return state, opt_state
    pad = new_capacity - cap

    def pad_rows(arr, fill=0.0):
        tail = torch.full((pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                          device=arr.device)
        return torch.cat([arr, tail])

    def pad_fields(p: GaussianParams, fills: dict) -> GaussianParams:
        fields = {name: pad_rows(getattr(p, name), fills.get(name, 0.0))
                  for name in _PER_GAUSSIAN_FIELDS if getattr(p, name) is not None}
        return dataclasses.replace(p, **fields)

    params = pad_fields(state.params, {"opacity": -10.0})
    params.rotation[cap:, 0] = 1.0
    new_opt = AdamState(mu=pad_fields(opt_state.mu, {}), nu=pad_fields(opt_state.nu, {}),
                        count=opt_state.count)
    aux = map_fields(pad_rows, state.aux)
    return dataclasses.replace(state, params=params, aux=aux), new_opt
