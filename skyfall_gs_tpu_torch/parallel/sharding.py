"""View-parallel training and rendering over a :class:`ViewMesh`.

Port of the view axis of ``skyfall_gs_tpu/parallel/sharding.py``.  Each
step trains B views, one per rank, with the Gaussian state replicated on
every rank.  The per-view core is the single-device step's own
(``train.step._build_grads_fn``); between its gradients and the replicated
Adam update the ranks combine, as JAX's ``shard_map`` step does with
``pmean`` / ``psum`` / ``pmax``:

  * parameter gradients: the mean over ranks (every leaf, the appearance
    MLP and embeddings included);
  * densification statistics: the sum of the per-view terms of
    ``grad_accum``, ``grad_accum_abs`` and ``denom``, the maximum of
    ``grad_accum_abs_max`` and ``max_radii2d``;
  * metrics: ``loss``, ``l1``, ``depth_loss`` and ``psnr`` averaged,
    ``overflow`` summed, ``opacity_loss`` and ``n_alive`` local.

All of it travels in two flat buffers per step, one all-reduce SUM and one
all-reduce MAX, not a collective per leaf.  The reduced sums are the same
bits on every rank, so the replicated update keeps the ranks' states
bit-equal (``state_digest`` checks it).

The JAX package's scan-fused windows (``make_parallel_multistep*``) are
TPU dispatch fusion; the port runs one B-view step per iteration on the
same host draws.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.model.densify import (
    accumulate_densification_stats,
    densification_terms,
)
from skyfall_gs_tpu_torch.model.gaussians import GaussianParams, flat_fields, from_flat
from skyfall_gs_tpu_torch.model.render import render
from skyfall_gs_tpu_torch.parallel.mesh import ViewMesh
from skyfall_gs_tpu_torch.train.step import (
    StepMetrics,
    TrainState,
    _build_grads_fn,
    apply_update,
)

_MEANS = ("loss", "l1", "depth_loss", "psnr")


@torch.no_grad()
def combine_and_update(state: TrainState, loss, aux: dict, grads: GaussianParams, gdummies,
                       w: int, h: int, opt_cfg, xyz_lr: float, mesh: ViewMesh):
    """The collectives and the replicated update that follow one rank's
    per-view gradients (``grads_fn``'s outputs); ``state`` is updated IN
    PLACE.  Returns ``(state, StepMetrics)``."""
    model = state.model
    g, g_abs, visible, radii = densification_terms(model.aux, gdummies[0], gdummies[1],
                                                   aux["radii"], w, h)
    paths, leaves = zip(*flat_fields(grads))
    overflow = aux["overflow"]
    scalars = torch.stack([loss, *(aux[k] for k in _MEANS[1:]),
                           torch.zeros((), device=loss.device) if overflow is None
                           else overflow.to(torch.float32)])
    parts = [x.reshape(-1) for x in leaves] + [g, g_abs, visible, scalars]
    summed = mesh.all_reduce_(torch.cat(parts), "sum")
    maxed = mesh.all_reduce_(torch.cat([g_abs, radii]), "max")

    pieces = list(torch.split(summed, [p.numel() for p in parts]))
    inv = 1.0 / mesh.size
    mean_grads = from_flat(GaussianParams, [
        (k, (p * inv).view_as(x)) for k, p, x in zip(paths, pieces, leaves)])
    g_sum, g_abs_sum, visible_sum, scalars = pieces[len(leaves):]
    c = g.shape[0]
    accumulate_densification_stats(model.aux, g_sum, g_abs_sum, visible_sum, maxed[c:],
                                   grad_abs_max=maxed[:c])
    apply_update(state, mean_grads, opt_cfg, xyz_lr)
    means = scalars[:4] * inv
    metrics = StepMetrics(
        loss=means[0], l1=means[1], depth_loss=means[2],
        opacity_loss=aux["opacity_loss"], psnr=means[3],
        n_alive=torch.sum(model.aux.alive),
        overflow=None if overflow is None else scalars[4].round().to(overflow.dtype))
    return state, metrics


def make_parallel_train_step(mesh: ViewMesh, opt_cfg, **step_kwargs):
    """The view-parallel training step (``step_kwargs`` as for
    ``train.step._build_grads_fn``): JAX's signature less the leading B
    axis, since each rank passes its own view.

    Signature:
        step(state, camera, gt_image (H,W,3), gt_mask (H,W), gt_depth (H,W),
             bg (3,), xyz_lr, lambda_opacity, generator=None,
             subpixel_offset=None, **pseudo) -> (state, StepMetrics)

    ``generator`` draws this rank's ray jitter; the ``pseudo_*`` arguments
    are the same on every rank (a replicated pseudo view adds the same
    depth term everywhere).  ``state`` is updated in place and returned.
    """
    grads_fn = _build_grads_fn(opt_cfg, **step_kwargs)

    def step(state: TrainState, camera: Camera, gt_image, gt_mask, gt_depth, bg,
             xyz_lr: float, lambda_opacity: float,
             generator: Optional[torch.Generator] = None,
             subpixel_offset: Optional[torch.Tensor] = None, **pseudo):
        loss, aux, grads, gdummies = grads_fn(
            state.model, camera, gt_image, gt_mask, gt_depth, bg, lambda_opacity,
            generator, subpixel_offset, **pseudo)
        return combine_and_update(state, loss, aux, grads, gdummies, camera.width,
                                  camera.height, opt_cfg, xyz_lr, mesh)

    return step


def make_tile_parallel_render(mesh: ViewMesh, kernel_size: float = 0.1,
                              backend: str = "tiled", bin_capacity: Optional[int] = None):
    """One frame split into horizontal bands, one per rank: each rank
    renders its band through ``core.camera.band_camera`` and the bands are
    gathered.  ``fn(model, band_camera(cam, rank, size), bg)`` returns the
    full (H, W, 3) frame on every rank."""

    @torch.no_grad()
    def fn(model, band_cam: Camera, bg):
        out = render(model, band_cam, bg, kernel_size=kernel_size, backend=backend,
                     testing=True, inference=True, bin_capacity=bin_capacity)
        bands = mesh.all_gather(out.color)
        return bands.reshape(-1, *bands.shape[2:])

    return fn


def make_parallel_render(mesh: ViewMesh, kernel_size: float = 0.1, backend: str = "tiled",
                         bin_capacity: Optional[int] = None):
    """B cameras to B images, one camera per rank: ``fn(model, camera,
    bg)`` returns every rank's ``(colors (B,H,W,3), depths (B,H,W))``
    (IDU orbit sets and batch evaluation)."""

    @torch.no_grad()
    def fn(model, camera: Camera, bg):
        out = render(model, camera, bg, kernel_size=kernel_size, backend=backend,
                     testing=True, bin_capacity=bin_capacity)
        return mesh.all_gather(out.color), mesh.all_gather(out.depth)

    return fn


def _state_tensors(state: TrainState) -> list:
    model = state.model
    return ([t for _, t in flat_fields(model.params)]
            + [t for _, t in flat_fields(state.opt.mu)]
            + [t for _, t in flat_fields(state.opt.nu)]
            + [t for _, t in flat_fields(model.aux)])


@torch.no_grad()
def broadcast_state_(state: TrainState, mesh: ViewMesh) -> TrainState:
    """Rank 0's parameters, Adam moments and densification state on every
    rank, IN PLACE (the start of a replicated run)."""
    for t in _state_tensors(state):
        mesh.broadcast_(t)
    return state


def state_digest(state: TrainState) -> str:
    """SHA-256 of the state's bits: parameters, Adam moments and the
    densification state, in a fixed order, with the step counts."""
    h = hashlib.sha256(f"{state.step}/{state.opt.count}".encode())
    for t in _state_tensors(state):
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def assert_replicated(state: TrainState, mesh: ViewMesh) -> str:
    """Raise unless every rank holds the same state bits; returns the
    digest."""
    digests = mesh.all_gather_object(state_digest(state))
    if len(set(digests)) != 1:
        raise RuntimeError(f"replicated state diverged across ranks: {digests}")
    return digests[0]
