"""Gaussian-sharded training: the splat state itself split across ranks.

Port of ``skyfall_gs_tpu/parallel/gauss_shard.py``.  Densification grows a
scene's splat count without bound and one card's memory caps it; here the
state's per-splat rows (parameters, Adam moments, densification statistics)
are split by rows over the ``gauss`` axis of a ``parallel.mesh.ViewMesh``:
rank k holds rows ``[k*n, (k+1)*n)`` of capacity ``G*n``.  The appearance
camera table and MLP are replicated.

Compositing must be depth-ordered per pixel while the shards are arbitrary
subsets, so every step re-bins the visible splats by **global view-depth
quantile**: rank k composites exactly the splats of depth bin k, so for
every pixel all of bin k's contributions precede bin k+1's and the partial
images merge exactly with the over operator

    C = C_0 + T_0 C_1 + T_0 T_1 C_2 + ...,   T = prod_k T_k.

Per render: one all-gather of the 16-float screen attributes (means,
conic, opacity, depth, the 7 blend channels and the AbsGS dummy), one of
the integer radii, one of the partial images with their T_final, and one
all-reduce of the overflow.  Each rank composites the gathered table with
``ops/rasterize_tiled.composite_tiled`` (both CUDA kernels), the entries
outside its bin going in at radius 0 so they are culled before
duplication.

The gradient is the true one, not G times it.  Every rank computes the
same loss from the same merged image, so each holds the same cotangent of
the gathered partial images and takes its own slice
(``mesh.all_gather_replicated``); the screen attributes' cotangents differ
per rank (rank k's backward covers bin k's rows) and are summed onto the
owning rank by a reduce-scatter (``mesh.all_gather_sum_grad``).  JAX's
``shard_map`` step transposes the image all-gather into a ``psum_scatter``
of G identical cotangents instead, so its gradients, Adam moments and
densification statistics are G times the single-device ones (ROADMAP,
Queue 3).  The opacity entropy's sum over the shards needs no collective in
its backward: its gradient on a rank's rows is that rank's term's.

Each bin stops at its own ``T >= 1e-4``, not the global one, so the
sharded step equals the single-device step up to that boundary; one shard
is the single-device step exactly.

The JAX package's scan-fused windows (``make_gauss_sharded_multistep``,
``make_gauss_idu_multistep``) are TPU dispatch fusion; the Trainer and the
IDU episodes run one sharded step per iteration on the same draws.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.model.densify import densify_and_prune, grow_capacity
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianAux,
    GaussianModelState,
    GaussianParams,
    flat_fields,
    from_flat,
)
from skyfall_gs_tpu_torch.model.optim import AdamState
from skyfall_gs_tpu_torch.model.render import _activated, compute_colors
from skyfall_gs_tpu_torch.ops.losses import opacity_entropy_sum
from skyfall_gs_tpu_torch.ops.projection import project_gaussians, smallest_axis_normals
from skyfall_gs_tpu_torch.ops.rasterize import RenderOutput
from skyfall_gs_tpu_torch.ops.rasterize_tiled import composite_tiled
from skyfall_gs_tpu_torch.parallel.mesh import (
    ViewMesh,
    all_gather_replicated,
    all_gather_sum_grad,
)
from skyfall_gs_tpu_torch.parallel.sharding import combine_and_update
from skyfall_gs_tpu_torch.train.step import TrainState, _build_grads_fn, step_from_grads

# Columns of the gathered screen-attribute table.
_MEAN, _CONIC, _OPAC, _DEPTH, _CH, _ABS = (slice(0, 2), slice(2, 5), 5, 6, slice(7, 14),
                                            slice(14, 16))


def _depth_bin_edges(depth: torch.Tensor, visible: torch.Tensor, num_bins: int) -> torch.Tensor:
    """``(num_bins + 1,)`` edges: -inf, the linear-interpolation quantiles
    of the visible depths at 1/B, ..., (B-1)/B (``jnp.nanquantile``'s
    method, by one sort: ``torch.nanquantile`` refuses more than 2^24
    elements), +inf.  The same bits on every rank, from the same gathered
    depths."""
    d = torch.sort(torch.where(visible, depth, float("inf"))).values
    n_last = torch.clamp_min(torch.sum(visible) - 1, 0)
    qs = torch.linspace(0.0, 1.0, num_bins + 1, device=depth.device)[1:-1]
    pos = qs * n_last.to(torch.float32)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.minimum(i0 + 1, n_last)
    frac = pos - i0.to(torch.float32)
    inner = d[i0] * (1.0 - frac) + d[i1] * frac
    inf = torch.full((1,), float("inf"), device=depth.device)
    return torch.cat([-inf, inner, inf])


def sharded_render_merge(mesh: ViewMesh, xyz, scales, quats, opac, colors, alive,
                         camera: Camera, bg, kernel_size: float = 0.1, normals=None,
                         mean2d_dummy=None, mean2d_abs_dummy=None,
                         bin_capacity: Optional[int] = None, subpixel_offset=None,
                         inference: bool = False) -> RenderOutput:
    """Render one camera from this rank's splats (all per-splat inputs are
    the local rows): project, gather the screen attributes, composite depth
    bin ``mesh.rank``, gather the partial images and merge them in bin
    order.  The image outputs are the same on every rank; ``radii`` covers
    the local rows; ``overflow`` is the sum over the bins.  ``normals``
    (local, premultiplied like the colors) default to zero, as in the
    training renders."""
    k, g = mesh.rank, mesh.size
    proj = project_gaussians(xyz, scales, quats, opac, camera, kernel_size=kernel_size,
                             mask=alive)
    mean2d = proj.mean2d if mean2d_dummy is None else proj.mean2d + mean2d_dummy
    local = torch.cat([
        mean2d, proj.conic, proj.opacity[:, None], proj.depth[:, None], colors,
        proj.depth[:, None], torch.zeros_like(xyz) if normals is None else normals,
        torch.zeros_like(mean2d) if mean2d_abs_dummy is None else mean2d_abs_dummy], dim=1)
    table = all_gather_sum_grad(local, mesh).reshape(-1, local.shape[1])
    ints = mesh.all_gather(torch.cat([proj.radius[:, None], proj.radius_xy], dim=1))
    ints = ints.reshape(-1, 3)
    depth = table[:, _DEPTH].detach()
    edges = _depth_bin_edges(depth, ints[:, 0] > 0, g)
    in_bin = (depth >= edges[k]) & (depth < edges[k + 1])
    radii = torch.where(in_bin, ints[:, 0], 0)
    radius_xy = torch.where(in_bin[:, None], ints[:, 1:], 0)

    out_k, tfin_k, overflow_k = composite_tiled(
        table[:, _MEAN], table[:, _CONIC], depth, radii, table[:, _OPAC], table[:, _CH],
        camera.height, camera.width, subpixel_offset=subpixel_offset,
        mean2d_abs_dummy=table[:, _ABS], cap=bin_capacity, inference=inference,
        radius_xy=radius_xy)
    parts = all_gather_replicated(torch.cat([out_k, tfin_k[..., None]], dim=-1), mesh)
    acc, t_all = parts[0, ..., :7], parts[0, ..., 7]
    for j in range(1, g):
        acc = acc + t_all[..., None] * parts[j, ..., :7]
        t_all = t_all * parts[j, ..., 7]
    overflow = mesh.all_reduce_(overflow_k.reshape(1).clone())[0]

    color = acc[..., :3] + t_all[..., None] * bg[None, None, :]
    alpha = 1.0 - t_all
    return RenderOutput(color=color, depth=acc[..., 3] / torch.clamp_min(alpha, 1e-8),
                        normal=acc[..., 4:7], alpha=alpha, radii=proj.radius,
                        overflow=overflow)


def sharded_render(mesh: ViewMesh, state: GaussianModelState, camera: Camera, bg,
                   kernel_size: float = 0.1, subpixel_offset=None, testing: bool = False,
                   mean2d_dummy=None, mean2d_abs_dummy=None, backend: str = "tiled",
                   bin_capacity: Optional[int] = None, inference: bool = False,
                   with_normals: bool = True) -> RenderOutput:
    """``model.render.render`` for a gaussian-sharded state: the colors
    (appearance and SH) and the 3D filter of the local rows, then
    :func:`sharded_render_merge`.  Every rank calls it with the same
    camera; ``bin_capacity`` must hold every entry of the view
    (``measure_bin_capacity(..., mesh=mesh)``)."""
    if backend != "tiled":
        raise ValueError(f"the gaussian-sharded render composites with the tiled kernels, "
                         f"not {backend!r}")
    scales, opac = _activated(state, True)
    p = state.params
    normals = (smallest_axis_normals(scales, p.rotation, p.xyz, camera.cam_center)
               if with_normals else None)
    return sharded_render_merge(
        mesh, p.xyz, scales, p.rotation, opac, compute_colors(state, camera, testing=testing),
        state.aux.alive, camera, bg, kernel_size, normals=normals, mean2d_dummy=mean2d_dummy,
        mean2d_abs_dummy=mean2d_abs_dummy, bin_capacity=bin_capacity,
        subpixel_offset=subpixel_offset, inference=inference)


def sharded_opacity_entropy(mesh: ViewMesh, opacity, alive) -> torch.Tensor:
    """The opacity entropy's mean over every shard's live splats.  Its
    value is the same bits on every rank (the all-reduced sum over the
    all-reduced count, plus an exact zero); its gradient on this rank's
    rows is that of this rank's sum alone, so the backward needs no
    collective."""
    local, n = opacity_entropy_sum(opacity, alive)
    tot = mesh.all_reduce_(torch.stack([local.detach().double(), n.double()]))
    n_all = torch.clamp_min(tot[1].round().to(n.dtype), 1)
    return tot[0].to(local.dtype) / n_all + (local - local.detach()) / n_all


def _replicated_path(path: str) -> bool:
    return any(part in path for part in _REPLICATED_PATH_PARTS)


def _build_gauss_grads_fn(mesh: ViewMesh, opt_cfg, **kwargs):
    """The per-view loss and gradients on a gaussian shard: the
    single-device ``train.step._build_grads_fn`` (every step option, its
    call signature) through :func:`sharded_render` and
    :func:`sharded_opacity_entropy`, then the replicated appearance
    leaves' gradients summed over the shards (each rank's backward sees
    its own splats' share), one all-reduce.  The ray jitter must be the
    same on every rank (``generator`` seeded alike): every rank composites
    a bin of the same image."""
    grads_fn = _build_grads_fn(opt_cfg, render_fn=functools.partial(sharded_render, mesh),
                               entropy_fn=functools.partial(sharded_opacity_entropy, mesh),
                               **kwargs)

    def grads(*args, **kw):
        loss, aux, g, gdummies = grads_fn(*args, **kw)
        shared = [t for path, t in flat_fields(g) if _replicated_path(path)]
        if shared:
            summed = mesh.all_reduce_(torch.cat([t.reshape(-1) for t in shared]))
            for t, s in zip(shared, torch.split(summed, [t.numel() for t in shared])):
                t.copy_(s.view_as(t))
        return loss, aux, g, gdummies

    return grads


def make_gauss_sharded_train_step(mesh: ViewMesh, opt_cfg, **kwargs):
    """The gaussian-sharded training step (``kwargs`` as for
    ``train.step._build_grads_fn``; ``backend`` must be ``"tiled"``), with
    the single-device step's signature:

        step(state, camera, gt_image, gt_mask, gt_depth, bg, xyz_lr,
             lambda_opacity, generator=None, subpixel_offset=None, **pseudo)
            -> (state, StepMetrics)

    ``state`` is this rank's shard (:func:`shard_train_state`), updated in
    place; every other input is the same on every rank.  The metrics are
    the same bits on every rank; ``n_alive`` and ``overflow`` are sums over
    the shards."""
    return step_from_grads(
        _build_gauss_grads_fn(mesh, opt_cfg, **kwargs), opt_cfg,
        count_alive=lambda alive: mesh.all_reduce_(torch.sum(alive).reshape(1))[0])


def make_grid_train_step(data_mesh: ViewMesh, gauss_mesh: ViewMesh, opt_cfg, **kwargs):
    """The (B, G) grid step (``parallel.mesh.grid_meshes``): rank (d, g)
    holds splat shard g (the same rows on every data row) and trains view
    d.  Within a row the render is :func:`sharded_render_merge` over
    ``gauss_mesh``; across rows ``parallel.sharding.combine_and_update``
    averages the gradients and sums the statistics over ``data_mesh``, as
    the view-parallel step does, so a (B, G) grid reproduces the B-view
    step of a G-way sharded model.  ``generator`` draws row d's ray jitter
    and must be seeded alike on the row's ranks.

    Signature: step(state, camera (row d's), gt_image, gt_mask, gt_depth,
    bg, xyz_lr, lambda_opacity, generator=None, subpixel_offset=None)
        -> (state, StepMetrics)"""
    grads_fn = _build_gauss_grads_fn(gauss_mesh, opt_cfg, **kwargs)

    def step(state: TrainState, camera: Camera, gt_image, gt_mask, gt_depth, bg,
             xyz_lr: float, lambda_opacity: float,
             generator: Optional[torch.Generator] = None, subpixel_offset=None):
        loss, aux, grads, gdummies = grads_fn(state.model, camera, gt_image, gt_mask, gt_depth,
                                              bg, lambda_opacity, generator, subpixel_offset)
        state, m = combine_and_update(state, loss, aux, grads, gdummies, camera.width,
                                      camera.height, opt_cfg, xyz_lr, data_mesh)
        return state, m._replace(n_alive=gauss_mesh.all_reduce_(m.n_alive.reshape(1))[0])

    return step


def make_sharded_densify(mesh: ViewMesh, **static_kwargs):
    """The clone / split / prune pass on a gaussian shard
    (``model.densify.densify_and_prune`` with ``mesh``: the ratio and the
    AbsGS quantile over every shard, the rest local).  ``generator`` must
    differ per rank (JAX folds the key with the shard index), or the
    shards' split children share their noise.

    Signature: densify(state, generator) -> DensifyStats (summed over the
    shards), the state updated in place."""

    def densify(state: TrainState, generator: torch.Generator):
        return densify_and_prune(state.model.params, state.model.aux, state.opt, generator,
                                 mesh=mesh, **static_kwargs)

    return densify


def sharded_grow_capacity(state: TrainState, mesh: ViewMesh, new_capacity: int) -> TrainState:
    """Grow a sharded state to the GLOBAL ``new_capacity`` (a multiple of
    the mesh size) with the pad slots spread evenly over the shards: each
    grows its own rows by ``model.densify.grow_capacity`` (a global pad at
    the end would give the last shard every free slot and starve the
    others' shard-local densify).  Returns the new local state."""
    if new_capacity % mesh.size:
        raise ValueError(f"new_capacity {new_capacity} not divisible by {mesh.size} shards")
    model, opt = grow_capacity(state.model, state.opt, new_capacity // mesh.size)
    return dataclasses.replace(state, model=model, opt=opt)


# Leaves that replicate whatever their shape: the appearance camera table is
# camera-indexed and the MLP is global, so a scene whose camera count (or a
# layer width) equals the splat capacity must not shard them.
_REPLICATED_PATH_PARTS = ("appearance_embeddings", "appearance_mlp")


def _is_splat_leaf(path: str, t: torch.Tensor, capacity: int) -> bool:
    return not _replicated_path(path) and t.ndim >= 1 and t.shape[0] == capacity


def _map_state(state: TrainState, fn) -> TrainState:
    """A TrainState whose tensors are ``fn(path, tensor)`` (paths as in the
    ``.npz`` checkpoint, without the part prefix)."""
    model, opt = state.model, state.opt

    def part(obj, cls):
        return from_flat(cls, [(p, fn(p, t)) for p, t in flat_fields(obj)])

    new_model = dataclasses.replace(model, params=part(model.params, GaussianParams),
                                    aux=part(model.aux, GaussianAux))
    new_opt = AdamState(mu=part(opt.mu, GaussianParams), nu=part(opt.nu, GaussianParams),
                        count=opt.count)
    return TrainState(model=new_model, opt=new_opt, step=state.step)


@torch.no_grad()
def shard_train_state(state: TrainState, mesh: ViewMesh) -> TrainState:
    """This rank's shard of a full state that every rank holds alike: rows
    ``[rank*n, (rank+1)*n)`` of every per-splat leaf (``_is_splat_leaf``,
    the JAX package's rule), copies of the replicated leaves.  The capacity
    must be a multiple of the mesh size."""
    cap = state.model.params.capacity
    if cap % mesh.size:
        raise ValueError(f"capacity {cap} not divisible by {mesh.size} shards")
    n = cap // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return _map_state(state, lambda p, t: (t[rows] if _is_splat_leaf(p, t, cap) else t).clone())


@torch.no_grad()
def gather_train_state(state: TrainState, mesh: ViewMesh) -> TrainState:
    """The full state on every rank from the shards (the inverse of
    :func:`shard_train_state`), one all-gather per per-splat leaf: PLY
    export, evaluation renders and the ``.npz`` interchange.  Every rank
    must call it."""
    n = state.model.params.capacity

    def gather(path, t):
        if not _is_splat_leaf(path, t, n):
            return t.clone()
        rows = mesh.all_gather(t.to(torch.uint8) if t.dtype == torch.bool else t)
        rows = rows.reshape(-1, *t.shape[1:])
        return rows.to(torch.bool) if t.dtype == torch.bool else rows

    return _map_state(state, gather)
