"""Differentiable 3DGS rasterization: public API and backend dispatch.

Port of ``skyfall_gs_tpu/ops/rasterize.py``.  Backends:
  * ``"reference"`` — the O(H*W*N) oracle (tests / tiny scenes);
  * ``"tiled"`` — tile binning + the compositing kernels (production).

Screen-space gradients for adaptive density control come out the same way
as in the JAX package: ``mean2d_dummy`` (N, 2) zeros are added to the
projected means, so the gradient w.r.t. it is d(loss)/d(mean2d); the tiled
backend routes the AbsGS absolute screen gradient into
``mean2d_abs_dummy``'s gradient.

``entry_budget`` is the inference-only LOD of the JAX package
(``_apply_entry_budget``): plain tensor ops, no kernel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.ops.binning import per_splat_entries
from skyfall_gs_tpu_torch.ops.projection import (
    ProjectedGaussians,
    project_gaussians,
    smallest_axis_normals,
)
from skyfall_gs_tpu_torch.ops.rasterize_ref import composite_reference
from skyfall_gs_tpu_torch.ops.rasterize_tiled import composite_tiled
from skyfall_gs_tpu_torch.utils.trace import count, span

_PROJECT = span("render.project")
_COMPOSITE = span("render.composite")


@dataclass
class RenderOutput:
    """Everything the training loop and tools consume from one render."""

    color: torch.Tensor    # (H, W, 3), background composited
    depth: torch.Tensor    # (H, W) alpha-normalized expected view-space depth
    normal: torch.Tensor   # (H, W, 3) premultiplied blended normals
    alpha: torch.Tensor    # (H, W) 1 - final transmittance
    radii: torch.Tensor    # (N,) int32 screen radii, 0 = culled/invisible
    # () duplicated entries dropped by an undersized bin capacity (tiled
    # backend only; 0 = everything composited).
    overflow: Optional[torch.Tensor] = None

    @property
    def visibility(self) -> torch.Tensor:
        return self.radii > 0


def _apply_entry_budget(proj: ProjectedGaussians, camera: Camera,
                        budget: int) -> ProjectedGaussians:
    """Greedy entry-budgeted LOD: keep splats by contribution per entry.

    Render time scales with duplicated (splat, tile) entries, so the LOD
    axis is an entry budget.  Value = opacity x cutoff-AABB pixel area;
    cost = touched tiles.  Splats are ranked by value / cost (a STABLE sort,
    as ``jnp.argsort``: culled splats all tie at -1 and equal-area splats
    tie too), then two greedy passes each drop the splats whose own cost
    exceeds the remaining budget (so one oversized splat cannot block the
    cheap tail behind it) and keep the eligible prefix that fits.  The
    dropped splats get radius 0.
    """
    counts = per_splat_entries(proj.mean2d, proj.radius, camera.height, camera.width,
                               radius_xy=proj.radius_xy)
    area = (proj.radius_xy[:, 0] * proj.radius_xy[:, 1]).to(torch.float32)
    value = proj.opacity * area
    ratio = torch.where(counts > 0, value / torch.clamp_min(counts, 1), -1.0)
    order = torch.argsort(-ratio, stable=True)
    c_sorted = counts[order]
    keep_sorted = torch.zeros_like(c_sorted, dtype=torch.bool)
    rem = torch.tensor(budget, dtype=c_sorted.dtype, device=c_sorted.device)
    for _ in range(2):
        elig = ~keep_sorted & (c_sorted > 0) & (c_sorted <= rem)
        cum = torch.cumsum(torch.where(elig, c_sorted, 0), 0)
        keep_sorted = keep_sorted | (elig & (cum <= rem))
        rem = budget - torch.sum(torch.where(keep_sorted, c_sorted, 0))
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return dataclasses.replace(
        proj,
        radius=torch.where(keep, proj.radius, 0),
        radius_xy=torch.where(keep[:, None], proj.radius_xy, 0),
    )


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    camera: Camera,
    bg: torch.Tensor,
    kernel_size: float = 0.1,
    mask: Optional[torch.Tensor] = None,
    subpixel_offset: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    mean2d_dummy: Optional[torch.Tensor] = None,
    mean2d_abs_dummy: Optional[torch.Tensor] = None,
    with_normals: bool = True,
    backend: str = "tiled",
    bin_capacity: Optional[int] = None,
    inference: bool = False,
    entry_budget: Optional[int] = None,
) -> RenderOutput:
    """Render one view.

    Args:
        means3d/scales/quats/opacities: activated Gaussian state (scales and
            opacities already include the Mip-Splatting 3D filter).
        colors: (N, 3) precomputed RGB.
        bg: (3,) background color.
        mask: (N,) alive mask for padded state.
        mean2d_dummy: (N, 2) zeros; gradient w.r.t. it = screen gradient.
        mean2d_abs_dummy: (N, 2) zeros; the tiled backend routes the AbsGS
            absolute screen gradient into its gradient.
        backend: "tiled" (the compositing kernels) or "reference" (oracle).
        inference: tiled backend only — the forward kernel alone, outside
            autograd (eval and video renders).
        entry_budget: inference-only cap on duplicated (splat, tile)
            entries, spent greedily by contribution per entry (see
            ``_apply_entry_budget``); a lossy speed/quality trade.  With
            ``bin_capacity=None`` the capacity is the budget rounded up to
            256, so nothing overflows.
    """
    with _PROJECT:
        launched = project_gaussians.launches
        proj = project_gaussians(
            means3d, scales, quats, opacities, camera,
            kernel_size=kernel_size, mask=mask, scaling_modifier=scaling_modifier,
        )
        count("render.project.kernel", project_gaussians.launches - launched)
    if entry_budget is not None:
        if not inference:
            raise ValueError("entry_budget is an inference-only LOD mode; "
                             "training must composite every live splat")
        proj = _apply_entry_budget(proj, camera, entry_budget)
        if bin_capacity is None:
            bin_capacity = -(-entry_budget // 256) * 256
    mean2d = proj.mean2d
    if mean2d_dummy is not None:
        mean2d = mean2d + mean2d_dummy

    if with_normals:
        normals = smallest_axis_normals(scales, quats, means3d, camera.cam_center)
    else:
        normals = torch.zeros_like(means3d)

    with _COMPOSITE:
        # Blend channels: [r, g, b, depth, nx, ny, nz]
        channels = torch.cat([colors, proj.depth[:, None], normals], dim=-1)

        overflow = None
        if backend == "reference":
            out, t_final = composite_reference(
                mean2d, proj.conic, proj.depth, proj.radius, proj.opacity,
                channels, camera.height, camera.width, subpixel_offset)
        elif backend == "tiled":
            out, t_final, overflow = composite_tiled(
                mean2d, proj.conic, proj.depth, proj.radius, proj.opacity,
                channels, camera.height, camera.width,
                subpixel_offset=subpixel_offset,
                mean2d_abs_dummy=mean2d_abs_dummy,
                cap=bin_capacity,
                inference=inference,
                radius_xy=proj.radius_xy,
            )
        else:
            raise ValueError(f"unknown rasterize backend: {backend}")

    color = out[..., :3] + t_final[..., None] * bg[None, None, :]
    alpha = 1.0 - t_final
    # Alpha-normalized expected depth Sum(w d) / Sum(w): the metric depth the
    # Pearson depth loss is calibrated against.
    depth = out[..., 3] / torch.clamp_min(alpha, 1e-8)
    return RenderOutput(
        color=color,
        depth=depth,
        normal=out[..., 4:7],
        alpha=alpha,
        radii=proj.radius,
        overflow=overflow,
    )
