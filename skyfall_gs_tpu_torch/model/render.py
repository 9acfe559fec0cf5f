"""Model-level render front-end: appearance/SH colors, 3D filters, rasterize.

Port of ``skyfall_gs_tpu/model/render.py``: SH evaluated at the active
degree (clamped at 0 after the +0.5 shift), after the appearance MLP has
toned the SH coefficients for the view's camera embedding when appearance
is enabled; scales and opacities through the Mip-Splatting 3D filter.
"""

from __future__ import annotations

from typing import Optional

import torch

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.core.sh import eval_sh
from skyfall_gs_tpu_torch.model.appearance import apply_appearance
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianModelState,
    get_opacity,
    get_scaling,
    opacity_with_3d_filter,
    scaling_with_3d_filter,
)
from skyfall_gs_tpu_torch.ops.rasterize import RenderOutput, rasterize
from skyfall_gs_tpu_torch.utils.trace import span


def _activated(state: GaussianModelState, with_3d_filter: bool):
    params = state.params
    if with_3d_filter:
        return (scaling_with_3d_filter(params, state.aux.filter_3d),
                opacity_with_3d_filter(params, state.aux.filter_3d))
    return get_scaling(params), get_opacity(params)


@torch.no_grad()
def measure_bin_capacity(
    state: GaussianModelState,
    cameras,
    kernel_size: float = 0.1,
    with_3d_filter: bool = True,
    mesh=None,
) -> int:
    """Binning capacity for rendering ``cameras``: the worst view's measured
    duplicated-entry count through ``capacity_for_entries``.  Reads the
    counts back to the host once.  On a gaussian-sharded state (``mesh``)
    a view's count is the sum over the shards: every splat of the view, so
    no depth bin of it can hold more (one all-reduce of the counts)."""
    from skyfall_gs_tpu_torch.ops.binning import capacity_for_entries, count_entries
    from skyfall_gs_tpu_torch.ops.projection import project_gaussians

    scales, opac = _activated(state, with_3d_filter)
    counts = []
    for cam in cameras:
        proj = project_gaussians(state.params.xyz, scales, state.params.rotation, opac,
                                 cam, kernel_size=kernel_size, mask=state.aux.alive)
        counts.append(count_entries(proj.mean2d, proj.radius, cam.height, cam.width,
                                    radius_xy=proj.radius_xy))
    counts = (torch.stack(counts) if counts
              else torch.zeros(1, dtype=torch.int64, device=state.params.xyz.device))
    if mesh is not None:
        counts = mesh.all_reduce_(counts)
    return capacity_for_entries(int(counts.max()))


@span("render.colors")
def compute_colors(state: GaussianModelState, camera: Camera, testing: bool = False,
                   appearance_embedding: Optional[torch.Tensor] = None,
                   override_color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-Gaussian RGB for one view (appearance + SH evaluation).

    The camera embedding is ``appearance_embedding`` when given; else, with
    ``testing``, the fixed reference embedding ``min(6, M-1)``; else the
    camera's own, ``clip(uid, 0, M-1)``.
    """
    if override_color is not None:
        return override_color
    params = state.params
    dirs = params.xyz - camera.cam_center[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    features = params.features
    if state.appearance.enabled and params.appearance_mlp is not None:
        table = params.appearance_embeddings
        emb = appearance_embedding
        if emb is None:
            m = table.shape[0]
            emb = table[min(6, m - 1) if testing else min(max(camera.uid, 0), m - 1)]
        features = apply_appearance(params.appearance_mlp, params.embeddings, emb,
                                    features)
    sh = features.transpose(1, 2)                        # (N, 3, K)
    return torch.clamp_min(eval_sh(state.active_sh_degree, sh, dirs) + 0.5, 0.0)


@span("render")
def render(
    state: GaussianModelState,
    camera: Camera,
    bg: torch.Tensor,
    kernel_size: float = 0.1,
    scaling_modifier: float = 1.0,
    subpixel_offset: Optional[torch.Tensor] = None,
    testing: bool = False,
    appearance_embedding: Optional[torch.Tensor] = None,
    override_color: Optional[torch.Tensor] = None,
    mean2d_dummy: Optional[torch.Tensor] = None,
    mean2d_abs_dummy: Optional[torch.Tensor] = None,
    backend: str = "tiled",
    with_3d_filter: bool = True,
    bin_capacity: Optional[int] = None,
    inference: bool = False,
    with_normals: bool = True,
    entry_budget: Optional[int] = None,
) -> RenderOutput:
    """Render one view from the model state (``entry_budget``: the
    inference-only LOD cap of ``ops.rasterize.rasterize``)."""
    scales, opac = _activated(state, with_3d_filter)
    return rasterize(
        state.params.xyz, scales, state.params.rotation, opac,
        compute_colors(state, camera, testing=testing,
                       appearance_embedding=appearance_embedding,
                       override_color=override_color),
        camera,
        bg=bg,
        kernel_size=kernel_size,
        mask=state.aux.alive,
        subpixel_offset=subpixel_offset,
        scaling_modifier=scaling_modifier,
        mean2d_dummy=mean2d_dummy,
        mean2d_abs_dummy=mean2d_abs_dummy,
        backend=backend,
        bin_capacity=bin_capacity,
        inference=inference,
        with_normals=with_normals,
        entry_budget=entry_budget,
    )
