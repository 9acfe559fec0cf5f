"""Adaptive density control statistics.

Port of ``add_densification_stats`` from ``skyfall_gs_tpu/model/densify.py``
(clone / split / prune are not ported yet).
"""

from __future__ import annotations

import torch

from skyfall_gs_tpu_torch.model.gaussians import GaussianAux


@torch.no_grad()
def add_densification_stats(
    aux: GaussianAux,
    mean2d_grad: torch.Tensor,      # (C, 2) d loss / d pixel-space mean
    mean2d_abs_grad: torch.Tensor,  # (C, 2) AbsGS absolute pixel-space grad
    radii: torch.Tensor,            # (C,) int32
    width: int,
    height: int,
) -> None:
    """Accumulate screen-space gradient statistics for visible Gaussians,
    IN PLACE on ``aux``.  Gradients are rescaled to NDC units (x W/2, H/2)
    so the reference's ``densify_grad_threshold`` calibration carries over.
    """
    def ndc_norm(g):
        return torch.sqrt((g[:, 0] * (0.5 * width)) ** 2 + (g[:, 1] * (0.5 * height)) ** 2)

    update = (radii > 0) & aux.alive
    g = torch.where(update, ndc_norm(mean2d_grad), 0.0)
    ga = torch.where(update, ndc_norm(mean2d_abs_grad), 0.0)
    aux.grad_accum.add_(g)
    aux.grad_accum_abs.add_(ga)
    torch.maximum(aux.grad_accum_abs_max, ga, out=aux.grad_accum_abs_max)
    aux.denom.add_(update.to(aux.denom.dtype))
    torch.maximum(aux.max_radii2d, torch.where(update, radii.to(torch.float32), 0.0),
                  out=aux.max_radii2d)
