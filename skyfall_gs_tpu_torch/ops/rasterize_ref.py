"""Reference compositor: the O(H*W*N) correctness oracle.

Port of ``skyfall_gs_tpu/ops/rasterize_ref.py``.  Composites every
projected Gaussian at every pixel, so it is only for tests and tiny
scenes; differentiable through torch autograd.
"""

from __future__ import annotations

import torch

ALPHA_EPS = 1.0 / 255.0   # contributions below this are skipped
ALPHA_MAX = 0.99          # per-splat alpha clamp
T_EPS = 1e-4              # front-to-back early-termination threshold


def composite_reference(
    mean2d: torch.Tensor,      # (N, 2)
    conic: torch.Tensor,       # (N, 3)
    depth: torch.Tensor,       # (N,)
    radius: torch.Tensor,      # (N,) int32, 0 = culled
    opacity: torch.Tensor,     # (N,)
    channels: torch.Tensor,    # (N, C) values to blend (premultiplied output)
    height: int,
    width: int,
    subpixel_offset: torch.Tensor | None = None,  # (H, W, 2)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depth-sorted front-to-back alpha blend at every pixel.

    Returns (out (H, W, C) premultiplied channels, T_final (H, W)).
    """
    valid = radius > 0
    inf = torch.full_like(depth, float("inf"))
    order = torch.argsort(torch.where(valid, depth, inf).detach(), stable=True)
    m = mean2d[order]
    con = conic[order]
    op = opacity[order]
    ch = channels[order]
    v = valid[order]

    dev = mean2d.device
    py, px = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    if subpixel_offset is not None:
        px = px + subpixel_offset[..., 0]
        py = py + subpixel_offset[..., 1]

    dx = px[:, :, None] - m[None, None, :, 0]            # (H, W, N)
    dy = py[:, :, None] - m[None, None, :, 1]
    power = (-0.5 * (con[:, 0] * dx * dx + con[:, 2] * dy * dy)
             - con[:, 1] * dx * dy)
    alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
    use = v & (power <= 0.0) & (alpha >= ALPHA_EPS)
    alpha = torch.where(use, alpha, torch.zeros_like(alpha))

    one_minus = 1.0 - alpha
    t_after = torch.cumprod(one_minus, dim=-1)           # T after compositing i
    t_before = torch.cat([torch.ones_like(t_after[..., :1]), t_after[..., :-1]], dim=-1)
    keep = t_after >= T_EPS                               # prefix property
    w = torch.where(keep, alpha * t_before, torch.zeros_like(alpha))
    out = torch.einsum("hwn,nc->hwc", w, ch)
    t_final = torch.prod(torch.where(keep, one_minus, torch.ones_like(one_minus)), dim=-1)
    return out, t_final
