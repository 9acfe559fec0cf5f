"""Training losses and in-loop metrics.

Port of ``skyfall_gs_tpu/ops/losses.py``: L1, PSNR, Pearson depth loss,
opacity binary entropy and the (1 - l) L1 + l (1 - SSIM) photometric loss.
"""

from __future__ import annotations

import torch

from skyfall_gs_tpu_torch.ops.ssim import ssim


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))


def pearson_corr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of two flattened signals."""
    x = x.reshape(-1)
    y = y.reshape(-1)
    xm = x - torch.mean(x)
    ym = y - torch.mean(y)
    num = torch.sum(xm * ym)
    # eps inside the sqrt keeps the gradient finite for a constant signal.
    den = torch.sqrt(torch.sum(xm * xm) * torch.sum(ym * ym) + 1e-12)
    return num / den


def depth_pearson_loss(gt_depth: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Scale-invariant depth supervision: 1 - Pearson(gt, pred), with
    NaN/Inf scrubbed to 0."""
    bad = ~torch.isfinite(depth) | ~torch.isfinite(gt_depth)
    depth = torch.where(bad, 0.0, depth)
    gt_depth = torch.where(bad, 0.0, gt_depth)
    return 1.0 - pearson_corr(gt_depth, depth)


def _binary_entropy(opacity: torch.Tensor) -> torch.Tensor:
    o = torch.clamp(opacity.reshape(-1), 1.0e-3, 1.0 - 1.0e-3)
    return -(o * torch.log(o) + (1.0 - o) * torch.log(1.0 - o))


def opacity_entropy_sum(opacity: torch.Tensor, alive: torch.Tensor):
    """``(sum over alive entries of the binary entropy, alive count)``: the
    two terms of :func:`opacity_entropy_loss`'s mean."""
    alive = alive.reshape(-1)
    return torch.sum(torch.where(alive, _binary_entropy(opacity), 0.0)), torch.sum(alive)


def opacity_entropy_loss(opacity: torch.Tensor,
                         alive: torch.Tensor | None = None) -> torch.Tensor:
    """Binary entropy of the opacities (clamped to [1e-3, 1 - 1e-3]); with
    padded state only alive entries count toward the mean."""
    if alive is None:
        return torch.mean(_binary_entropy(opacity))
    total, n = opacity_entropy_sum(opacity, alive)
    return total / torch.clamp_min(n, 1)


def photometric_loss(image: torch.Tensor, gt_image: torch.Tensor,
                     lambda_dssim: float = 0.2) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - l) * L1 + l * (1 - SSIM) on (C, H, W) images.

    Returns (loss, l1_value).
    """
    ll1 = l1_loss(image, gt_image)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt_image)), ll1
