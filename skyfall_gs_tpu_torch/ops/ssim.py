"""Differentiable SSIM with an 11x11, sigma 1.5 Gaussian window.

Port of ``skyfall_gs_tpu/ops/ssim.py``: C1 = 0.01^2, C2 = 0.03^2, the
per-channel window applied as depthwise ``conv2d`` with 'same' zero
padding, mean over the output.  The 11x11 window is separable, so it runs
as an 11x1 and a 1x11 depthwise pass, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WINDOW = 11
_SIGMA = 1.5
_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _window_1d(device) -> torch.Tensor:
    # Built in float64 on the device (no host-to-device copy inside a step),
    # then rounded to float32 like the JAX package's numpy window.
    xs = torch.arange(_WINDOW, dtype=torch.float64, device=device) - _WINDOW // 2
    g = torch.exp(-(xs ** 2) / (2.0 * _SIGMA ** 2))
    return (g / g.sum()).to(torch.float32)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable depthwise 11x11 Gaussian blur on (B, C, H, W)."""
    c = x.shape[1]
    kh = w.view(1, 1, _WINDOW, 1).repeat(c, 1, 1, 1)
    kw = w.view(1, 1, 1, _WINDOW).repeat(c, 1, 1, 1)
    x = F.conv2d(x, kh, padding=(_WINDOW // 2, 0), groups=c)
    return F.conv2d(x, kw, padding=(0, _WINDOW // 2), groups=c)


def ssim(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Mean SSIM between two (C, H, W) or (B, C, H, W) images in [0, 1]."""
    if img0.dim() == 3:
        img0 = img0[None]
        img1 = img1[None]
    w = _window_1d(img0.device)
    mu0 = _blur(img0, w)
    mu1 = _blur(img1, w)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    s00 = _blur(img0 * img0, w) - mu00
    s11 = _blur(img1 * img1, w) - mu11
    s01 = _blur(img0 * img1, w) - mu01
    num = (2.0 * mu01 + _C1) * (2.0 * s01 + _C2)
    den = (mu00 + mu11 + _C1) * (s00 + s11 + _C2)
    return torch.mean(num / den)
