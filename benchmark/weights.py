"""Random weights for the priors, drawn on the device from a seed.

The rule is the program's random initialisation (``priors/flux.py``
``init_tensor_`` at commit a752ef2): every matrix N(0, std^2) (the
configuration's ``init_std``, 0.02 as the program draws), every bias 0,
every other vector (norm scales, LayerScale) 1.  The draws are made per
group of parameters (one transformer block, one VAE stage; ``group_of``),
one float32 call per group in sorted order, scaled and rounded to the dtype
the weights are served in.  So the program's bf16 FLUX and the reference's
float32 one (built with ``round_to=torch.bfloat16``) hold the same values,
whatever order the two modules declare their parameters in.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def group_of(name: str) -> str:
    """A parameter's draw group: its name up to the first numeric part."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return parts[0]


@torch.no_grad()
def fill_(module: nn.Module, seed: int, std: float,
          round_to: Optional[torch.dtype] = None) -> nn.Module:
    """Fill ``module``'s parameters in place from ``seed`` on their device;
    ``round_to`` rounds the draws through that dtype first (a float32 copy
    of a bf16-served model)."""
    params = dict(module.named_parameters())
    dev = next(iter(params.values())).device
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    groups: dict = {}
    for name in sorted(params):
        groups.setdefault(group_of(name), []).append(name)
    for grp in sorted(groups):
        mats = []
        for name in groups[grp]:
            p = params[name]
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                mats.append(p)
        if not mats:
            continue
        flat = torch.randn(sum(p.numel() for p in mats), generator=g, device=dev) * std
        at = 0
        for p in mats:
            v = flat[at:at + p.numel()].view(p.shape)
            if round_to is not None:
                v = v.to(round_to)
            p.copy_(v)
            at += p.numel()
        del flat
    return module


def build(cls, cfg, dtype: torch.dtype, device, seed: int, std: float,
          round_to: Optional[torch.dtype] = None) -> nn.Module:
    """``cls(cfg)`` allocated in ``dtype`` on ``device`` (built on the meta
    device) and filled from ``seed``, matrices N(0, std^2)."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to(dtype=dtype).to_empty(device=device).eval()
    return fill_(module, seed, std, round_to=round_to)
