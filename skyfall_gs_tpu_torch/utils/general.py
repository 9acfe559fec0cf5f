"""Small numeric utilities.

Port of ``skyfall_gs_tpu/utils/general.py``.  The learning-rate schedule
returns a host float computed in numpy float32 (the JAX version's float32
arithmetic), so the training step gets its LR without a device sync.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch


def inverse_sigmoid(x):
    """Logit: inverse of the sigmoid opacity activation (tensor or float)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.log(x / (1.0 - x))


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linearly interpolated learning-rate schedule with optional warmup.

    ``exp(lerp(log(lr_init), log(lr_final), t))`` with
    ``t = clip(step / max_steps, 0, 1)``, scaled during the first
    ``lr_delay_steps`` by a sine ramp from ``lr_delay_mult`` to 1.  Returns
    0 for ``step < 0`` or when both LRs are 0.  The callable maps a step to
    a Python float.
    """
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
        if lr_init <= 0.0 and lr_final <= 0.0:
            return 0.0
        log_lerp = np.exp(np.log(f32(max(lr_init, 1e-30))) * (f32(1.0) - t)
                          + np.log(f32(max(lr_final, 1e-30))) * t)
        if lr_delay_steps > 0:
            ramp = np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
            delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
                f32(0.5 * math.pi) * ramp)
        else:
            delay_rate = f32(1.0)
        return 0.0 if step < 0 else float(delay_rate * log_lerp)

    return schedule


def seed_everything(seed: int = 0) -> None:
    """Seed the host-side RNGs and PyTorch's default generators.  The port's
    own randomness takes explicit ``torch.Generator`` arguments."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
