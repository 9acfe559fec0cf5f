"""Small numeric utilities.

Port of the part of ``skyfall_gs_tpu/utils/general.py`` that the Stage-1
step uses.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x):
    """Logit: inverse of the sigmoid opacity activation (tensor or float)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.log(x / (1.0 - x))
