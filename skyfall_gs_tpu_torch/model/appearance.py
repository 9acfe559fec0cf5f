"""Per-image appearance modeling (WildGaussians-style).

Port of ``skyfall_gs_tpu/model/appearance.py``.  Each Gaussian carries a
learned embedding initialized with Fourier position features; each training
camera carries an embedding; a small MLP maps (DC color, Gaussian embedding,
camera embedding) to a per-channel multiply and offset applied to the full
SH vector (the offset, scaled by 1/C0, on the DC coefficients only).

The MLP weights are plain tensors in the JAX package's layout,
``{"l0": {"w": (n_in, n_out), "b": (n_out,)}, "l1": ..., "l2": ...}`` with
``x @ w + b``, so the optimizer, the checkpoint and the exchange with the
JAX package treat them like every other parameter field.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.sh import SH_C0


class AppearanceConfig(NamedTuple):
    enabled: bool = False
    n_fourier_freqs: int = 4
    embedding_dim: int = 32
    hidden: int = 128

    @property
    def gaussian_embedding_dim(self) -> int:
        return 6 * self.n_fourier_freqs


def fourier_position_features(xyz: np.ndarray, num_freqs: int) -> np.ndarray:
    """Initialization features: sines of normalized positions at octave
    frequencies with 0 / pi/2 phase pairs -> (N, 6 * num_freqs)."""
    xyz = np.asarray(xyz, np.float32)
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    scale = np.quantile(np.abs(xyz), 0.97, axis=0)
    xyz = xyz / np.maximum(scale, 1e-8) * 0.5 + 0.5
    freqs = np.repeat(2.0 ** np.linspace(0, num_freqs - 1, num_freqs), 2)
    offsets = np.array([0.0, 0.5 * math.pi] * num_freqs, np.float32)
    feat = xyz[..., None] * freqs[None, None] * 2.0 * math.pi + offsets[None, None]
    return np.sin(feat).reshape(xyz.shape[0], -1).astype(np.float32)


def _linear_init(generator: torch.Generator, n_in: int, n_out: int) -> dict:
    """Uniform(-1/sqrt(n_in), 1/sqrt(n_in)) for weights and biases."""
    bound = 1.0 / math.sqrt(n_in)

    def uniform(*shape):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

    return {"w": uniform(n_in, n_out), "b": uniform(n_out)}


def init_appearance(generator: torch.Generator, cfg: AppearanceConfig,
                    num_cameras: int, device="cpu"):
    """Returns (mlp dict of tensors, camera embeddings (M, D)), drawn from
    ``generator`` (a CPU generator, so the weights do not depend on the
    device they are placed on)."""
    n_in = cfg.embedding_dim + 3 + cfg.gaussian_embedding_dim
    mlp = {
        "l0": _linear_init(generator, n_in, cfg.hidden),
        "l1": _linear_init(generator, cfg.hidden, cfg.hidden),
        "l2": _linear_init(generator, cfg.hidden, 6),
    }
    cam_emb = 0.01 * torch.randn((num_cameras, cfg.embedding_dim), generator=generator)
    mlp = {k: {kk: v.to(device) for kk, v in layer.items()} for k, layer in mlp.items()}
    return mlp, cam_emb.to(device)


def _mlp_apply(mlp: dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(x @ mlp["l0"]["w"] + mlp["l0"]["b"])
    x = torch.relu(x @ mlp["l1"]["w"] + mlp["l1"]["b"])
    return x @ mlp["l2"]["w"] + mlp["l2"]["b"]


def apply_appearance(
    mlp: dict,
    gaussian_embeddings: torch.Tensor,  # (N, 6F)
    camera_embedding: torch.Tensor,     # (D,) one camera's embedding
    features: torch.Tensor,             # (N, K, 3) SH coefficients
) -> torch.Tensor:
    """Tone the SH coefficients for one camera.  Returns (N, K, 3)."""
    n, k, _ = features.shape
    flat = torch.clamp_max(features.reshape(n, k * 3), 1.0)   # k-major [k0 rgb, ...]
    inp = torch.cat([flat[:, :3], gaussian_embeddings,
                     camera_embedding[None, :].expand(n, camera_embedding.shape[0])],
                    dim=-1)
    out = _mlp_apply(mlp, inp) * 0.01
    offset, mul = out[:, :3], out[:, 3:]
    offset_full = torch.cat([offset / SH_C0, flat.new_zeros((n, (k - 1) * 3))], dim=-1)
    toned = flat * mul.repeat(1, k) + offset_full
    return torch.clamp_max(toned, 1.0).reshape(n, k, 3)
