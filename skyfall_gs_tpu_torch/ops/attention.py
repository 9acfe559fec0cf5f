"""Softmax attention for FLUX and MoGe, and which version runs.

``attention(q, k, v)`` is the plain version: softmax(q k^T / sqrt(hd)) v
for (B, H, L, hd) inputs returned as (B, L, H * hd), scores and softmax in
float32.  MoGe's ViT calls it directly (float32, head width 64).

``fused_attention(q, k, v)``, the wrapper of ``csrc/attention.cu``,
computes the same in one launch for every image and head, the score matrix
never leaving the SM (the kernel's source note says how and why).  It
replaces no TPU kernel: the JAX package's ``_attention`` is plain XLA.

``block_attention(q, k, v)`` is what FLUX's blocks call.  The two routing
rules:

- by dtype, in ``block_attention``: bf16 activations (the production
  dtype) go to ``fused_attention``, float32 ones (the parity models) to
  ``attention``;
- by device, in ``fused_attention``: for CPU tensors it runs ``attention``;
  for CUDA tensors it launches the kernel or raises: the kernel takes bf16
with head width 128 (FLUX.1's), q, k and v of one shape with unit stride in
the last dimension, the other strides multiples of 8 elements (TMA reads
them, so a transposed view needs no copy) and the data 16-byte aligned.
Span ``flux.attention`` covers each ``block_attention`` call and counter
``flux.attention.kernel`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from skyfall_gs_tpu_torch.ops import cuda_lib
from skyfall_gs_tpu_torch.utils.trace import count, span

HEAD_DIM = 128

LIBRARY = cuda_lib.Library(
    Path(__file__).resolve().parents[1] / "csrc" / "attention.cu",
    skyfall_flash_attention=[cuda_lib.ptr] * 4 + [cuda_lib.i32] * 3 + [cuda_lib.i64] * 9)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) each -> (B, L, H * hd).  Scores and softmax in float32,
    the weights times the values in ``v``'s dtype; one batch element at a
    time, so the float32 scores of only one image are live."""
    b, h, n, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(v)
    for i in range(b):
        s = torch.matmul(q[i].float(), k[i].float().transpose(-1, -2)) * scale
        out[i] = torch.matmul(torch.softmax(s, -1).to(v.dtype), v[i])
        del s
    return out.transpose(1, 2).reshape(b, n, h * hd)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape != q.shape
                or x.device != q.device or x.shape[-1] != HEAD_DIM):
            raise ValueError(
                f"{name}: expected bf16 (B, H, L, {HEAD_DIM}) of q's shape on {q.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel needs unit stride in the last dimension, the other "
                f"strides multiples of 8 and 16-byte aligned data; got strides {x.stride()}, "
                f"address {x.data_ptr():#x}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, L, hd) each -> (B, L, H * hd) in q's dtype."""
    if not q.is_cuda:
        return attention(q, k, v)
    _check(q, k, v)
    b, h, n, hd = q.shape
    out = torch.empty((b, n, h * hd), dtype=q.dtype, device=q.device)
    LIBRARY.launch("skyfall_flash_attention", q, k, v, out, b, h, n,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    return out


_ATTENTION = span("flux.attention")


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """FLUX's blocks' attention: ``fused_attention`` for bf16 activations,
    ``attention`` for float32 ones."""
    with _ATTENTION:
        if q.dtype != torch.bfloat16:
            return attention(q, k, v)
        launched = cuda_lib.launches["skyfall_flash_attention"]
        out = fused_attention(q, k, v)
        count("flux.attention.kernel", cuda_lib.launches["skyfall_flash_attention"] - launched)
        return out
