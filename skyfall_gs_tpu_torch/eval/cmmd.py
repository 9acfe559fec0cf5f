"""CMMD: CLIP Maximum Mean Discrepancy.

Port of ``skyfall_gs_tpu/eval/cmmd.py`` (reference cmmd_pytorch/): the
RBF-kernel MMD with sigma = 10 and the human-readable scale 1000
(distance.py:22-64; Eq. (5) of Gretton et al. 2012), in float32 torch,
over CLIP ViT-L/14-336 image embeddings (embedding.py:22-71).

``ClipEmbedder`` runs transformers' CLIP vision tower with projection.  It
reads ``model_name`` from the local Hugging Face cache only (no download;
a missing copy raises ``RuntimeError``), or takes an already built
``model`` and ``processor``.  Any callable mapping images to (N, D)
embeddings can stand in for it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

_SIGMA = 10.0
_SCALE = 1000.0
_CLIP_MODEL = "openai/clip-vit-large-patch14-336"


def mmd(x, y) -> torch.Tensor:
    """Biased/minimum-variance MMD^2 estimate with an RBF kernel, x1000,
    in float32 on ``x``'s device (``x`` and ``y``: (N, D) arrays or
    tensors)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    gamma = 1.0 / (2.0 * _SIGMA ** 2)
    x_sq = torch.sum(x * x, dim=1)
    y_sq = torch.sum(y * y, dim=1)

    def kmean(a, b, a_sq, b_sq):
        d2 = -2.0 * (a @ b.T) + a_sq[:, None] + b_sq[None, :]
        return torch.mean(torch.exp(-gamma * d2))

    return _SCALE * (kmean(x, x, x_sq, x_sq) + kmean(y, y, y_sq, y_sq)
                     - 2.0 * kmean(x, y, x_sq, y_sq))


class ClipEmbedder:
    """CLIP ViT-L/14-336 image embeddings through transformers.

    Args:
        model_name: a local Hugging Face model directory or a cached hub
            name, read for whichever of ``model`` / ``processor`` is None.
        device: where the model runs (default the card).
        model: a built ``CLIPVisionModelWithProjection``.
        processor: a built ``CLIPImageProcessor``.
    """

    def __init__(self, model_name: str = _CLIP_MODEL, device="cuda", model=None,
                 processor=None):
        try:
            from transformers import CLIPImageProcessor, CLIPVisionModelWithProjection
        except ImportError as e:
            raise RuntimeError(f"transformers unavailable: {e}") from e
        try:
            if processor is None:
                processor = CLIPImageProcessor.from_pretrained(model_name,
                                                               local_files_only=True)
            if model is None:
                model = CLIPVisionModelWithProjection.from_pretrained(
                    model_name, local_files_only=True)
        except OSError as e:
            raise RuntimeError(
                f"CLIP weights for {model_name} are not available locally (no download): "
                f"{e}. Pass model= and processor=, or a custom embed_fn to compute_cmmd.") \
                from e
        self.device = torch.device(device)
        self.processor = processor
        self.model = model.eval().to(self.device)

    def __call__(self, images: Sequence[np.ndarray], batch_size: int = 32) -> np.ndarray:
        """(H, W, 3) float [0, 1] images -> (N, D) unit-norm embeddings."""
        embs = []
        for i in range(0, len(images), batch_size):
            batch = [np.clip(im * 255, 0, 255).astype(np.uint8)
                     for im in images[i:i + batch_size]]
            inputs = self.processor(images=batch, return_tensors="pt")
            with torch.no_grad():
                out = self.model(pixel_values=inputs["pixel_values"].to(self.device))
            e = out.image_embeds
            e = e / e.norm(dim=-1, keepdim=True)
            embs.append(e.cpu().numpy())
        return np.concatenate(embs, axis=0)


def compute_cmmd(ref_images: Sequence[np.ndarray], eval_images: Sequence[np.ndarray],
                 embed_fn: Optional[Callable] = None, device="cuda") -> float:
    """CMMD between two image sets ((H, W, 3) float [0, 1] each)."""
    if embed_fn is None:
        embed_fn = ClipEmbedder(device=device)
    x = embed_fn(ref_images)
    y = embed_fn(eval_images)
    return float(mmd(torch.as_tensor(x, device=device), y))
