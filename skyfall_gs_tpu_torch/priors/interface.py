"""Generative-prior interfaces: diffusion refiners and monocular depth.

Port of ``skyfall_gs_tpu/priors/interface.py``.  Stage 2 (IDU) refines
orbit renders into pseudo ground truth with a refiner and predicts their
depth with a depth predictor; both are pluggable backends in two
registries.  The backends that need pretrained weights (``flowedit`` on
FLUX, ``moge``) are built only from weights the caller hands over (a local
checkpoint path, modules or state dicts) and raise ``RuntimeError`` saying
what to pass when given none: they never fall back to the identity refiner
or the render depth predictor.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Protocol

import numpy as np


class Refiner(Protocol):
    """Turns rendered RGB frames into refined pseudo-ground-truth frames."""

    def run(self, images: List[np.ndarray], **kwargs) -> List[np.ndarray]:
        """images: list of (H, W, 3) float32 in [0, 1]; returns the same."""
        ...


class DepthPredictor(Protocol):
    """Predicts (relative) depth for RGB frames."""

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: (H, W, 3) float32 in [0, 1] -> depth (H, W) float32."""
        ...

    def run(self, images: List[np.ndarray]) -> List[np.ndarray]:
        ...


class IdentityRefiner:
    """No-op refine backend (the reference's ``refine=False`` path)."""

    def __init__(self, save_path: Optional[str] = None, **_):
        self.save_path = save_path

    def run(self, images: List[np.ndarray], **kwargs) -> List[np.ndarray]:
        return list(images)


class RenderDepthPredictor:
    """Stand-in depth backend without weights: the frame's mean over its
    channels (a luminance proxy), which keeps the IDU data path and the
    Pearson depth loss numerically alive."""

    def __init__(self, **_):
        pass

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return image.mean(axis=-1).astype(np.float32)

    def run(self, images: List[np.ndarray]) -> List[np.ndarray]:
        return [self(img) for img in images]


def _flowedit_factory(**kwargs):
    # The FLUX-backed refiner when weights (a checkpoint directory, modules
    # or state dicts) are given; else the raw refiner, which needs an
    # injected velocity field and raises without one.
    if any(k in kwargs for k in ("checkpoint_path", "transformer", "vae")):
        from skyfall_gs_tpu_torch.priors.flux_refiner import build_flux_refiner

        return build_flux_refiner(**kwargs)
    from skyfall_gs_tpu_torch.priors.flowedit import FlowEditRefiner

    return FlowEditRefiner(**kwargs)


def _moge_factory(**kwargs):
    from skyfall_gs_tpu_torch.priors.moge import MoGePredictor

    return MoGePredictor(**kwargs)


REFINER_REGISTRY: Dict[str, Callable] = {
    "identity": IdentityRefiner,
    "none": IdentityRefiner,
    "flowedit": _flowedit_factory,
}

DEPTH_REGISTRY: Dict[str, Callable] = {
    "render": RenderDepthPredictor,
    "luminance": RenderDepthPredictor,
    "moge": _moge_factory,
}


def get_refiner(name: str, **kwargs) -> Refiner:
    if name not in REFINER_REGISTRY:
        raise KeyError(f"unknown refiner '{name}'; have {list(REFINER_REGISTRY)}")
    return REFINER_REGISTRY[name](**kwargs)


def get_depth_predictor(name: str, **kwargs) -> DepthPredictor:
    if name not in DEPTH_REGISTRY:
        raise KeyError(f"unknown depth predictor '{name}'; have {list(DEPTH_REGISTRY)}")
    return DEPTH_REGISTRY[name](**kwargs)
