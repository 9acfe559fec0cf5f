"""Generative priors of Stage 2: the FLUX FlowEdit refiner and the MoGe
monocular depth predictor, behind the registries of ``interface``."""

from skyfall_gs_tpu_torch.priors.interface import (
    DEPTH_REGISTRY,
    REFINER_REGISTRY,
    DepthPredictor,
    IdentityRefiner,
    Refiner,
    RenderDepthPredictor,
    get_depth_predictor,
    get_refiner,
)

__all__ = [
    "DepthPredictor",
    "Refiner",
    "IdentityRefiner",
    "RenderDepthPredictor",
    "get_refiner",
    "get_depth_predictor",
    "REFINER_REGISTRY",
    "DEPTH_REGISTRY",
]
