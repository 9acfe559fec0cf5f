"""Adam with per-field learning rates, updating the state in place.

Port of ``skyfall_gs_tpu/model/optim.py`` (torch-Adam semantics with
eps = 1e-15, one group per parameter field, the scheduled xyz LR).  Written
by hand rather than ``torch.optim`` so the moments are dataclasses with
exactly the parameter fields: densification writes zeros into moment slots
with the same masked writes it applies to parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from skyfall_gs_tpu_torch.model.gaussians import GaussianParams, field_names, map_fields


@dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    count: int = 0  # steps taken; a host int, so the update needs no sync


class AdamHyper(NamedTuple):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15


def adam_init(params: GaussianParams) -> AdamState:
    return AdamState(mu=map_fields(torch.zeros_like, params),
                     nu=map_fields(torch.zeros_like, params))


@torch.no_grad()
def adam_update(
    grads: GaussianParams,
    state: AdamState,
    params: GaussianParams,
    lr_tree: GaussianParams,
    hyper: AdamHyper = AdamHyper(),
    weight_decay_tree: Optional[GaussianParams] = None,
) -> None:
    """One Adam step, IN PLACE on ``params`` and ``state`` (the moments and
    parameters are the largest per-step buffers; updating them in place
    keeps one copy of each).

    Args:
        grads: gradients, one tensor per parameter field.
        lr_tree: float learning rate per field (0 freezes the field).
        weight_decay_tree: optional float L2 coefficient per field, added to
            the gradient before the moments (torch-Adam style).
    """
    state.count += 1
    b1, b2, eps = hyper.b1, hyper.b2, hyper.eps
    c1 = 1.0 - b1 ** state.count
    c2 = 1.0 - b2 ** state.count
    for k in field_names(GaussianParams):
        p, g = getattr(params, k), getattr(grads, k)
        mu, nu = getattr(state.mu, k), getattr(state.nu, k)
        wd = 0.0 if weight_decay_tree is None else getattr(weight_decay_tree, k)
        if wd:
            g = g + wd * p
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = torch.sqrt(nu / c2).add_(eps)
        p.addcdiv_(mu, denom, value=-getattr(lr_tree, k) / c1)


def make_lr_tree(opt_cfg, xyz_lr: float) -> GaussianParams:
    """Per-field LRs: xyz scheduled (``xyz_lr`` already includes the spatial
    LR scale), f_rest = feature_lr / 20."""
    return GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
    )


def make_weight_decay_tree(opt_cfg) -> GaussianParams:
    """Only the per-camera appearance embeddings get L2 regularization in
    the JAX package, and appearance is not ported: every field is 0."""
    del opt_cfg
    return GaussianParams(xyz=0.0, features_dc=0.0, features_rest=0.0,
                          scaling=0.0, rotation=0.0, opacity=0.0)
