"""Adam with per-field learning rates, updating the state in place.

Port of ``skyfall_gs_tpu/model/optim.py`` (torch-Adam semantics with
eps = 1e-15, one group per parameter field, the scheduled xyz LR, the
appearance groups).  Written by hand rather than ``torch.optim`` so the
moments are dataclasses with exactly the parameter fields: densification
writes zeros into moment slots with the same masked writes it applies to
parameters, and capacity growth pads them the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianParams,
    field_names,
    flat_fields,
    map_fields,
    map_leaf,
)


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
        grads: gradients, one tensor per parameter leaf (``appearance_mlp``
            a nested dict like the parameters').
        lr_tree: float learning rate per leaf (0 freezes the leaf).
        weight_decay_tree: optional float L2 coefficient per leaf, added to
            the gradient before the moments (torch-Adam style).
    """
    state.count += 1
    b1, b2, eps = hyper.b1, hyper.b2, hyper.eps
    c1 = 1.0 - b1 ** state.count
    c2 = 1.0 - b2 ** state.count
    wds = (dict(flat_fields(weight_decay_tree)) if weight_decay_tree is not None
           else {})
    for (path, p), (_, g), (_, mu), (_, nu), (_, lr) in zip(
            flat_fields(params), flat_fields(grads), flat_fields(state.mu),
            flat_fields(state.nu), flat_fields(lr_tree)):
        wd = wds.get(path, 0.0)
        if wd:
            g = g + wd * p
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = torch.sqrt(nu / c2).add_(eps)
        p.addcdiv_(mu, denom, value=-lr / c1)


def _per_field(params: GaussianParams, values: dict) -> GaussianParams:
    """A tree shaped like ``params`` whose leaves under field ``k`` are all
    ``values[k]`` (absent fields stay ``None``)."""
    return GaussianParams(**{k: map_leaf(lambda _, v=values[k]: v, getattr(params, k))
                             for k in field_names(GaussianParams)})


def make_lr_tree(params: GaussianParams, opt_cfg, xyz_lr: float) -> GaussianParams:
    """Per-leaf LRs: xyz scheduled (``xyz_lr`` already includes the spatial
    LR scale), f_rest = feature_lr / 20, plus the appearance groups where
    ``params`` has them."""
    return _per_field(params, dict(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
        embeddings=opt_cfg.embedding_lr,
        appearance_embeddings=opt_cfg.appearance_embedding_lr,
        appearance_mlp=opt_cfg.appearance_mlp_lr,
    ))


def make_weight_decay_tree(params: GaussianParams, opt_cfg) -> GaussianParams:
    """Only the per-camera appearance embeddings get L2 regularization."""
    values = dict.fromkeys(field_names(GaussianParams), 0.0)
    values["appearance_embeddings"] = opt_cfg.appearance_embedding_regularization
    return _per_field(params, values)
