"""The program's side of the splatting cells: its state and cameras built
from the benchmark's draws (``frozen/scene.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ref_splat import leaves


def program_state(cfg: dict, splats: dict, device):
    """A ``GaussianModelState`` holding copies of ``splats`` (every slot
    alive, the 3D filter still zero), as a checkpoint past densification
    would restore it."""
    from skyfall_gs_tpu_torch.model.appearance import AppearanceConfig
    from skyfall_gs_tpu_torch.model.gaussians import (
        GaussianAux, GaussianModelState, GaussianParams)

    app = cfg["appearance"]
    params = GaussianParams(**{k: ({n: {kk: t.clone() for kk, t in layer.items()}
                                    for n, layer in v.items()} if isinstance(v, dict)
                                   else v.clone()) for k, v in splats.items()})
    n = params.capacity

    def zeros():
        return torch.zeros(n, dtype=torch.float32, device=device)

    aux = GaussianAux(alive=torch.ones(n, dtype=torch.bool, device=device), filter_3d=zeros(),
                      max_radii2d=zeros(), grad_accum=zeros(), grad_accum_abs=zeros(),
                      grad_accum_abs_max=zeros(), denom=zeros())
    deg = int(cfg["sh_degree"])
    return GaussianModelState(
        params=params, aux=aux, active_sh_degree=deg, max_sh_degree=deg,
        appearance=AppearanceConfig(True, int(app["n_fourier_freqs"]),
                                    int(app["embedding_dim"]), int(app["hidden"])),
        spatial_lr_scale=float(cfg["spatial_lr_scale"]))


def flat_leaves(params) -> dict:
    """``name -> tensor`` of a ``GaussianParams`` (names as ``ref_splat.leaves``)."""
    return dict(leaves({f.name: getattr(params, f.name) for f in dataclasses.fields(params)
                        if getattr(params, f.name) is not None}))
