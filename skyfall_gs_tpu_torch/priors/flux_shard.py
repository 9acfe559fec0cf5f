"""Tensor-parallel FLUX: the velocity field split over the ranks of a mesh.

Port of ``skyfall_gs_tpu/priors/flux_shard.py`` (Megatron-style tensor
parallelism over a ``tp`` mesh axis).  JAX runs it as one ``shard_map``
from a single controller; here every rank of a ``parallel.mesh.ViewMesh``
runs the same program on its own shard of the weights (SPMD), with the
same tokens, ``t`` and conditioning, and every rank returns the same
velocity bits:

  * column-parallel (a rank holds output rows ``[r n / tp, (r + 1) n / tp)``
    of the ``(out, in)`` weight and that slice of the bias): the AdaLN
    modulations (``norm1.linear``, ``norm1_context.linear``, the single
    blocks' ``norm.linear``; their outputs all-gathered in rank order), q /
    k / v of both streams (whole heads per rank: ``heads / tp`` of them),
    ``ff.net.0.proj``, ``ff_context.net.0.proj`` and ``proj_mlp``;
  * row-parallel (a rank holds input columns; the bias is whole and added
    once, after the partial products are all-reduced in the activation
    dtype): ``attn.to_out.0``, ``attn.to_add_out``, ``ff.net.2``,
    ``ff_context.net.2``, and each single block's fused ``proj_out``,
    whose shard is the rank's columns of its attention half ``[:, :d]``
    followed by those of its MLP half ``[:, d:]``;
  * replicated: the embedders, the RMS-norm scales, ``norm_out`` and the
    final ``proj_out``.

The blocks themselves are ``priors/flux.py``'s, built with the mesh; a
state dict keeps diffusers' key names, each tensor holding its rank's
shard.  Every collective goes through the mesh, so ``mesh.traffic`` counts
them: per evaluation 6 per double block (2 modulation all-gathers, 4
all-reduces) and 2 per single block.  On one card the only two-rank route
is gloo, which stages every collective through the host.

Weights enter as a whole module or state dict (:func:`shard_flux_params`;
the JAX package's parameters through ``flux.state_from_numpy``), or are
drawn from a seed shard by shard (:func:`build_sharded_flux`), equal to
the slices of ``flux.build_module(FluxTransformer, cfg, dtype, device,
seed)`` without ever holding the whole model.
"""

from __future__ import annotations

import functools
import re
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from skyfall_gs_tpu_torch.parallel.mesh import ViewMesh
from skyfall_gs_tpu_torch.priors.flux import (
    FluxConfig,
    FluxCond,
    FluxTransformer,
    build_module,
    init_tensor_,
)

COLUMN_LAYERS = frozenset((
    "norm1.linear", "norm1_context.linear", "norm.linear",
    "attn.to_q", "attn.to_k", "attn.to_v",
    "attn.add_q_proj", "attn.add_k_proj", "attn.add_v_proj",
    "ff.net.0.proj", "ff_context.net.0.proj", "proj_mlp"))
ROW_LAYERS = frozenset(("attn.to_out.0", "attn.to_add_out", "ff.net.2", "ff_context.net.2"))
_BLOCK_KEY = re.compile(r"(single_)?transformer_blocks\.\d+\.(.+)\.(weight|bias)$")


def count_flux_params(cfg: FluxConfig = FluxConfig()):
    """(total_params, sharded_params, replicated_params): the memory budget."""
    d, hd, mlp = cfg.hidden, cfg.head_dim, int(cfg.hidden * cfg.mlp_ratio)
    lin = lambda n_in, n_out: n_in * n_out + n_out          # noqa: E731
    dbl = (2 * lin(d, 6 * d)            # img/txt AdaLN modulation
           + 6 * lin(d, d) + 4 * hd     # q/k/v (both streams) + q/k norms
           + 2 * lin(d, d)              # img_out, txt_out
           + 2 * (lin(d, mlp) + lin(mlp, d)))   # img/txt MLPs
    sgl = (lin(d, 3 * d) + 3 * lin(d, d) + 2 * hd
           + lin(d, mlp) + lin(d + mlp, d))
    sharded = cfg.depth_double * dbl + cfg.depth_single * sgl
    mlp2 = lambda n_in: lin(n_in, d) + lin(d, d)            # noqa: E731
    rep = (lin(cfg.in_channels, d) + lin(cfg.joint_dim, d)
           + mlp2(cfg.time_freq_dim) + mlp2(cfg.pooled_dim)
           + (mlp2(cfg.time_freq_dim) if cfg.guidance else 0)
           + lin(d, 2 * d) + lin(d, cfg.in_channels))
    return sharded + rep, sharded, rep


def check_tp(cfg: FluxConfig, tp: int) -> None:
    """``ValueError`` unless ``tp`` ranks split the heads and the MLP width
    evenly."""
    mlp = int(cfg.hidden * cfg.mlp_ratio)
    if cfg.heads % tp or mlp % tp:
        raise ValueError(f"tp={tp} must divide heads={cfg.heads} and the MLP width {mlp}")


def shard_tensor(key: str, t: torch.Tensor, rank: int, tp: int, cfg: FluxConfig) -> torch.Tensor:
    """Rank ``rank``'s shard of the whole tensor ``t`` under the state-dict
    key ``key`` (``t`` itself where the key is replicated; a contiguous copy
    otherwise, so the whole tensor can be freed)."""
    m = _BLOCK_KEY.match(key)
    if m is None:
        return t
    single, layer, kind = m.groups()
    if layer in COLUMN_LAYERS:
        part = t.chunk(tp, 0)[rank]
    elif layer in ROW_LAYERS or (single and layer == "proj_out"):
        if kind == "bias":
            return t
        if layer == "proj_out":
            d = cfg.hidden
            part = torch.cat([t[:, :d].chunk(tp, 1)[rank], t[:, d:].chunk(tp, 1)[rank]], 1)
        else:
            part = t.chunk(tp, 1)[rank]
    else:
        return t                     # the per-head RMS-norm scales
    return part.clone(memory_format=torch.contiguous_format)


def shard_flux_state(state_dict: Dict[str, torch.Tensor], rank: int, tp: int,
                     cfg: FluxConfig) -> Dict[str, torch.Tensor]:
    """The ``ShardedFluxTransformer`` state dict of rank ``rank`` of ``tp``
    from a whole ``FluxTransformer`` state dict (pure slicing)."""
    check_tp(cfg, tp)
    return {k: shard_tensor(k, v, rank, tp, cfg) for k, v in state_dict.items()}


class ShardedFluxTransformer(FluxTransformer):
    """One rank's shard of the FLUX.1 velocity field over ``mesh``: the
    ``FluxTransformer.forward(img_tokens, img_ids, cond, t)`` contract, the
    same (B, L, in_channels) float32 velocity on every rank.  Activations
    run in the parameters' dtype (norm statistics, RoPE, scores and softmax
    in float32, as ``FluxTransformer``); row-parallel partial products are
    all-reduced in that dtype."""

    def __init__(self, cfg: FluxConfig, mesh: ViewMesh):
        check_tp(cfg, mesh.size)
        super().__init__(cfg, mesh=mesh)
        self.mesh = mesh


def _sharded_module(cfg: FluxConfig, mesh: ViewMesh, dtype) -> ShardedFluxTransformer:
    return build_module(functools.partial(ShardedFluxTransformer, mesh=mesh), cfg, dtype=dtype,
                        device=mesh.device, seed=None)


@torch.no_grad()
def shard_flux_params(transformer_or_state: Union[nn.Module, Dict[str, torch.Tensor]],
                      mesh: ViewMesh, cfg: FluxConfig,
                      dtype: Optional[torch.dtype] = torch.bfloat16) -> ShardedFluxTransformer:
    """This rank's ``ShardedFluxTransformer`` on ``mesh.device`` from a
    whole ``FluxTransformer`` or its state dict (diffusers keys), cast to
    ``dtype`` (None keeps the weights' own)."""
    sd = (transformer_or_state.state_dict() if isinstance(transformer_or_state, nn.Module)
          else transformer_or_state)
    if dtype is None:
        dtype = next(iter(sd.values())).dtype
    module = _sharded_module(cfg, mesh, dtype)
    module.load_state_dict(shard_flux_state(sd, mesh.rank, mesh.size, cfg), strict=True)
    return module


@torch.no_grad()
def build_sharded_flux(cfg: FluxConfig, mesh: ViewMesh, dtype=torch.bfloat16,
                       seed: int = 0) -> ShardedFluxTransformer:
    """This rank's shard of exactly the weights ``build_module(
    FluxTransformer, cfg, dtype, device, seed)`` draws: each whole tensor
    is drawn in turn from one seeded generator on the rank's device, sliced
    and freed, so the peak is the shard plus the largest single tensor."""
    module = _sharded_module(cfg, mesh, dtype)
    local = dict(module.named_parameters())
    with torch.device("meta"):
        whole = FluxTransformer(cfg)
    gens: Dict[torch.device, torch.Generator] = {}
    for name, p in whole.named_parameters():
        t = torch.empty(p.shape, dtype=dtype, device=mesh.device)
        init_tensor_(name, t, gens, seed)
        local[name].copy_(shard_tensor(name, t, mesh.rank, mesh.size, cfg))
        del t
    return module


def make_sharded_flux_velocity(mesh: ViewMesh, cfg: FluxConfig) -> Callable:
    """The tensor-parallel ``v(module, img_tokens (B, L, C), img_ids (L, 3),
    cond, t)`` -> (B, L, C) float32, the same on every rank of ``mesh``;
    every rank calls it with the same inputs."""
    check_tp(cfg, mesh.size)

    def velocity(module: ShardedFluxTransformer, img_tokens: torch.Tensor,
                 img_ids: torch.Tensor, cond: FluxCond, t) -> torch.Tensor:
        return module(img_tokens.to(mesh.device), img_ids, cond, t)

    return velocity
