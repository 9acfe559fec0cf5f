"""FLUX-backed FlowEdit refiner: the transformer, the VAE and conditioning.

Port of ``skyfall_gs_tpu/priors/flux_refiner.py`` (the reference's
``FlowEditRefineIDU(model_type="FLUX")``): ``build_flux_refiner`` wires
``priors/flux.py``'s velocity field and ``priors/flux_vae.py``'s latents
into a ``FlowEditRefiner``.  Weights come from a local diffusers directory
(``transformer/`` and ``vae/`` of safetensors or torch files) or from the
caller as modules or diffusers-keyed state dicts; there is no download.
The prompt conditioning defaults to zero embeddings (a structure-keeping
edit), as in the JAX package; ``encode_prompts`` builds it from token ids
through ``priors/text_encoders.py``'s T5 and CLIP encoders.

The transformer runs in ``dtype`` (bf16 by default on CUDA: FLUX.1-dev is
about 23.8 GB in bf16 and fits one 80 GB card); the VAE runs in float32, as
in the JAX package.  With ``mesh`` (a ``parallel.mesh.ViewMesh``) the
transformer runs tensor-parallel over its ranks in ``dtype``
(``priors/flux_shard.py``): every rank builds the refiner, holds its shard
and the whole VAE, and calls ``run`` on the same frames; FlowEdit's noise
comes from ``seed`` on every rank, so every rank returns the same frames.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Union

import torch

from skyfall_gs_tpu_torch.priors.flowedit import FlowEditRefiner
from skyfall_gs_tpu_torch.priors.flux import (
    FluxConfig,
    FluxCond,
    FluxTransformer,
    build_module,
    latent_ids,
    pack_latents,
    shifted_sigmas,
    unpack_latents,
)
from skyfall_gs_tpu_torch.priors.flux_shard import ShardedFluxTransformer, shard_flux_params
from skyfall_gs_tpu_torch.priors.flux_vae import VAE, VAEConfig
from skyfall_gs_tpu_torch.priors.text_encoders import CLIPTextEncoder, T5Encoder


def _load_torch_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every *.safetensors / *.bin / *.pt / *.pth under ``path`` as one dict."""
    sd: Dict[str, torch.Tensor] = {}
    for root, _, files in os.walk(path):
        for f in sorted(files):
            fp = os.path.join(root, f)
            if f.endswith(".safetensors"):
                from safetensors.torch import load_file

                sd.update(load_file(fp))
            elif f.endswith((".bin", ".pt", ".pth")):
                obj = torch.load(fp, map_location="cpu", weights_only=True)
                sd.update(obj.get("state_dict", obj))
    if not sd:
        raise FileNotFoundError(f"no torch weights found under {path}")
    return sd


def default_conditioning(cfg: FluxConfig, generator: Optional[torch.Generator] = None,
                         guidance_src: float = 1.5, guidance_tar: float = 5.5,
                         txt_len: int = 64, device="cuda"):
    """Zero prompt embeddings for both branches (random N(0, 0.02^2) ones
    from ``generator`` for tests)."""
    shapes = ((1, txt_len, cfg.joint_dim), (1, cfg.pooled_dim))
    if generator is None:
        src = [torch.zeros(s, device=device) for s in shapes]
        tar = src
    else:
        src, tar = ([torch.randn(s, generator=generator, device=device) * 0.02
                     for s in shapes] for _ in range(2))
    return FluxCond(*src, guidance_src), FluxCond(*tar, guidance_tar)


def encode_prompts(src_ids_t5, tar_ids_t5, src_ids_clip, tar_ids_clip,
                   t5: T5Encoder, clip: CLIPTextEncoder,
                   guidance_src: float = 1.5, guidance_tar: float = 5.5):
    """(src_cond, tar_cond) from token ids: the T5 sequence features and
    the CLIP pooled embedding of each prompt, on the encoders' device and
    in their dtype.  ``*_ids_t5`` / ``*_ids_clip``: (1, L) token ids of the
    T5 and CLIP tokenizers (the vocabularies are not in the repository)."""
    src_txt, tar_txt = t5(src_ids_t5), t5(tar_ids_t5)
    _, src_pool = clip(src_ids_clip)
    _, tar_pool = clip(tar_ids_clip)
    return FluxCond(src_txt, src_pool, guidance_src), FluxCond(tar_txt, tar_pool, guidance_tar)


def _state(given, checkpoint_path, name):
    """``given`` (a module or a state dict of diffusers keys), else the
    weights under ``checkpoint_path/name`` (or ``checkpoint_path`` itself
    when it has no such subdirectory)."""
    if given is not None:
        return given
    sub = os.path.join(checkpoint_path, name)
    return _load_torch_dir(sub if os.path.isdir(sub) else checkpoint_path)


def _module(cls, cfg, given, dtype, device):
    """``given`` (a module or a state dict) as a ``cls`` in ``dtype`` on
    ``device``."""
    if isinstance(given, torch.nn.Module):
        return given.to(device=device, dtype=dtype).eval()
    module = build_module(cls, cfg, dtype=dtype, device=device, seed=None)
    module.load_state_dict(given, strict=True)
    return module


def _sharded(given, mesh, cfg, dtype) -> ShardedFluxTransformer:
    """``given`` sharded over ``mesh`` (a ``ShardedFluxTransformer`` of that
    mesh is taken as it is)."""
    if isinstance(given, ShardedFluxTransformer):
        if given.mesh.size != mesh.size or given.mesh.rank != mesh.rank:
            raise ValueError(f"the transformer is rank {given.mesh.rank} of "
                             f"{given.mesh.size}, the mesh rank {mesh.rank} of {mesh.size}")
        return given.eval()
    return shard_flux_params(given, mesh, cfg, dtype=dtype).eval()


def build_flux_refiner(
    checkpoint_path: Optional[str] = None,
    transformer: Union[FluxTransformer, Dict[str, torch.Tensor], None] = None,
    vae: Union[VAE, Dict[str, torch.Tensor], None] = None,
    src_cond: Optional[FluxCond] = None,
    tar_cond: Optional[FluxCond] = None,
    cfg: FluxConfig = FluxConfig(),
    vae_cfg: VAEConfig = VAEConfig(),
    num_steps: int = 28,
    save_path: Optional[str] = None,
    batch_size: int = 8,
    seed: int = 0,
    device="cuda",
    dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> FlowEditRefiner:
    """Construct the FLUX FlowEdit refine backend.

    Args:
        checkpoint_path: a diffusers pipeline directory (``transformer/``
            and ``vae/``) or one flat directory of torch weights; read for
            whichever of ``transformer`` / ``vae`` is not given.
        transformer / vae: modules, or state dicts under diffusers' names
            (with ``mesh``, the transformer may also be this rank's
            ``ShardedFluxTransformer``, e.g. from ``build_sharded_flux``).
        src_cond / tar_cond: prompt conditioning; zero embeddings if None.
        device: where the modules run (default the card; ``mesh.device``
            with a mesh).
        dtype: the transformer's dtype; default bf16 on CUDA, else float32.
        mesh: a ``parallel.mesh.ViewMesh``: the transformer runs
            tensor-parallel over its ranks (the refiner's ``mesh``); every
            rank builds the refiner and calls ``run`` alike.
    """
    device = torch.device(device if mesh is None else mesh.device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if (transformer is None or vae is None) and checkpoint_path is None:
        raise RuntimeError(
            "No FLUX weights were given. Pass checkpoint_path=<local diffusers FLUX "
            "directory> or transformer= and vae= (modules or diffusers-keyed state "
            "dicts).")
    transformer = _state(transformer, checkpoint_path, "transformer")
    if mesh is None:
        transformer = _module(FluxTransformer, cfg, transformer, dtype, device)
    else:
        transformer = _sharded(transformer, mesh, cfg, dtype)
    vae = _module(VAE, vae_cfg, _state(vae, checkpoint_path, "vae"), torch.float32, device)
    if src_cond is None or tar_cond is None:
        d_src, d_tar = default_conditioning(cfg, device=device)
        src_cond, tar_cond = src_cond or d_src, tar_cond or d_tar
    factor = 2 ** (len(vae_cfg.ch_mult) - 1)

    # One (encode, decode, velocity) triple per image shape: each holds its
    # own latent grid and RoPE ids (two aspect ratios can share a token count).
    @functools.lru_cache(maxsize=None)
    def shape_fns(height: int, width: int):
        lh, lw = height // factor, width // factor
        ids = latent_ids(lh, lw, device=device)

        def encode_fn(imgs: torch.Tensor) -> torch.Tensor:
            """(B, H, W, 3) in [0, 1] -> (B, L, 4 * latent_ch) tokens."""
            return pack_latents(vae.encode(imgs * 2.0 - 1.0))[0]

        def decode_fn(tok: torch.Tensor) -> torch.Tensor:
            img = vae.decode(unpack_latents(tok, lh, lw))
            return torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)

        def velocity_fn(tok: torch.Tensor, t, cond: FluxCond) -> torch.Tensor:
            return transformer(tok, ids, cond, t)

        return encode_fn, decode_fn, velocity_fn

    # The resolution-shifted sigma grid of each shape's token count.
    @functools.lru_cache(maxsize=None)
    def sigmas_fn(height: int, width: int):
        return shifted_sigmas(num_steps, (height // (2 * factor)) * (width // (2 * factor)))

    refiner = FlowEditRefiner(save_path=save_path, model_type="FLUX", shape_fns=shape_fns,
                              src_cond=src_cond, tar_cond=tar_cond, num_steps=num_steps,
                              seed=seed, batch_size=batch_size, sigmas_fn=sigmas_fn,
                              device=device)
    refiner.transformer, refiner.vae, refiner.mesh = transformer, vae, mesh
    return refiner
