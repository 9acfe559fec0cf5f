"""FLUX.1 rectified-flow transformer (MMDiT) as a PyTorch module.

Port of ``skyfall_gs_tpu/priors/flux.py``: 19 double-stream blocks
(separate image / text streams, joint attention, adaLN-Zero modulation
from the (timestep, guidance, pooled text) vector) and 38 single-stream
blocks (parallel attention + MLP over the joined sequence), 3-axis RoPE
over (text, y, x) token ids, per-head QK RMSNorm, and the latent <-> token
packing and the resolution-shifted sigma schedule the FlowEdit refiner
uses.

``FluxTransformer``'s ``state_dict`` keys are diffusers'
``FluxTransformer2DModel`` names, the schema the JAX package's
``convert_torch_state_dict`` reads, so a local diffusers checkpoint loads
with ``load_state_dict(strict=True)``.  ``state_from_numpy`` carries the
JAX package's parameter pytree into that state dict.

Precision: the module computes in its parameters' dtype (bf16 on the card
in production, fp32 for the parity tests).  LayerNorm and RMSNorm
statistics, RoPE, the attention scores and their softmax are float32;
the softmax weights multiply the values in the parameter dtype, as the JAX
package's ``_attention`` does.  The velocity comes back in float32.

Attention: the blocks call ``ops/attention.py``'s ``block_attention``,
which takes the fused kernel for bf16 activations on the card and the
plain ``attention`` otherwise (that module holds both routing rules).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyfall_gs_tpu_torch.ops.attention import block_attention


class FluxConfig(NamedTuple):
    """FluxTransformer2DModel hyperparameters (diffusers FLUX.1 defaults)."""

    in_channels: int = 64          # 16 VAE channels x 2x2 packing
    hidden: int = 3072             # heads * head_dim
    heads: int = 24
    head_dim: int = 128
    depth_double: int = 19
    depth_single: int = 38
    joint_dim: int = 4096          # T5-XXL feature width
    pooled_dim: int = 768          # CLIP-L pooled width
    axes_dim: tuple = (16, 56, 56)  # RoPE dims for (batch/text, y, x)
    theta: int = 10_000
    guidance: bool = True          # FLUX.1-dev; schnell has no guidance embedder
    mlp_ratio: float = 4.0
    time_freq_dim: int = 256

    @classmethod
    def tiny(cls):
        """Reduced width for the tests (same topology)."""
        return cls(in_channels=16, hidden=64, heads=2, head_dim=32,
                   depth_double=2, depth_single=2, joint_dim=32,
                   pooled_dim=16, axes_dim=(8, 12, 12), time_freq_dim=32)


class FluxCond(NamedTuple):
    """Conditioning of one prompt."""

    txt: torch.Tensor       # (B or 1, Lt, joint_dim) T5 sequence features
    pooled: torch.Tensor    # (B or 1, pooled_dim) CLIP pooled features
    guidance: float = 3.5   # CFG-distilled guidance scale (FLUX.1-dev)


# ----------------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------------

def _layernorm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm with float32 statistics, in ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return x32.to(x.dtype) * self.weight


def _sinusoidal(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True): [cos | sin], t in [0, 1000]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def rope_freqs(ids: torch.Tensor, cfg: FluxConfig):
    """(L, 3) position ids -> (L, head_dim / 2) float32 cos and sin tables;
    axis i contributes axes_dim[i] / 2 frequencies theta^-(2j / d_i)."""
    parts_cos, parts_sin = [], []
    for ax, d_ax in enumerate(cfg.axes_dim):
        half = d_ax // 2
        omega = 1.0 / (cfg.theta ** (torch.arange(half, dtype=torch.float32,
                                                  device=ids.device) * 2.0 / d_ax))
        ang = ids[:, ax:ax + 1].float() * omega[None, :]
        parts_cos.append(torch.cos(ang))
        parts_sin.append(torch.sin(ang))
    return torch.cat(parts_cos, -1), torch.cat(parts_sin, -1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, L, hd) with interleaved (real, imaginary) pairs."""
    x2 = x.float().reshape(*x.shape[:-1], -1, 2)
    xr, xi = x2[..., 0], x2[..., 1]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], -1)
    return out.reshape(x.shape).to(x.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads).transpose(1, 2)


def _modulate(x, shift, scale):
    return _layernorm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel output made whole: every rank's last-dim slice,
    concatenated in rank order (identity without a mesh)."""
    return x if mesh is None else torch.cat(mesh.all_gather(x).unbind(0), -1)


def _row(mesh, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``; with a mesh, ``lin`` holds this rank's input columns:
    the partial products are summed over the ranks in ``x``'s dtype, then
    the bias is added once."""
    if mesh is None:
        return lin(x)
    return mesh.all_reduce_(F.linear(x, lin.weight)) + lin.bias


class _Embedder(nn.Module):
    """diffusers TimestepEmbedding / PixArtAlphaTextProjection: linear, SiLU,
    linear."""

    def __init__(self, n_in: int, d: int):
        super().__init__()
        self.linear_1 = nn.Linear(n_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        d = cfg.hidden
        self.timestep_embedder = _Embedder(cfg.time_freq_dim, d)
        self.text_embedder = _Embedder(cfg.pooled_dim, d)
        self.guidance_embedder = _Embedder(cfg.time_freq_dim, d) if cfg.guidance else None


class _AdaNorm(nn.Module):
    """The modulation projection of an adaLN (diffusers ``norm*.linear``)."""

    def __init__(self, d: int, n_out: int):
        super().__init__()
        self.linear = nn.Linear(d, n_out)


class _GeluProj(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.proj = nn.Linear(d, mlp)


class _FeedForward(nn.Module):
    """diffusers FeedForward: ``net.0.proj`` (GELU, tanh form), ``net.2``."""

    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(d, mlp), nn.Identity(), nn.Linear(mlp, d)])

    def forward(self, x, mesh=None):
        return _row(mesh, self.net[2], F.gelu(self.net[0].proj(x), approximate="tanh"))


class _JointAttention(nn.Module):
    def __init__(self, d: int, hd: int, inner: int):
        super().__init__()
        self.to_q, self.to_k, self.to_v = (nn.Linear(d, inner), nn.Linear(d, inner),
                                           nn.Linear(d, inner))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (
            nn.Linear(d, inner), nn.Linear(d, inner), nn.Linear(d, inner))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
        self.to_out = nn.ModuleList([nn.Linear(inner, d)])
        self.to_add_out = nn.Linear(inner, d)


class _SingleAttention(nn.Module):
    def __init__(self, d: int, hd: int, inner: int):
        super().__init__()
        self.to_q, self.to_k, self.to_v = (nn.Linear(d, inner), nn.Linear(d, inner),
                                           nn.Linear(d, inner))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)


# The blocks take an optional tensor-parallel mesh (``priors/flux_shard.py``):
# a rank then holds heads / tp whole heads and mlp / tp MLP columns; the
# modulation, q/k/v and MLP-in layers are column shards (their modulation
# outputs all-gathered), the attention-out, MLP-out and fused single-block
# output layers row shards (all-reduced, bias after the sum).

class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig, mesh=None):
        super().__init__()
        tp = mesh.size if mesh is not None else 1
        d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
        self.heads, self.mesh = cfg.heads // tp, mesh
        self.norm1 = _AdaNorm(d, 6 * d // tp)
        self.norm1_context = _AdaNorm(d, 6 * d // tp)
        self.attn = _JointAttention(d, cfg.head_dim, d // tp)
        self.ff = _FeedForward(d, mlp // tp)
        self.ff_context = _FeedForward(d, mlp // tp)

    def forward(self, img, txt, temb, cos, sin):
        h, a, mesh = self.heads, self.attn, self.mesh
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _gather(mesh, self.norm1.linear(temb)).chunk(
            6, -1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _gather(
            mesh, self.norm1_context.linear(temb)).chunk(6, -1)
        img_n = _modulate(img, i_sh1, i_sc1)
        txt_n = _modulate(txt, t_sh1, t_sc1)
        # Joint attention over [txt; img] (diffusers' order).
        q = torch.cat([a.norm_added_q(_heads(a.add_q_proj(txt_n), h)),
                       a.norm_q(_heads(a.to_q(img_n), h))], 2)
        k = torch.cat([a.norm_added_k(_heads(a.add_k_proj(txt_n), h)),
                       a.norm_k(_heads(a.to_k(img_n), h))], 2)
        v = torch.cat([_heads(a.add_v_proj(txt_n), h), _heads(a.to_v(img_n), h)], 2)
        out = block_attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v)
        lt = txt.shape[1]
        img = img + i_g1[:, None, :] * _row(mesh, a.to_out[0], out[:, lt:])
        txt = txt + t_g1[:, None, :] * _row(mesh, a.to_add_out, out[:, :lt])
        img = img + i_g2[:, None, :] * self.ff(_modulate(img, i_sh2, i_sc2), mesh)
        txt = txt + t_g2[:, None, :] * self.ff_context(_modulate(txt, t_sh2, t_sc2), mesh)
        return img, txt


class SingleBlock(nn.Module):
    """With a mesh, ``proj_out`` holds this rank's columns of its attention
    half then of its MLP half (a contiguous slice of the fused columns would
    straddle the boundary)."""

    def __init__(self, cfg: FluxConfig, mesh=None):
        super().__init__()
        tp = mesh.size if mesh is not None else 1
        d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
        self.heads, self.mesh = cfg.heads // tp, mesh
        self.norm = _AdaNorm(d, 3 * d // tp)
        self.attn = _SingleAttention(d, cfg.head_dim, d // tp)
        self.proj_mlp = nn.Linear(d, mlp // tp)
        self.proj_out = nn.Linear((d + mlp) // tp, d)

    def forward(self, x, temb, cos, sin):
        h, a, mesh = self.heads, self.attn, self.mesh
        sh, sc, g = _gather(mesh, self.norm.linear(temb)).chunk(3, -1)
        xn = _modulate(x, sh, sc)
        q = _apply_rope(a.norm_q(_heads(a.to_q(xn), h)), cos, sin)
        k = _apply_rope(a.norm_k(_heads(a.to_k(xn), h)), cos, sin)
        att = block_attention(q, k, _heads(a.to_v(xn), h))
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + g[:, None, :] * _row(mesh, self.proj_out, torch.cat([att, mlp], -1))


class FluxTransformer(nn.Module):
    """The FLUX.1 velocity field v(tokens, t, cond) (diffusers key names).
    ``mesh``: see ``priors/flux_shard.py``'s ``ShardedFluxTransformer``."""

    def __init__(self, cfg: FluxConfig = FluxConfig(), mesh=None):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.x_embedder = nn.Linear(cfg.in_channels, d)
        self.context_embedder = nn.Linear(cfg.joint_dim, d)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            DoubleBlock(cfg, mesh) for _ in range(cfg.depth_double))
        self.single_transformer_blocks = nn.ModuleList(
            SingleBlock(cfg, mesh) for _ in range(cfg.depth_single))
        self.norm_out = _AdaNorm(d, 2 * d)
        self.proj_out = nn.Linear(d, cfg.in_channels)

    @torch.no_grad()
    def forward(self, img_tokens: torch.Tensor, img_ids: torch.Tensor, cond: FluxCond,
                t) -> torch.Tensor:
        """Predict dz/dt for packed latent tokens.

        Args:
            img_tokens: (B, L, in_channels) packed latents.
            img_ids: (L, 3) integer positions (0, y, x).
            cond: text conditioning (broadcast over B when its batch is 1).
            t: scalar or (B,) sigma in [0, 1] (diffusers feeds t * 1000 to
                the sinusoidal embedder).

        Returns:
            (B, L, in_channels) float32 velocity.
        """
        cfg, emb = self.cfg, self.time_text_embed
        dt = self.x_embedder.weight.dtype
        dev = img_tokens.device
        b = img_tokens.shape[0]
        txt = cond.txt.to(dev, dt).expand((b,) + tuple(cond.txt.shape[1:]))
        pooled = cond.pooled.to(dev, dt).expand((b,) + tuple(cond.pooled.shape[1:]))
        lt = txt.shape[1]

        t = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        temb = emb.timestep_embedder(_sinusoidal(t * 1000.0, cfg.time_freq_dim).to(dt))
        temb = temb + emb.text_embedder(pooled)
        if emb.guidance_embedder is not None:
            gvec = torch.full((b,), float(cond.guidance), dtype=torch.float32, device=dev)
            temb = temb + emb.guidance_embedder(
                _sinusoidal(gvec * 1000.0, cfg.time_freq_dim).to(dt))
        temb = F.silu(temb)

        img = self.x_embedder(img_tokens.to(dt))
        txt = self.context_embedder(txt)
        ids = torch.cat([torch.zeros((lt, 3), dtype=torch.long, device=dev),
                         img_ids.to(dev).long()], 0)
        cos, sin = rope_freqs(ids, cfg)
        for blk in self.transformer_blocks:
            img, txt = blk(img, txt, temb, cos, sin)
        x = torch.cat([txt, img], 1)
        for blk in self.single_transformer_blocks:
            x = blk(x, temb, cos, sin)
        img = x[:, lt:]
        # AdaLayerNormContinuous: (scale, shift) in diffusers' chunk order.
        scale, shift = self.norm_out.linear(temb).chunk(2, -1)
        img = _layernorm(img) * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return self.proj_out(img).float()


def flux_velocity(model: FluxTransformer, img_tokens, img_ids, cond: FluxCond, t):
    """The velocity field (the JAX package's ``flux_velocity``)."""
    return model(img_tokens, img_ids, cond, t)


# ----------------------------------------------------------------------------
# Construction: random weights, and the JAX package's parameters
# ----------------------------------------------------------------------------

@torch.no_grad()
def init_tensor_(name: str, p: torch.Tensor, gens: Dict[torch.device, torch.Generator],
                 seed: int, std: float = 0.02) -> None:
    """One parameter of :func:`random_init_`: a bias 0, a norm scale 1, a
    matrix N(0, std^2) from ``gens``' generator of its device (made from
    ``seed`` on first use)."""
    if name.endswith("bias"):
        p.zero_()
    elif p.ndim == 1:
        p.fill_(1.0)
    else:
        if p.device not in gens:
            gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
        p.normal_(0.0, std, generator=gens[p.device])


@torch.no_grad()
def random_init_(module: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Fill ``module`` in place as the JAX package's random init does:
    every matrix N(0, std^2), every bias 0, every norm scale 1, drawn
    tensor by tensor in the parameter's own dtype on its own device from one
    seeded generator (so no float32 copy of a bf16 model is ever made)."""
    gens: Dict[torch.device, torch.Generator] = {}
    for name, p in module.named_parameters():
        init_tensor_(name, p, gens, seed, std)
    return module


def build_module(cls, cfg, dtype=torch.float32, device="cuda", seed: Optional[int] = 0):
    """``cls(cfg)`` allocated directly in ``dtype`` on ``device`` (built on
    the meta device first), random-filled from ``seed`` unless it is None
    (then the memory is uninitialized, for a state dict to fill)."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to(dtype=dtype).to_empty(device=device).eval()
    if seed is not None:
        random_init_(module, seed)
    return module


def state_from_numpy(params, cfg: FluxConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's FLUX parameter pytree (numpy or jax arrays) as a
    ``FluxTransformer`` state dict; ``{"w": (in, out), "b"}`` linears
    become ``weight`` (out, in) and ``bias``."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def lin(prefix, p):
        sd[prefix + ".weight"] = t(np.asarray(p["w"]).T)
        sd[prefix + ".bias"] = t(p["b"])

    def mlp2(prefix, p):
        lin(prefix + ".linear_1", p["fc1"])
        lin(prefix + ".linear_2", p["fc2"])

    lin("x_embedder", params["x_embedder"])
    lin("context_embedder", params["context_embedder"])
    mlp2("time_text_embed.timestep_embedder", params["time_embedder"])
    mlp2("time_text_embed.text_embedder", params["text_embedder"])
    if cfg.guidance:
        mlp2("time_text_embed.guidance_embedder", params["guidance_embedder"])
    lin("norm_out.linear", params["norm_out"])
    lin("proj_out", params["proj_out"])
    for i, blk in enumerate(params["double"]):
        p = f"transformer_blocks.{i}"
        for name, key in (("norm1.linear", "img_mod"), ("norm1_context.linear", "txt_mod"),
                          ("attn.to_q", "img_q"), ("attn.to_k", "img_k"),
                          ("attn.to_v", "img_v"), ("attn.add_q_proj", "txt_q"),
                          ("attn.add_k_proj", "txt_k"), ("attn.add_v_proj", "txt_v"),
                          ("attn.to_out.0", "img_out"), ("attn.to_add_out", "txt_out"),
                          ("ff.net.0.proj", "img_mlp1"), ("ff.net.2", "img_mlp2"),
                          ("ff_context.net.0.proj", "txt_mlp1"),
                          ("ff_context.net.2", "txt_mlp2")):
            lin(f"{p}.{name}", blk[key])
        for name, key in (("norm_q", "img_qnorm"), ("norm_k", "img_knorm"),
                          ("norm_added_q", "txt_qnorm"), ("norm_added_k", "txt_knorm")):
            sd[f"{p}.attn.{name}.weight"] = t(blk[key])
    for i, blk in enumerate(params["single"]):
        p = f"single_transformer_blocks.{i}"
        for name, key in (("norm.linear", "mod"), ("attn.to_q", "q"), ("attn.to_k", "k"),
                          ("attn.to_v", "v"), ("proj_mlp", "mlp_in"), ("proj_out", "out")):
            lin(f"{p}.{name}", blk[key])
        sd[f"{p}.attn.norm_q.weight"] = t(blk["qnorm"])
        sd[f"{p}.attn.norm_k.weight"] = t(blk["knorm"])
    return sd


def flux_flops(cfg: FluxConfig, n_img: int, n_txt: int) -> dict:
    """Flops of one velocity evaluation of one image: the linear layers (2
    per weight per token of the stream the weight acts on; a double
    block's image and text weights each see their own stream only, and the
    modulation weights act once per image, not per token) and the attention
    products (QK^T and PV: 4 * L^2 * hidden per block)."""
    d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
    length = n_img + n_txt
    per_double = 2 * (4 * d * d + 2 * d * mlp)                   # per token of its stream
    per_single = 2 * (3 * d * d + d * mlp + (d + mlp) * d)
    gemm = (cfg.depth_double * per_double * length + cfg.depth_single * per_single * length
            + 2 * cfg.in_channels * d * n_img + 2 * cfg.joint_dim * d * n_txt
            + 2 * d * cfg.in_channels * n_img)
    attn = (cfg.depth_double + cfg.depth_single) * 4 * length * length * d
    return {"gemm": gemm, "attention": attn}


# ----------------------------------------------------------------------------
# Latent <-> token packing and the sigma schedule
# ----------------------------------------------------------------------------

def pack_latents(z: torch.Tensor):
    """(B, h, w, C) VAE latents -> ((B, h/2 * w/2, 4C) tokens, (L, 3) ids),
    features ordered (dy, dx, c) as the JAX package packs them."""
    b, h, w, c = z.shape
    tok = (z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
           .reshape(b, (h // 2) * (w // 2), 4 * c))
    return tok, latent_ids(h, w, device=z.device)


def latent_ids(h: int, w: int, device="cpu") -> torch.Tensor:
    """(h/2 * w/2, 3) RoPE ids (0, y, x) of an (h, w) latent grid."""
    ys, xs = torch.meshgrid(torch.arange(h // 2, device=device),
                            torch.arange(w // 2, device=device), indexing="ij")
    return torch.stack([torch.zeros_like(ys), ys, xs], -1).reshape(-1, 3)


def unpack_latents(tok: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`pack_latents` for an (h, w) latent grid."""
    b, _, c4 = tok.shape
    c = c4 // 4
    return (tok.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h, w, c))


def shifted_sigmas(num_steps: int, image_seq_len: int, base_len: int = 256,
                   max_len: int = 4096, base_shift: float = 0.5,
                   max_shift: float = 1.15) -> torch.Tensor:
    """FLUX's resolution-dependent sigma schedule (FlowMatchEulerDiscrete
    dynamic shifting): sigma' = exp(mu) / (exp(mu) + 1 / sigma - 1), with a
    final 0; float32, computed as the JAX package computes it."""
    m = (max_shift - base_shift) / (max_len - base_len)
    mu = torch.tensor(image_seq_len * m + (base_shift - base_len * m), dtype=torch.float32)
    sig = torch.linspace(1.0, 1.0 / num_steps, num_steps)
    sig = torch.exp(mu) / (torch.exp(mu) + (1.0 / sig - 1.0))
    return torch.cat([sig, torch.zeros(1)])
