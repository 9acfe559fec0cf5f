"""Plain PyTorch reference of Stage 2's priors: FLUX.1, its VAE, FlowEdit
and MoGe, in float32.

Frozen copies, at commit a752ef2, of ``skyfall_gs_tpu_torch/priors/flux.py``
(the MMDiT velocity field with diffusers' parameter names; the
tensor-parallel paths left out), ``priors/flux_vae.py`` (AutoencoderKL),
``priors/flowedit.py`` (the batched FlowEdit loop), ``priors/flux_refiner.py``
(packing, the shifted sigma grid, encode and decode), ``priors/moge.py``
(the DINOv2 ViT, the MoGe head and the resizes of ``MoGePredictor``) and
``io/scene.py``'s area weights.  They follow the published descriptions
(FLUX.1 and its diffusers configuration, FlowEdit by Kulikov et al. 2024,
MoGe on DINOv2 ViT-L/14) and import nothing of the program.

Everything runs in float32 with TF32 off.  ``fp8_linears`` turns the
float32 FLUX into the control: every linear layer's weight and input
rounded to float8 e4m3 with a per-tensor scale, products in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ----------------------------------------------------------------------------
# FLUX.1
# ----------------------------------------------------------------------------

class FluxConfig(NamedTuple):
    in_channels: int = 64
    hidden: int = 3072
    heads: int = 24
    head_dim: int = 128
    depth_double: int = 19
    depth_single: int = 38
    joint_dim: int = 4096
    pooled_dim: int = 768
    axes_dim: tuple = (16, 56, 56)
    theta: int = 10_000
    guidance: bool = True
    mlp_ratio: float = 4.0
    time_freq_dim: int = 256


class FluxCond(NamedTuple):
    txt: torch.Tensor
    pooled: torch.Tensor
    guidance: float = 3.5


def _layernorm(x, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return x32.to(x.dtype) * self.weight


def _sinusoidal(t, dim, max_period=10_000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None].float() * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def rope_freqs(ids, cfg: FluxConfig):
    cs, ss = [], []
    for ax, d_ax in enumerate(cfg.axes_dim):
        half = d_ax // 2
        omega = 1.0 / (cfg.theta ** (torch.arange(half, dtype=torch.float32,
                                                  device=ids.device) * 2.0 / d_ax))
        ang = ids[:, ax:ax + 1].float() * omega[None, :]
        cs.append(torch.cos(ang))
        ss.append(torch.sin(ang))
    return torch.cat(cs, -1), torch.cat(ss, -1)


def _apply_rope(x, cos, sin):
    x2 = x.float().reshape(*x.shape[:-1], -1, 2)
    xr, xi = x2[..., 0], x2[..., 1]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], -1).reshape(x.shape).to(x.dtype)


def _heads(x, heads):
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads).transpose(1, 2)


def attention(q, k, v):
    """(B, H, L, hd) each -> (B, L, H * hd); scores and softmax in float32."""
    b, h, n, hd = q.shape
    out = torch.empty_like(v)
    for i in range(b):
        s = torch.matmul(q[i].float(), k[i].float().transpose(-1, -2)) / math.sqrt(hd)
        out[i] = torch.matmul(torch.softmax(s, -1).to(v.dtype), v[i])
        del s
    return out.transpose(1, 2).reshape(b, n, h * hd)


def _modulate(x, shift, scale):
    return _layernorm(x) * (1.0 + scale[:, None, :]) + shift[:, None, :]


class _Embedder(nn.Module):
    def __init__(self, n_in, d):
        super().__init__()
        self.linear_1 = nn.Linear(n_in, d)
        self.linear_2 = nn.Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.timestep_embedder = _Embedder(cfg.time_freq_dim, cfg.hidden)
        self.text_embedder = _Embedder(cfg.pooled_dim, cfg.hidden)
        self.guidance_embedder = _Embedder(cfg.time_freq_dim, cfg.hidden) if cfg.guidance else None


class _AdaNorm(nn.Module):
    def __init__(self, d, n_out):
        super().__init__()
        self.linear = nn.Linear(d, n_out)


class _GeluProj(nn.Module):
    def __init__(self, d, mlp):
        super().__init__()
        self.proj = nn.Linear(d, mlp)


class _FeedForward(nn.Module):
    def __init__(self, d, mlp):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(d, mlp), nn.Identity(), nn.Linear(mlp, d)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class _JointAttention(nn.Module):
    def __init__(self, d, hd):
        super().__init__()
        self.to_q, self.to_k, self.to_v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(d, d), nn.Linear(d, d),
                                                             nn.Linear(d, d))
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)
        self.norm_added_q, self.norm_added_k = RMSNorm(hd), RMSNorm(hd)
        self.to_out = nn.ModuleList([nn.Linear(d, d)])
        self.to_add_out = nn.Linear(d, d)


class _SingleAttention(nn.Module):
    def __init__(self, d, hd):
        super().__init__()
        self.to_q, self.to_k, self.to_v = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.norm_q, self.norm_k = RMSNorm(hd), RMSNorm(hd)


class DoubleBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
        self.heads = cfg.heads
        self.norm1 = _AdaNorm(d, 6 * d)
        self.norm1_context = _AdaNorm(d, 6 * d)
        self.attn = _JointAttention(d, cfg.head_dim)
        self.ff = _FeedForward(d, mlp)
        self.ff_context = _FeedForward(d, mlp)

    def forward(self, img, txt, temb, cos, sin):
        h, a = self.heads, self.attn
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.norm1.linear(temb).chunk(6, -1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.norm1_context.linear(temb).chunk(6, -1)
        img_n = _modulate(img, i_sh1, i_sc1)
        txt_n = _modulate(txt, t_sh1, t_sc1)
        q = torch.cat([a.norm_added_q(_heads(a.add_q_proj(txt_n), h)),
                       a.norm_q(_heads(a.to_q(img_n), h))], 2)
        k = torch.cat([a.norm_added_k(_heads(a.add_k_proj(txt_n), h)),
                       a.norm_k(_heads(a.to_k(img_n), h))], 2)
        v = torch.cat([_heads(a.add_v_proj(txt_n), h), _heads(a.to_v(img_n), h)], 2)
        out = attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v)
        lt = txt.shape[1]
        img = img + i_g1[:, None, :] * a.to_out[0](out[:, lt:])
        txt = txt + t_g1[:, None, :] * a.to_add_out(out[:, :lt])
        img = img + i_g2[:, None, :] * self.ff(_modulate(img, i_sh2, i_sc2))
        txt = txt + t_g2[:, None, :] * self.ff_context(_modulate(txt, t_sh2, t_sc2))
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
        self.heads = cfg.heads
        self.norm = _AdaNorm(d, 3 * d)
        self.attn = _SingleAttention(d, cfg.head_dim)
        self.proj_mlp = nn.Linear(d, mlp)
        self.proj_out = nn.Linear(d + mlp, d)

    def forward(self, x, temb, cos, sin):
        h, a = self.heads, self.attn
        sh, sc, g = self.norm.linear(temb).chunk(3, -1)
        xn = _modulate(x, sh, sc)
        q = _apply_rope(a.norm_q(_heads(a.to_q(xn), h)), cos, sin)
        k = _apply_rope(a.norm_k(_heads(a.to_k(xn), h)), cos, sin)
        att = attention(q, k, _heads(a.to_v(xn), h))
        mlp = F.gelu(self.proj_mlp(xn), approximate="tanh")
        return x + g[:, None, :] * self.proj_out(torch.cat([att, mlp], -1))


class FluxTransformer(nn.Module):
    def __init__(self, cfg: FluxConfig = FluxConfig()):
        super().__init__()
        d = cfg.hidden
        self.cfg = cfg
        self.x_embedder = nn.Linear(cfg.in_channels, d)
        self.context_embedder = nn.Linear(cfg.joint_dim, d)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(DoubleBlock(cfg) for _ in range(cfg.depth_double))
        self.single_transformer_blocks = nn.ModuleList(
            SingleBlock(cfg) for _ in range(cfg.depth_single))
        self.norm_out = _AdaNorm(d, 2 * d)
        self.proj_out = nn.Linear(d, cfg.in_channels)

    @torch.no_grad()
    def forward(self, img_tokens, img_ids, cond: FluxCond, t):
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
            g = torch.full((b,), float(cond.guidance), dtype=torch.float32, device=dev)
            temb = temb + emb.guidance_embedder(_sinusoidal(g * 1000.0, cfg.time_freq_dim).to(dt))
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
        scale, shift = self.norm_out.linear(temb).chunk(2, -1)
        img = _layernorm(img) * (1.0 + scale[:, None, :]) + shift[:, None, :]
        return self.proj_out(img).float()


def pack_latents(z):
    b, h, w, c = z.shape
    return (z.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, (h // 2) * (w // 2), 4 * c))


def latent_ids(h, w, device="cpu"):
    ys, xs = torch.meshgrid(torch.arange(h // 2, device=device),
                            torch.arange(w // 2, device=device), indexing="ij")
    return torch.stack([torch.zeros_like(ys), ys, xs], -1).reshape(-1, 3)


def unpack_latents(tok, h, w):
    b, _, c4 = tok.shape
    c = c4 // 4
    return tok.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shifted_sigmas(num_steps, image_seq_len, base_len=256, max_len=4096, base_shift=0.5,
                   max_shift=1.15):
    m = (max_shift - base_shift) / (max_len - base_len)
    mu = torch.tensor(image_seq_len * m + (base_shift - base_len * m), dtype=torch.float32)
    sig = torch.linspace(1.0, 1.0 / num_steps, num_steps)
    sig = torch.exp(mu) / (torch.exp(mu) + (1.0 / sig - 1.0))
    return torch.cat([sig, torch.zeros(1)])


def _round_e4m3(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(x.detach().abs().amax().float(), 1e-12) / 448.0
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


@torch.no_grad()
def fp8_linears(model: nn.Module) -> nn.Module:
    """Round every linear layer's weight to float8 e4m3 in place and its
    input at each call (per-tensor scales): the control's precision."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(_round_e4m3(m.weight))
            m.register_forward_pre_hook(lambda mod, args: (_round_e4m3(args[0]),))
    return model


# ----------------------------------------------------------------------------
# FlowEdit
# ----------------------------------------------------------------------------

@torch.no_grad()
def flow_edit(velocity, x_src, src_cond, tar_cond, noise, sigmas, num_steps=28,
              n_min=0, n_max=15, n_avg=1):
    """FlowEdit (rectified-flow form) over the window [num_steps - n_max,
    num_steps - n_min): ``noise`` yields one draw per step and average,
    shaped like ``x_src``."""
    z = x_src.clone()
    for k in range(num_steps - n_max, num_steps - n_min):
        t, t_next = sigmas[k], sigmas[k + 1]
        dv = torch.zeros_like(x_src)
        for _ in range(n_avg):
            eps = next(noise)
            z_src = (1.0 - t) * x_src + t * eps
            z_tar = z_src + (z - x_src)
            dv = dv + (velocity(z_tar, t, tar_cond) - velocity(z_src, t, src_cond))
        z = z + (t_next - t) * (dv / n_avg)
    return z


# ----------------------------------------------------------------------------
# The FLUX VAE
# ----------------------------------------------------------------------------

class VAEConfig(NamedTuple):
    base_ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res: int = 2
    latent_ch: int = 16
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    groups: int = 32


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class SpatialAttention(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        n = self.group_norm(x).flatten(2).transpose(1, 2)
        q, k, v = self.to_q(n), self.to_k(n), self.to_v(n)
        out = torch.empty_like(v)
        for i in range(b):
            s = torch.matmul(q[i].float(), k[i].float().T) / math.sqrt(c)
            out[i] = torch.matmul(torch.softmax(s, -1).to(v.dtype), v[i])
            del s
        return x + self.to_out[0](out).transpose(1, 2).reshape(b, c, h, w)


class _Sampler(nn.Module):
    def __init__(self, c, down):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(c, c, 3, stride=2) if down else nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Stage(nn.Module):
    def __init__(self, cin, cout, n_res, groups, sampler=""):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if j == 0 else cout, cout, groups)
                                     for j in range(n_res))
        if sampler:
            setattr(self, sampler + "samplers", nn.ModuleList([_Sampler(cout, sampler == "down")]))

    def forward(self, x):
        for rb in self.resnets:
            x = rb(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class _Mid(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, groups), ResnetBlock(c, c, groups)])
        self.attentions = nn.ModuleList([SpatialAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _Stage(chs[max(si - 1, 0)], c, cfg.num_res, cfg.groups,
                   "down" if si < len(chs) - 1 else "") for si, c in enumerate(chs))
        self.mid_block = _Mid(chs[-1], cfg.groups)
        self.conv_norm_out = nn.GroupNorm(cfg.groups, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_ch, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            x = stage(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        rev = list(reversed(chs))
        self.conv_in = nn.Conv2d(cfg.latent_ch, chs[-1], 3, padding=1)
        self.mid_block = _Mid(chs[-1], cfg.groups)
        self.up_blocks = nn.ModuleList(
            _Stage(rev[max(si - 1, 0)], c, cfg.num_res + 1, cfg.groups,
                   "up" if si < len(chs) - 1 else "") for si, c in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(cfg.groups, chs[0], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[0], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            x = stage(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    @torch.no_grad()
    def encode(self, images):
        """(B, H, W, 3) in [-1, 1] -> normalized posterior means (B, H/8, W/8, C)."""
        x = self.encoder(images.permute(0, 3, 1, 2))
        mean = x[:, :self.cfg.latent_ch].permute(0, 2, 3, 1)
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    @torch.no_grad()
    def decode(self, z):
        z = z / self.cfg.scaling_factor + self.cfg.shift_factor
        return self.decoder(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ----------------------------------------------------------------------------
# MoGe on a DINOv2 ViT, and the resizes around it
# ----------------------------------------------------------------------------

class ViTConfig(NamedTuple):
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    img_size: int = 518
    out_layers: tuple = (5, 11, 17, 23)
    head_width: int = 256


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def resize_weights(n_in, n_out, method, device="cpu"):
    """(n_in, n_out) antialiased resize weights, half-pixel centres, the Keys
    cubic (a = -0.5) or the triangle kernel, renormalized at the borders."""
    kernel = {"cubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kscale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(x, hw, method):
    wh = resize_weights(x.shape[-2], hw[0], method, x.device).to(x.dtype)
    ww = resize_weights(x.shape[-1], hw[1], method, x.device).to(x.dtype)
    return torch.einsum("...hw,hi,wj->...ij", x, wh, ww)


def area_weights(n_in, n_out):
    """(n_out, n_in) OpenCV INTER_AREA overlap weights (slivers under 1e-3 dropped)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        f1 = i * scale
        f2 = f1 + scale
        s1, s2 = math.ceil(f1), math.floor(f2)
        cell = min(scale, n_in - f1)
        if s1 - f1 > 1e-3:
            w[i, s1 - 1] = (s1 - f1) / cell
        w[i, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[i, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w


def linear_weights(n_in, n_out):
    """(n_out, n_in) OpenCV INTER_LINEAR weights (half-pixel centres, clamped)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        fx = (d + 0.5) * scale - 0.5
        sx = math.floor(fx)
        fx -= sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= n_in - 1:
            fx, sx = 0.0, n_in - 1
        w[d, sx] += 1.0 - fx
        if fx:
            w[d, sx + 1] += fx
    return w


def cv2_resize(img, dst_hw, kind):
    """OpenCV's resize of (H, W) or (H, W, C): "area" when both axes shrink,
    "linear" otherwise (the two cases ``MoGePredictor`` uses)."""
    (sh, sw), (dh, dw) = img.shape[:2], dst_hw
    fn = area_weights if kind == "area" else linear_weights
    if kind == "area" and not (dh <= sh and dw <= sw):
        raise ValueError("area upscaling is not part of the reference")
    wy = torch.from_numpy(fn(sh, dh).astype(np.float32)).to(img.device)
    wx = torch.from_numpy(fn(sw, dw).astype(np.float32)).to(img.device)
    return torch.einsum("yi,xj,ij...->yx...", wy, wx, img.float())


class _PatchEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size)


class _ViTAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v))


class _Mlp(nn.Module):
    def __init__(self, d, hidden):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _LayerScale(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d))


class _Block(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.width
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _ViTAttention(d, cfg.heads)
        self.ls1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = _LayerScale(d)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, grid = cfg.width, cfg.img_size // cfg.patch_size
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, d))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, images):
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embed.proj(images)
        gh, gw = x.shape[-2:]
        x = torch.cat([self.cls_token.expand(b, -1, -1), x.flatten(2).transpose(1, 2)], 1)
        cls, patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        g0 = int(math.sqrt(patch.shape[1]))
        grid = resize(patch.reshape(g0, g0, -1).permute(2, 0, 1), (gh, gw), "cubic")
        x = x + torch.cat([cls, grid.flatten(1).T[None]], 1)
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.out_layers:
                taps.append(x[:, 1:].transpose(1, 2).reshape(b, -1, gh, gw))
        return taps


class _OutputBlock(nn.Sequential):
    def __init__(self, hw):
        super().__init__(nn.Conv2d(hw, hw // 2, 3, padding=1), nn.ReLU(), nn.Conv2d(hw // 2, 4, 1))


class _Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        hw, n = cfg.head_width, len(cfg.out_layers)
        self.projects = nn.ModuleList(nn.Conv2d(cfg.width, hw, 1) for _ in range(n))
        self.upsample_blocks = nn.ModuleList(nn.Conv2d(hw, hw, 3, padding=1) for _ in range(n))
        self.output_block = _OutputBlock(hw)


class MoGe(nn.Module):
    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg)
        self.head = _Head(cfg)

    @torch.no_grad()
    def depth(self, images):
        """(B, H, W, 3) in [0, 1] -> (B, H, W) relative depth (the point map's z)."""
        b, h, w, _ = images.shape
        mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
        taps = self.backbone(((images - mean) / std).permute(0, 3, 1, 2))
        feat = None
        for tap, proj, up in zip(reversed(taps), reversed(self.head.projects),
                                 reversed(self.head.upsample_blocks)):
            t = proj(tap)
            feat = t if feat is None else feat + resize(t, feat.shape[-2:], "bilinear")
            feat = F.relu(up(feat))
            feat = resize(feat, (2 * feat.shape[-2], 2 * feat.shape[-1]), "bilinear")
        raw = resize(self.head.output_block(feat), (h, w), "bilinear").permute(0, 2, 3, 1)
        return F.softplus(raw[..., 2])


def moge_target_hw(h, w, cfg: ViTConfig):
    ps = cfg.patch_size
    scale = cfg.img_size / math.sqrt(h * w)
    return (max(ps, int(round(h * scale / ps)) * ps), max(ps, int(round(w * scale / ps)) * ps))


@torch.no_grad()
def moge_predict(model: MoGe, frame: torch.Tensor) -> torch.Tensor:
    """One (H, W, 3) frame in [0, 1] -> (H, W) depth, as ``MoGePredictor``:
    area resize to ~img_size^2 (patch multiples), the model, bilinear back."""
    h, w = frame.shape[:2]
    x = cv2_resize(frame, moge_target_hw(h, w, model.cfg), "area")
    return cv2_resize(model.depth(x[None])[0], (h, w), "linear")
