"""FLUX VAE (AutoencoderKL) as a PyTorch module.

Port of ``skyfall_gs_tpu/priors/flux_vae.py``:
  * encoder: conv stem -> 4 down stages (2 ResNet blocks each, a stride-2
    downsample after each but the last) -> mid (ResNet, single-head
    spatial attention, ResNet) -> GroupNorm / SiLU -> 2 * latent_ch (mean,
    logvar);
  * decoder: the mirror, 3 ResNet blocks per stage and nearest 2x
    upsampling;
  * FLUX's latent normalization z' = (z - shift) * scale.

The convolutions run NCHW with OIHW weights; ``encode`` and ``decode`` take
and return channels-last tensors, as the JAX functions do.  ``VAE``'s
``state_dict`` keys are diffusers' ``AutoencoderKL`` names (FLUX's config:
no quant convs), and ``state_from_numpy`` carries the JAX package's
parameter pytree (NHWC / HWIO) into them.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class VAEConfig(NamedTuple):
    base_ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res: int = 2               # encoder ResNet blocks per stage
    latent_ch: int = 16
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    groups: int = 32

    @classmethod
    def tiny(cls):
        return cls(base_ch=16, ch_mult=(1, 2), num_res=1, latent_ch=4, groups=4)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head self-attention over the H * W positions; scores and
    softmax in float32."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        n = self.group_norm(x).flatten(2).transpose(1, 2)        # (B, HW, C)
        q, k, v = self.to_q(n), self.to_k(n), self.to_v(n)
        out = torch.empty_like(v)
        for i in range(b):
            s = torch.matmul(q[i].float(), k[i].float().T) / math.sqrt(c)
            out[i] = torch.matmul(torch.softmax(s, -1).to(v.dtype), v[i])
            del s
        return x + self.to_out[0](out).transpose(1, 2).reshape(b, c, h, w)


class _Sampler(nn.Module):
    """diffusers Downsample2D (pad (0, 1) on both axes, stride 2) or
    Upsample2D (nearest 2x, then a 3x3 convolution)."""

    def __init__(self, c: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(c, c, 3, stride=2) if down else nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, n_res: int, groups: int, sampler: str = ""):
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
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, groups), ResnetBlock(c, c, groups)])
        self.attentions = nn.ModuleList([SpatialAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        g = cfg.groups
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _Stage(chs[max(si - 1, 0)], c, cfg.num_res, g,
                   "down" if si < len(chs) - 1 else "")
            for si, c in enumerate(chs))
        self.mid_block = _Mid(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_ch, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            x = stage(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        g = cfg.groups
        rev = list(reversed(chs))
        self.conv_in = nn.Conv2d(cfg.latent_ch, chs[-1], 3, padding=1)
        self.mid_block = _Mid(chs[-1], g)
        self.up_blocks = nn.ModuleList(
            _Stage(rev[max(si - 1, 0)], c, cfg.num_res + 1, g,
                   "up" if si < len(chs) - 1 else "")
            for si, c in enumerate(rev))
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[0], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            x = stage(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """FLUX's AutoencoderKL (diffusers key names)."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> (B, H/8, W/8, latent_ch) normalized
        posterior means (diffusers ``.mode()``)."""
        x = self.encoder(images.permute(0, 3, 1, 2).to(self.encoder.conv_in.weight.dtype))
        mean = x[:, :self.cfg.latent_ch].permute(0, 2, 3, 1)
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, latent_ch) normalized latents -> (B, 8h, 8w, 3) in
        [-1, 1] (not clipped)."""
        z = z / self.cfg.scaling_factor + self.cfg.shift_factor
        x = self.decoder(z.permute(0, 3, 1, 2).to(self.decoder.conv_in.weight.dtype))
        return x.permute(0, 2, 3, 1)


def state_from_numpy(params, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's VAE parameter pytree as a ``VAE`` state dict: HWIO
    convolutions become OIHW, the attention's 1x1 convolutions linears."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def conv(prefix, p):
        sd[prefix + ".weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[prefix + ".bias"] = t(p["b"])

    def gn(prefix, p):
        sd[prefix + ".weight"] = t(p["scale"])
        sd[prefix + ".bias"] = t(p["bias"])

    def resnet(prefix, p):
        gn(prefix + ".norm1", p["norm1"])
        conv(prefix + ".conv1", p["conv1"])
        gn(prefix + ".norm2", p["norm2"])
        conv(prefix + ".conv2", p["conv2"])
        if "shortcut" in p:
            conv(prefix + ".conv_shortcut", p["shortcut"])

    def mid(prefix, p):
        resnet(prefix + ".resnets.0", p["res1"])
        resnet(prefix + ".resnets.1", p["res2"])
        a = prefix + ".attentions.0"
        gn(a + ".group_norm", p["attn"]["norm"])
        for name, key in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "out")):
            sd[f"{a}.{name}.weight"] = t(np.asarray(p["attn"][key]["w"])[0, 0].T)
            sd[f"{a}.{name}.bias"] = t(p["attn"][key]["b"])

    for side, stages, sampler in (("encoder", "down", "downsamplers"),
                                  ("decoder", "up", "upsamplers")):
        p = params[side]
        conv(f"{side}.conv_in", p["conv_in"])
        mid(f"{side}.mid_block", p["mid"])
        for si, stage in enumerate(p[stages]):
            prefix = f"{side}.{stages}_blocks.{si}"
            for j, rp in enumerate(stage["res"]):
                resnet(f"{prefix}.resnets.{j}", rp)
            if stage[stages] is not None:
                conv(f"{prefix}.{sampler}.0.conv", stage[stages])
        gn(f"{side}.conv_norm_out", p["norm_out"])
        conv(f"{side}.conv_out", p["conv_out"])
    return sd
