"""Monocular depth: MoGe on a DINOv2 ViT, as a PyTorch module.

Port of ``skyfall_gs_tpu/priors/moge.py`` (the reference's ``MoGeIDU``): a
DINOv2-style ViT encoder (patch-14 embedding, learned positional embedding
resized to the input's grid, pre-norm blocks with LayerScale) and a
MoGe-style dense head fusing four intermediate feature maps into an
affine-invariant point map and a validity mask; its z is the relative depth
the Pearson losses consume.

``MoGe``'s ``state_dict`` keys are the schema the JAX package's
``convert_torch_state_dict`` reads (``backbone.*`` DINOv2 names,
``head.projects.{i}``, ``head.upsample_blocks.{i}``,
``head.output_block.{0,2}``); ``state_from_numpy`` carries the JAX
parameter pytree into them.

Resizes are written as explicit weight matrices, so the port needs neither
OpenCV nor a bicubic whose kernel differs from the reference's:
  * ``jax_resize`` is ``jax.image.resize`` (half-pixel centres, the Keys
    cubic with a = -0.5 or the triangle kernel, widened by the scale when
    downsampling, weights renormalized at the borders);
  * ``cv2_resize_weights`` is OpenCV's INTER_AREA (the overlap weights of
    ``io/scene.py`` when both axes shrink, OpenCV's area-upscale rule
    otherwise) and INTER_LINEAR (half-pixel centres, clamped at the
    borders), used by ``MoGePredictor`` for its prep and to resize the
    depth back to the frame.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyfall_gs_tpu_torch.io.scene import _area_weights
from skyfall_gs_tpu_torch.ops.attention import attention


class ViTConfig(NamedTuple):
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    img_size: int = 518          # native grid = 37x37 tokens
    out_layers: tuple = (5, 11, 17, 23)
    head_width: int = 256


# ----------------------------------------------------------------------------
# Resizes
# ----------------------------------------------------------------------------

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def jax_resize_weights(n_in: int, n_out: int, method: str, device="cpu") -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize`` along one axis
    (antialiased, as its default), for ``method`` "cubic" or "bilinear"."""
    kernel = {"cubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def jax_resize(x: torch.Tensor, hw, method: str) -> torch.Tensor:
    """Resize the two trailing axes of ``x`` (..., H, W) to ``hw`` as
    ``jax.image.resize`` does."""
    wh = jax_resize_weights(x.shape[-2], hw[0], method, x.device).to(x.dtype)
    ww = jax_resize_weights(x.shape[-1], hw[1], method, x.device).to(x.dtype)
    return torch.einsum("...hw,hi,wj->...ij", x, wh, ww)


def _cv2_linear_weights(n_in: int, n_out: int, area_upscale: bool) -> np.ndarray:
    """(n_out, n_in) OpenCV INTER_LINEAR weights, or the INTER_AREA weights
    OpenCV uses when not both axes shrink."""
    inv_scale = n_out / n_in
    scale = 1.0 / inv_scale
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        if area_upscale:
            sx = math.floor(d * scale)
            fx = (d + 1) - (sx + 1) * inv_scale
            fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        else:
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


def cv2_resize_weights(src_hw, dst_hw, interpolation: str):
    """((dst_h, src_h), (dst_w, src_w)) float32 weights of OpenCV's resize
    of an (src_h, src_w) image to (dst_h, dst_w); ``interpolation`` "area"
    (INTER_AREA) or "linear" (INTER_LINEAR)."""
    (sh, sw), (dh, dw) = src_hw, dst_hw
    if interpolation == "area" and dh <= sh and dw <= sw:
        pair = (_area_weights(sh, dh), _area_weights(sw, dw))
    else:
        area = interpolation == "area"
        pair = (_cv2_linear_weights(sh, dh, area), _cv2_linear_weights(sw, dw, area))
    return tuple(torch.from_numpy(p.astype(np.float32)) for p in pair)


def cv2_resize(img: torch.Tensor, dst_hw, interpolation: str) -> torch.Tensor:
    """OpenCV's resize of an (H, W) or (H, W, C) float tensor to ``dst_hw``."""
    wy, wx = (m.to(img.device) for m in cv2_resize_weights(img.shape[:2], dst_hw,
                                                         interpolation))
    return torch.einsum("yi,xj,ij...->yx...", wy, wx, img.float())


# ----------------------------------------------------------------------------
# The network
# ----------------------------------------------------------------------------

class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size)


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(
            2, 0, 3, 1, 4)
        return self.proj(attention(q, k, v))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x):
        # DINOv2's nn.GELU: the exact erf form.
        return self.fc2(F.gelu(self.fc1(x)))


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d))


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.width
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _Attention(d, cfg.heads)
        self.ls1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = _LayerScale(d)

    def forward(self, x):
        x = x + self.ls1.gamma * self.attn(self.norm1(x))
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class ViT(nn.Module):
    """DINOv2-style encoder (DINOv2 key names)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d, grid = cfg.width, cfg.img_size // cfg.patch_size
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, d))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, images: torch.Tensor):
        """(B, 3, H, W) normalized -> the (B, D, gh, gw) feature maps at
        ``out_layers`` and the final normed tokens."""
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embed.proj(images)                       # (B, D, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], 1)
        x = x + resize_pos_embed(self.pos_embed, (gh, gw))
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.out_layers:
                taps.append(x[:, 1:].transpose(1, 2).reshape(b, -1, gh, gw))
        return taps, self.norm(x)


def resize_pos_embed(pos: torch.Tensor, grid_hw) -> torch.Tensor:
    """The (1, 1 + G*G, D) positional embedding on a (gh, gw) grid: the
    patch part resized as ``jax.image.resize(..., "cubic")`` (Keys a = -0.5,
    antialiased when it shrinks)."""
    cls, patch = pos[:, :1], pos[:, 1:]
    g0 = int(math.sqrt(patch.shape[1]))
    img = patch.reshape(g0, g0, -1).permute(2, 0, 1)
    img = jax_resize(img, grid_hw, "cubic")
    return torch.cat([cls, img.flatten(1).T[None]], 1)


class _OutputBlock(nn.Sequential):
    def __init__(self, hw: int):
        super().__init__(nn.Conv2d(hw, hw // 2, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hw // 2, 4, 1))


class _Head(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hw, n = cfg.head_width, len(cfg.out_layers)
        self.projects = nn.ModuleList(nn.Conv2d(cfg.width, hw, 1) for _ in range(n))
        self.upsample_blocks = nn.ModuleList(nn.Conv2d(hw, hw, 3, padding=1) for _ in range(n))
        self.output_block = _OutputBlock(hw)


class MoGe(nn.Module):
    """ViT encoder + dense head -> (point map, mask)."""

    def __init__(self, cfg: ViTConfig = ViTConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg)
        self.head = _Head(cfg)

    @torch.no_grad()
    def forward(self, images: torch.Tensor):
        """(B, H, W, 3) in [0, 1] -> ((B, H, W, 3) points, (B, H, W) mask)."""
        b, h, w, _ = images.shape
        mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
        taps, _ = self.backbone(((images - mean) / std).permute(0, 3, 1, 2))
        head = self.head
        feat = None
        # Fuse deepest to shallowest, doubling the resolution after each.
        for tap, proj, up in zip(reversed(taps), reversed(head.projects),
                                 reversed(head.upsample_blocks)):
            t = proj(tap)
            feat = t if feat is None else feat + jax_resize(t, feat.shape[-2:], "bilinear")
            feat = F.relu(up(feat))
            feat = jax_resize(feat, (2 * feat.shape[-2], 2 * feat.shape[-1]), "bilinear")
        raw = jax_resize(head.output_block(feat), (h, w), "bilinear").permute(0, 2, 3, 1)
        pts = torch.cat([raw[..., :2], F.softplus(raw[..., 2:3])], -1)
        return pts, torch.sigmoid(raw[..., 3])


def moge_points(model: MoGe, images: torch.Tensor):
    return model(images)


def moge_depth(model: MoGe, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, H, W) positive relative depth."""
    return model(images)[0][..., 2]


# ----------------------------------------------------------------------------
# Weights
# ----------------------------------------------------------------------------

def state_from_numpy(params, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's MoGe parameter pytree as a ``MoGe`` state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def lin(prefix, p):
        sd[prefix + ".weight"] = t(np.asarray(p["w"]).T)
        sd[prefix + ".bias"] = t(p["b"])

    def conv(prefix, p):
        sd[prefix + ".weight"] = t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[prefix + ".bias"] = t(p["b"])

    def ln(prefix, p):
        sd[prefix + ".weight"] = t(p["scale"])
        sd[prefix + ".bias"] = t(p["bias"])

    conv("backbone.patch_embed.proj", params["patch_embed"])
    sd["backbone.cls_token"] = t(params["cls_token"])
    sd["backbone.pos_embed"] = t(params["pos_embed"])
    for i, blk in enumerate(params["blocks"]):
        p = f"backbone.blocks.{i}"
        ln(p + ".norm1", blk["ln1"])
        lin(p + ".attn.qkv", blk["qkv"])
        lin(p + ".attn.proj", blk["proj"])
        ln(p + ".norm2", blk["ln2"])
        lin(p + ".mlp.fc1", blk["fc1"])
        lin(p + ".mlp.fc2", blk["fc2"])
        sd[p + ".ls1.gamma"] = t(blk["ls1"])
        sd[p + ".ls2.gamma"] = t(blk["ls2"])
    ln("backbone.norm", params["norm"])
    head = params["head"]
    for i in range(len(cfg.out_layers)):
        conv(f"head.projects.{i}", head["projects"][i])
        conv(f"head.upsample_blocks.{i}", head["upsample_blocks"][i])
    conv("head.output_block.0", head["output_block"]["conv1"])
    conv("head.output_block.2", head["output_block"]["conv2"])
    return sd


def canonical_state_dict(state_dict: Dict[str, torch.Tensor],
                         cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """A MoGe / DINOv2 checkpoint in the layouts the JAX package's
    ``convert_torch_state_dict`` accepts, renamed to ``MoGe``'s keys: a
    ``model.`` wrapper prefix stripped, a bare encoder put under
    ``backbone.``, head convolutions given as bare convs or Sequential
    index 0, the output block's first and last convolutions as 0 and 2,
    absent LayerScale gammas as ones, and keys outside the schema dropped.
    Without ``head.*`` keys (a bare encoder cannot predict depth) it raises
    ``KeyError``."""
    sd = {(k[6:] if k.startswith("model.") else k): torch.as_tensor(v)
          for k, v in state_dict.items()}
    if not any(k.startswith("backbone.") for k in sd):
        sd = {(k if k.startswith("head.") else "backbone." + k): v for k, v in sd.items()}
    out = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    for i in range(cfg.depth):
        for ls in ("ls1", "ls2"):
            out.setdefault(f"backbone.blocks.{i}.{ls}.gamma", torch.ones(cfg.width))
    if not any(k.startswith("head.") for k in sd):
        raise KeyError("checkpoint contains no head.* keys: a bare encoder cannot predict "
                       "depth")
    for i in range(len(cfg.out_layers)):
        for part in ("projects", "upsample_blocks"):
            p = f"head.{part}.{i}"
            src = p if p + ".weight" in sd else p + ".0"
            out[p + ".weight"], out[p + ".bias"] = sd[src + ".weight"], sd[src + ".bias"]
    idx = sorted({int(k.split(".")[2]) for k in sd
                  if k.startswith("head.output_block.") and k.endswith(".weight")})
    if len(idx) < 2:
        raise KeyError(f"head.output_block has {len(idx)} conv(s); expected 2 (3x3 + 1x1)")
    for dst, src in ((0, idx[0]), (2, idx[-1])):
        for leaf in ("weight", "bias"):
            out[f"head.output_block.{dst}.{leaf}"] = sd[f"head.output_block.{src}.{leaf}"]
    with torch.device("meta"):
        keys = set(MoGe(cfg).state_dict())
    return {k: v for k, v in out.items() if k in keys}


# ----------------------------------------------------------------------------
# The IDU-facing backend
# ----------------------------------------------------------------------------

class MoGePredictor:
    """Depth backend (the reference's MoGeIDU interface): frames are area
    resized to about ``img_size``^2 pixels with each side a patch multiple
    (keeping their aspect), run in batches, and the depth is resized back
    bilinearly to the frame.

    Weights come from ``model`` (a ``MoGe``), ``state_dict`` (MoGe keys),
    ``params`` (the JAX package's pytree) or ``checkpoint_path`` (a local
    torch checkpoint in a layout ``canonical_state_dict`` accepts); with
    none of them construction raises ``RuntimeError``.
    """

    def __init__(self, save_path: Optional[str] = None, fov_x: float = 60.0,
                 checkpoint_path: Optional[str] = None, cfg: ViTConfig = ViTConfig(),
                 params=None, model: Optional[MoGe] = None, state_dict=None,
                 device="cuda", **_):
        self.cfg = cfg
        self.fov_x = fov_x
        self.save_path = save_path
        self.device = torch.device(device)
        if model is None:
            if params is not None:
                state_dict = state_from_numpy(params, cfg)
            elif checkpoint_path is not None:
                sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
                state_dict = canonical_state_dict(sd.get("model", sd), cfg)
            if state_dict is None:
                raise RuntimeError(
                    "MoGe weights were not given. Pass checkpoint_path=<local torch "
                    "checkpoint>, state_dict=, params= or model=, or use the 'render' "
                    "depth backend.")
            from skyfall_gs_tpu_torch.priors.flux import build_module

            model = build_module(MoGe, cfg, device=self.device, seed=None)
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval()
        self.device = next(model.parameters()).device

    def _target_hw(self, img) -> tuple:
        """~img_size^2 pixels, each side a patch multiple, aspect kept."""
        h, w = np.asarray(img).shape[:2]
        ps = self.cfg.patch_size
        scale = self.cfg.img_size / math.sqrt(h * w)
        return (max(ps, int(round(h * scale / ps)) * ps),
                max(ps, int(round(w * scale / ps)) * ps))

    def _prep(self, img) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        return cv2_resize(x, self._target_hw(img), "area")

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return self.run([image])[0]

    @torch.no_grad()
    def run(self, images: Sequence[np.ndarray], batch_size: int = 8,
            **_) -> List[np.ndarray]:
        out: List[Optional[np.ndarray]] = [None] * len(images)
        groups: Dict[tuple, List[int]] = {}
        for i, im in enumerate(images):
            groups.setdefault(self._target_hw(im), []).append(i)
        for _, idxs in groups.items():
            for j in range(0, len(idxs), batch_size):
                sel = idxs[j:j + batch_size]
                depths = moge_depth(self.model, torch.stack([self._prep(images[i])
                                                             for i in sel]))
                for i, d in zip(sel, depths):
                    hw = np.asarray(images[i]).shape[:2]
                    out[i] = cv2_resize(d, hw, "linear").cpu().numpy()
        return out
