"""The satellite city of the benchmark's splatting cells, drawn from a seed.

A frozen copy, at commit a752ef2, of the city recipe of
``skyfall_gs_tpu_torch/io/synthetic.py`` ``satellite_city`` (itself
``scripts/make_synthetic_satellite.py``'s: a ground disk and boxes of
buildings) with ``bench.py:56-66``'s satellite cameras, scaled to the
configuration's splat count, and of ``model/appearance.py``'s Fourier
position features and MLP initialisation.  The draws are torch's, on the
device, in a few large calls: the same seed on the same device gives the
same scene.  The splats are drawn as a scene past densification would hold
them (rotations, anisotropic scales, opacities and view-dependent colour all
varied), not as an initialisation.
"""

from __future__ import annotations

import math
import random

import torch

from frozen.paths import orbit_ring

SH_C0 = 0.28209479177387814


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _fourier(xyz: torch.Tensor, num_freqs: int) -> torch.Tensor:
    x = xyz - xyz.mean(0, keepdim=True)
    scale = torch.quantile(x.abs(), 0.97, dim=0)
    x = x / torch.clamp_min(scale, 1e-8) * 0.5 + 0.5
    freqs = torch.repeat_interleave(2.0 ** torch.arange(num_freqs, dtype=torch.float32,
                                                        device=xyz.device), 2)
    offsets = torch.tensor([0.0, 0.5 * math.pi] * num_freqs, device=xyz.device)
    return torch.sin(x[..., None] * freqs * 2.0 * math.pi + offsets).reshape(xyz.shape[0], -1)


def draw_splats(cfg: dict, seed: int, device) -> dict:
    """Every parameter leaf of the scene as nested dicts of float32 tensors,
    with the configuration's appearance sizes."""
    n = int(cfg["n_splats"])
    city, init, app = cfg["city"], cfg["init"], cfg["appearance"]
    m = int(cfg["train_views"]["count"])
    k_rest = (int(cfg["sh_degree"]) + 1) ** 2 - 1
    f_emb = 6 * int(app["n_fourier_freqs"])
    d_cam, hidden = int(app["embedding_dim"]), int(app["hidden"])
    g = generator(seed, device)
    nb = int(city["buildings"])
    bld = torch.rand((nb, 3), generator=g, device=device)
    u = torch.rand((n, 7), generator=g, device=device)
    z = torch.randn((n, 11 + 3 * k_rest + f_emb), generator=g, device=device)

    ng = n // 2
    r = city["ground_radius"] * torch.sqrt(u[:ng, 0])
    th = 2.0 * math.pi * u[:ng, 1]
    ground = torch.stack([r * torch.cos(th), r * torch.sin(th), 0.5 * z[:ng, 0]], 1)
    half = city["building_extent"]
    centers = (bld[:, :2] * 2.0 - 1.0) * half
    heights = city["height_min"] + (city["height_max"] - city["height_min"]) * bld[:, 2]
    b = torch.clamp((u[ng:, 2] * nb).long(), max=nb - 1)
    sd = city["building_sd"]
    towers = torch.stack([centers[b, 0] + sd * z[ng:, 1], centers[b, 1] + sd * z[ng:, 2],
                          heights[b] * u[ng:, 3]], 1)
    xyz = torch.cat([ground, towers])
    rgb = 0.15 + 0.7 * u[:, 4:7]

    c = 3
    quat = z[:, c:c + 4]
    c += 4
    scaling = math.log(init["scale"]) + init["log_scale_sd"] * z[:, c:c + 3]
    c += 3
    opacity = init["opacity_logit_mean"] + init["opacity_logit_sd"] * z[:, c:c + 1]
    c += 1
    rest = init["sh_rest_sd"] * z[:, c:c + 3 * k_rest].reshape(n, k_rest, 3)
    c += 3 * k_rest
    emb = _fourier(xyz, int(app["n_fourier_freqs"])) + 1e-4 * z[:, c:c + f_emb]

    n_in = d_cam + 3 + f_emb
    sizes = [(n_in, hidden), (hidden, hidden), (hidden, 6)]
    flat = torch.rand(sum(a * o + o for a, o in sizes), generator=g, device=device)
    mlp, at = {}, 0
    for i, (a, o) in enumerate(sizes):
        bound = 1.0 / math.sqrt(a)
        w = (flat[at:at + a * o].reshape(a, o) * 2.0 - 1.0) * bound
        at += a * o
        mlp[f"l{i}"] = {"b": (flat[at:at + o] * 2.0 - 1.0) * bound, "w": w}
        at += o
    return {
        "xyz": xyz.contiguous(),
        "features_dc": ((rgb - 0.5) / SH_C0).reshape(n, 1, 3),
        "features_rest": rest.contiguous(),
        "scaling": scaling.contiguous(),
        "rotation": quat.contiguous(),
        "opacity": opacity.contiguous(),
        "embeddings": emb.contiguous(),
        "appearance_embeddings": 0.01 * torch.randn((m, d_cam), generator=g, device=device),
        "appearance_mlp": mlp,
    }


def train_poses(cfg: dict) -> list:
    """``(c2w, fov)`` of each training view: the satellite ring."""
    v = cfg["train_views"]
    fov = math.radians(v["fov_deg"])
    return [(c2w, fov) for c2w in orbit_ring((0.0, 0.0, 0.0), v["elevation_deg"],
                                             v["radius"], int(v["count"]))]


def draw_targets(cfg: dict, seed: int, device) -> tuple:
    """Ground truth of each training view: smooth random images (M, H, W, 3)
    in [0, 1], masks of ones and smooth random depths (M, H, W), drawn at
    1/16 of the size and upsampled bilinearly."""
    v = cfg["train_views"]
    m, s = int(v["count"]), int(v["size"])
    g = generator(seed + 1, device)
    lo = torch.rand((m, 4, max(s // 16, 2), max(s // 16, 2)), generator=g, device=device)
    up = torch.nn.functional.interpolate(lo, size=(s, s), mode="bilinear",
                                         align_corners=False)
    images = up[:, :3].permute(0, 2, 3, 1).contiguous()
    depths = (v["radius"] - 100.0 + 200.0 * up[:, 3]).contiguous()
    return images, torch.ones((m, s, s), device=device), depths


def view_picks(rng_seed: int, n_views: int, count: int) -> list:
    """The training views of the first ``count`` iterations, as the Trainer
    draws them (``train/loop.py`` ``_pick_view`` at commit a752ef2: one
    ``random.Random(rng_seed).choice`` over the flat view index per
    iteration; one resolution group, no high-resolution resampling, no
    pseudo views)."""
    rng = random.Random(rng_seed)
    index = list(range(n_views))
    return [rng.choice(index) for _ in range(count)]
