"""Gaussian point-cloud exports: PLY snapshots (standard and fused) and
``.splat``.

Port of ``skyfall_gs_tpu/io/gaussian_ply.py``:
  * the standard snapshot ``x y z nx ny nz f_dc_* f_rest_* opacity
    scale_* rot_* filter_3D`` of the live slots, with the SH coefficients
    stored channel-major ((N, K, 3) -> (N, 3, K) -> (N, 3K));
  * the fused, viewer-compatible PLY: the 3D filter baked into scales and
    opacity (and optionally the appearance MLP into the SH colours, with
    the test-time embedding ``min(6, M-1)``), no ``filter_3D``;
  * ``.splat``, 32 bytes per splat for browser viewers, and its reader;
  * the loader, with SH-degree detection from the ``f_rest`` count.
"""

from __future__ import annotations

import numpy as np
import torch

from skyfall_gs_tpu_torch.io.ply import read_ply, write_ply
from skyfall_gs_tpu_torch.model.appearance import apply_appearance
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianModelState,
    opacity_with_3d_filter,
    scaling_with_3d_filter,
)
from skyfall_gs_tpu_torch.utils.general import inverse_sigmoid


def _props_from(xyz, f_dc_flat, f_rest_flat, opacity, scaling, rotation, filter_3d=None):
    n = xyz.shape[0]
    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
             "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
             "nz": np.zeros(n, np.float32)}
    order = ["x", "y", "z", "nx", "ny", "nz"]

    def add(prefix, cols):
        for i in range(cols.shape[1]):
            props[f"{prefix}_{i}"] = cols[:, i]
            order.append(f"{prefix}_{i}")

    add("f_dc", f_dc_flat)
    add("f_rest", f_rest_flat)
    props["opacity"] = opacity[:, 0]
    order.append("opacity")
    add("scale", scaling)
    add("rot", rotation)
    if filter_3d is not None:
        props["filter_3D"] = filter_3d
        order.append("filter_3D")
    return props, order


def _channel_major(f: np.ndarray) -> np.ndarray:
    """(N, K, 3) -> (N, 3K), channel-major."""
    return f.transpose(0, 2, 1).reshape(len(f), -1)


def save_gaussian_ply(state: GaussianModelState, path: str) -> None:
    """Standard snapshot of the live slots, with the filter_3D attribute."""
    p = state.params
    keep = state.aux.alive.cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()[keep]

    props, order = _props_from(host(p.xyz), _channel_major(host(p.features_dc)),
                               _channel_major(host(p.features_rest)), host(p.opacity),
                               host(p.scaling), host(p.rotation),
                               host(state.aux.filter_3d))
    write_ply(path, props, order)


@torch.no_grad()
def save_fused_ply(state: GaussianModelState, path: str, color_mapped: bool = False) -> None:
    """Viewer-compatible export with the 3D filter baked in."""
    p = state.params
    keep = state.aux.alive.cpu().numpy()

    def host(t):
        return t.cpu().numpy()[keep]

    if state.appearance.enabled and color_mapped and p.appearance_mlp is not None:
        emb = p.appearance_embeddings[min(p.appearance_embeddings.shape[0] - 1, 6)]
        toned = host(torch.clamp_max(
            apply_appearance(p.appearance_mlp, p.embeddings, emb, p.features), 1.0))
        f_dc, f_rest = _channel_major(toned[:, :1]), _channel_major(toned[:, 1:])
    else:
        f_dc, f_rest = _channel_major(host(p.features_dc)), _channel_major(host(p.features_rest))
    f3d = state.aux.filter_3d
    op_fused = host(inverse_sigmoid(torch.clamp(opacity_with_3d_filter(p, f3d),
                                                1e-7, 1 - 1e-7)))[:, None]
    scale_fused = host(torch.log(scaling_with_3d_filter(p, f3d)))
    props, order = _props_from(host(p.xyz), f_dc, f_rest, op_fused, scale_fused,
                               host(p.rotation))
    write_ply(path, props, order)


SH_C0 = 0.28209479177387814


@torch.no_grad()
def save_splat(state: GaussianModelState, path: str) -> None:
    """Export to the ``.splat`` web-viewer format.

    32 bytes per splat: position f32x3, LINEAR scale f32x3 (3D filter
    baked, like the fused PLY), colour rgba u8x4 (SH band 0 -> rgb, fused
    opacity -> alpha), rotation u8x4 (normalized quaternion, component * 128
    + 128, in the PLY rot_0..rot_3 order).  Splats are sorted by descending
    opacity x volume so progressive loaders draw the dominant structure
    first.
    """
    p = state.params
    keep = state.aux.alive.cpu().numpy()

    def host(t):
        return t.cpu().numpy()[keep].astype(np.float32)

    xyz = host(p.xyz)
    scale = host(scaling_with_3d_filter(p, state.aux.filter_3d))
    opac = host(opacity_with_3d_filter(p, state.aux.filter_3d))
    rgb = 0.5 + SH_C0 * p.features_dc.cpu().numpy()[keep][:, 0, :]
    quat = host(p.rotation)
    quat = quat / np.maximum(np.linalg.norm(quat, axis=1, keepdims=True), 1e-12)

    order = np.argsort(-opac * scale.prod(axis=1))
    n = xyz.shape[0]
    rec = np.zeros((n, 32), np.uint8)
    rec[:, 0:12] = xyz[order].view(np.uint8).reshape(n, 12)
    rec[:, 12:24] = scale[order].view(np.uint8).reshape(n, 12)
    rec[:, 24:27] = np.clip(rgb[order] * 255.0, 0, 255).astype(np.uint8)
    rec[:, 27] = np.clip(opac[order] * 255.0, 0, 255).astype(np.uint8)
    rec[:, 28:32] = np.clip(quat[order] * 128.0 + 128.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def load_splat(path: str) -> dict:
    """Read a .splat file back into float arrays."""
    raw = np.fromfile(path, np.uint8)
    if raw.size % 32:
        raise ValueError(f"{path}: size {raw.size} is not a multiple of 32")
    rec = raw.reshape(-1, 32)
    return {
        "xyz": rec[:, 0:12].copy().view(np.float32),
        "scale": rec[:, 12:24].copy().view(np.float32),
        "rgb": rec[:, 24:27].astype(np.float32) / 255.0,
        "opacity": rec[:, 27].astype(np.float32) / 255.0,
        "rotation": (rec[:, 28:32].astype(np.float32) - 128.0) / 128.0,
    }


def detect_sh_degree(props: dict) -> int:
    n_rest = len([k for k in props if k.startswith("f_rest_")])
    k_total = n_rest // 3 + 1
    deg = int(round(k_total ** 0.5)) - 1
    if (deg + 1) ** 2 != k_total:
        raise ValueError(f"f_rest count {n_rest} is not a valid SH layout")
    return deg


def load_gaussian_ply(path: str) -> dict:
    """Load a (standard or fused) gaussian PLY.

    Returns:
        dict with numpy arrays xyz (N,3), features_dc (N,1,3), features_rest
        (N,K-1,3), opacity (N,1), scaling (N,3), rotation (N,4), filter_3d
        (N,) or None, and sh_degree.
    """
    v = read_ply(path)
    n = len(v["x"])
    deg = detect_sh_degree(v)
    k = (deg + 1) ** 2

    def stack(names):
        return np.stack([v[name] for name in names], axis=1).astype(np.float32)

    rest_names = sorted((name for name in v if name.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    filter_3d = v.get("filter_3D")
    return {
        "xyz": stack(["x", "y", "z"]),
        "features_dc": stack([f"f_dc_{i}" for i in range(3)]).reshape(n, 3, 1)
        .transpose(0, 2, 1),
        "features_rest": stack(rest_names).reshape(n, 3, k - 1).transpose(0, 2, 1),
        "opacity": v["opacity"].reshape(n, 1).astype(np.float32),
        "scaling": stack([f"scale_{i}" for i in range(3)]),
        "rotation": stack([f"rot_{i}" for i in range(4)]),
        "filter_3d": None if filter_3d is None else filter_3d.astype(np.float32),
        "sh_degree": deg,
    }
