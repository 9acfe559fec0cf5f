"""Gaussian point-cloud PLY snapshots.

Port of the standard format of ``skyfall_gs_tpu/io/gaussian_ply.py``:
``x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_* filter_3D`` for the
live slots, with the SH coefficients stored channel-major ((N, K, 3) ->
(N, 3, K) -> (N, 3K)), and the loader with SH-degree detection from the
``f_rest`` count.  The fused (filter-baked) export and ``.splat`` are not
ported yet.
"""

from __future__ import annotations

import numpy as np

from skyfall_gs_tpu_torch.io.ply import read_ply, write_ply
from skyfall_gs_tpu_torch.model.gaussians import GaussianModelState


def _props_from(xyz, f_dc_flat, f_rest_flat, opacity, scaling, rotation, filter_3d):
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
    props["filter_3D"] = filter_3d
    order.append("filter_3D")
    return props, order


def save_gaussian_ply(state: GaussianModelState, path: str) -> None:
    """Standard snapshot of the live slots, with the filter_3D attribute."""
    p = state.params
    keep = state.aux.alive.cpu().numpy()

    def host(t):
        return t.detach().cpu().numpy()[keep]

    xyz = host(p.xyz)
    n = len(xyz)

    def channel_major(f):
        return f.transpose(0, 2, 1).reshape(n, -1)

    props, order = _props_from(xyz, channel_major(host(p.features_dc)),
                               channel_major(host(p.features_rest)), host(p.opacity),
                               host(p.scaling), host(p.rotation),
                               host(state.aux.filter_3d))
    write_ply(path, props, order)


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
