"""Real spherical-harmonics evaluation, degrees 0-3.

Port of ``skyfall_gs_tpu/core/sh.py``.  Coefficients are stored
``(..., C, K)`` with ``K = (deg_max+1)**2``, channel-major.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis at unit directions (..., 3) -> (..., (deg+1)**2)."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    b = [torch.full_like(x, SH_C0)]
    if deg >= 1:
        b += [-_C1 * y, _C1 * z, -_C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        b += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if deg >= 3:
        b += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(b, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH-encoded colors (..., C, K) at unit directions -> (..., C), without
    the +0.5 DC shift.  Coefficients beyond ``(deg+1)**2`` are ignored."""
    k = (deg + 1) ** 2
    basis = sh_basis(deg, dirs)
    return torch.sum(sh[..., :, :k] * basis[..., None, :], dim=-1)


def rgb_to_sh(rgb):
    """RGB color -> degree-0 SH coefficient (tensor or numpy)."""
    return (rgb - 0.5) / SH_C0
