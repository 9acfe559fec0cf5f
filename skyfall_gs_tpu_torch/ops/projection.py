"""EWA projection of 3D Gaussians to screen space (Mip-Splatting variant).

Port of ``skyfall_gs_tpu/ops/projection.py``: perspective projection
through the full projection matrix (principal-point aware), the EWA
Jacobian with frustum-clamped focal terms, the screen-space dilation
``cov2d += kernel_size * I`` with the ``sqrt(det0/det1)`` opacity
compensation, the 3-sigma radius, the exact cutoff AABB ``radius_xy`` and
near-plane culling at z > 0.2.

``project_gaussians_torch`` is the plain version: tensor code, gradients
from torch autograd.  ``csrc/projection.cu`` computes the same per splat in
registers, one kernel for the forward and one for the backward (its source
note says why and what bounds it); ``_Projection`` wraps the pair as an
autograd Function that saves only its inputs.  ``project_gaussians`` routes
by what its inputs show:

- CUDA tensors with ``cov3d=None`` launch the kernels (the forward alone
  where no gradient is asked for); the kernels take float32 means (N, 3),
  scales (N, 3), quaternions (N, 4), opacities (N,), a bool mask (N,) or
  None and a camera whose tensors are float32 on the same device, and
  raise ``ValueError`` on anything else;
- CPU tensors, or a given ``cov3d``, run the plain version.

``project_gaussians.launches`` and ``project_gaussians.backward_launches``
count the kernels' launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from skyfall_gs_tpu_torch.core.camera import FRUSTUM_CLAMP, Camera, clamp_window
from skyfall_gs_tpu_torch.core.transforms import (
    covariance_from_scaling_rotation,
    quat_to_rotmat,
)
from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

NEAR_CULL_Z = 0.2


@dataclass
class ProjectedGaussians:
    """Screen-space quantities for one camera view (all (N,) or (N, k))."""

    mean2d: torch.Tensor        # (N, 2) pixel coordinates of the center
    conic: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor         # (N,) camera-space z
    radius: torch.Tensor        # (N,) int32 3-sigma screen radius; 0 = culled
    opacity: torch.Tensor       # (N,) opacity incl. mip 2D compensation
    compensation: torch.Tensor  # (N,) the sqrt(det0/det1) factor itself
    # (N, 2) int32 half-extents of the alpha >= 1/255 cutoff ellipse's AABB
    # (uncapped sigma multiplier, +0.5 px); binning's touched-tile rect.
    radius_xy: torch.Tensor


def perspective_project(means3d: torch.Tensor, camera: Camera):
    """World points -> (pixel coordinates (N, 2), view-space z (N,))."""
    ones = torch.ones_like(means3d[:, :1])
    hom = torch.cat([means3d, ones], dim=-1)
    clip = hom @ camera.full_proj.T                      # (N, 4)
    w = 1.0 / (clip[:, 3] + 1e-7)
    ndc = clip[:, :2] * w[:, None]
    pix_x = ((ndc[:, 0] + 1.0) * float(camera.width) - 1.0) * 0.5
    pix_y = ((ndc[:, 1] + 1.0) * float(camera.height) - 1.0) * 0.5
    z_view = hom @ camera.world_view[2]
    return torch.stack([pix_x, pix_y], dim=-1), z_view


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor, camera: Camera,
                  kernel_size: float):
    """EWA: 3D covariances -> dilated 2D screen covariances.

    Returns (cov2d (N, 2, 2) after dilation, det_dilated (N,),
    compensation (N,)).
    """
    wv = camera.world_view
    t = means3d @ wv[:3, :3].T + wv[:3, 3]
    tz = torch.clamp_min(t[:, 2], 1e-6)
    lo_x, hi_x, lo_y, hi_y = clamp_window(camera)
    tx = torch.clamp(t[:, 0] / tz, lo_x, hi_x) * tz
    ty = torch.clamp(t[:, 1] / tz, lo_y, hi_y) * tz

    fx, fy = camera.focal_x, camera.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    r = wv[:3, :3]
    v = r @ cov3d @ r.T                                  # R Σ Rᵀ (N, 3, 3)

    c00 = j00 * j00 * v[:, 0, 0] + 2.0 * j00 * j02 * v[:, 0, 2] + j02 * j02 * v[:, 2, 2]
    c01 = (j00 * j11 * v[:, 0, 1] + j00 * j12 * v[:, 0, 2]
           + j02 * j11 * v[:, 1, 2] + j02 * j12 * v[:, 2, 2])
    c11 = j11 * j11 * v[:, 1, 1] + 2.0 * j11 * j12 * v[:, 1, 2] + j12 * j12 * v[:, 2, 2]

    det0 = c00 * c11 - c01 * c01
    c00d = c00 + kernel_size
    c11d = c11 + kernel_size
    det1 = c00d * c11d - c01 * c01
    # Bounded-gradient sqrt: det0 of a thin splat cancels to anywhere in
    # [-eps, eps]; sqrt'(x) is ~1e6 at 1e-12 and inf at 0, and on a live
    # splat that reaches Adam as NaN.  Floor the argument at 1e-6 and zero
    # the forward below it (comp < 1e-3 is invisible either way).
    ratio = det0 / torch.clamp_min(det1, 1e-12)
    compensation = torch.where(
        ratio > 1e-6, torch.sqrt(torch.clamp_min(ratio, 1e-6)),
        torch.zeros_like(ratio))
    cov2d = torch.stack(
        [torch.stack([c00d, c01], dim=-1), torch.stack([c01, c11d], dim=-1)], dim=-2)
    return cov2d, det1, compensation


def project_gaussians_torch(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    camera: Camera,
    kernel_size: float = 0.1,
    mask: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
    cov3d: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Full projection stage: 3D Gaussian state -> screen-space splats (the
    plain version).

    Args:
        means3d: (N, 3) world positions.
        scales: (N, 3) positive scales (activated, incl. 3D filter).
        quats: (N, 4) wxyz rotations (not necessarily normalized).
        opacities: (N,) opacities in [0, 1] (incl. 3D-filter compensation).
        kernel_size: Mip-Splatting 2D dilation.
        mask: (N,) optional alive mask — dead entries get radius 0.
        cov3d: optional precomputed (N, 3, 3) covariances.
    """
    # Culled splats (dead slots, behind-camera points, z ~ 0) can make inf
    # in the projective divisions; a zero cotangent times inf is NaN, which
    # would reach live parameters.  Replace culled inputs with a benign
    # splat one unit in front of the camera before any division; culling
    # itself still uses the real depth.
    wv = camera.world_view
    depth_true = means3d @ wv[2, :3] + wv[2, 3]
    keep = depth_true > NEAR_CULL_Z
    if mask is not None:
        keep = keep & mask
    safe_point = camera.cam_center + wv[2, :3]
    means3d = torch.where(keep[:, None], means3d, safe_point[None, :])
    # Extreme transient scales overflow f32 determinants.
    scales = torch.clamp_max(scales, 1e4)
    if cov3d is None:
        cov3d = covariance_from_scaling_rotation(scales, quats, scaling_modifier)
    mean2d, depth = perspective_project(means3d, camera)
    cov2d, det, compensation = compute_cov2d(means3d, cov3d, camera, kernel_size)
    depth = torch.where(keep, depth_true, depth)

    inv_det = 1.0 / torch.clamp_min(det, 1e-12)
    conic = torch.stack(
        [cov2d[:, 1, 1] * inv_det, -cov2d[:, 0, 1] * inv_det, cov2d[:, 0, 0] * inv_det],
        dim=-1)

    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    # Opacity-adaptive extent: beyond sigma * sqrt(2 ln(255 op)) every pixel
    # fails the alpha >= 1/255 test.  The stats radius keeps the 3-sigma cap.
    op_eff = torch.clamp(opacities * compensation, 1e-12, 1.0)
    log_term = torch.clamp_min(2.0 * torch.log(255.0 * op_eff), 1e-6)
    sigma_mult = torch.clamp_max(torch.sqrt(log_term), 3.0)
    radius = torch.ceil(sigma_mult * torch.sqrt(lam1))
    sm_exact = torch.sqrt(log_term)
    rx = torch.ceil(sm_exact * torch.sqrt(torch.clamp_min(cov2d[:, 0, 0], 0.0)) + 0.5)
    ry = torch.ceil(sm_exact * torch.sqrt(torch.clamp_min(cov2d[:, 1, 1], 0.0)) + 0.5)

    visible = keep & (det > 0.0) & (op_eff >= 1.0 / 255.0)
    width, height = float(camera.width), float(camera.height)
    on_screen = (
        (mean2d[:, 0] + rx >= 0.0)
        & (mean2d[:, 0] - rx < width)
        & (mean2d[:, 1] + ry >= 0.0)
        & (mean2d[:, 1] - ry < height)
    )
    visible = visible & on_screen
    if mask is not None:
        visible = visible & mask
    zero = torch.zeros_like(radius)
    radius_i = torch.where(visible, radius, zero).detach().to(torch.int32)
    radius_xy = torch.where(visible[:, None], torch.stack([rx, ry], dim=1),
                            zero[:, None]).detach().to(torch.int32)

    return ProjectedGaussians(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=radius_i,
        opacity=opacities * compensation,
        compensation=compensation,
        radius_xy=radius_xy,
    )


# ----------------------------------------------------------------------------
# The kernels (csrc/projection.cu) and their routing
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(rt.build_library("projection")))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    camera = [ptr] * 9 + [i32] + [f32] * 9
    lib.skyfall_project_fwd.argtypes = camera + [i32] + [ptr] * 12 + [ptr]
    lib.skyfall_project_fwd.restype = i32
    lib.skyfall_project_bwd.argtypes = camera + [i32] + [ptr] * 5 + [ptr, i64] * 5 + [ptr] * 5
    lib.skyfall_project_bwd.restype = i32
    return lib


def _camera_args(camera: Camera, device: torch.device, kernel_size: float,
                 scaling_modifier: float) -> list:
    """The camera arguments of both kernels: pointers to the camera's device
    tensors (no host read), its clamp window where it fixes one, the frame's
    size, the dilation and the scale modifier."""
    tensors = {"world_view": 16, "full_proj": 16, "cam_center": 3, "focal_x": 1,
               "focal_y": 1, "tan_fovx": 1, "tan_fovy": 1, "cx": 1, "cy": 1}
    ptrs = []
    for name, size in tensors.items():
        t = getattr(camera, name)
        if t.dtype != torch.float32 or t.device != device or t.numel() != size \
                or not t.is_contiguous():
            raise ValueError(
                f"camera.{name}: expected {size} contiguous float32 on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    window = camera.clamp_window
    return ptrs + [int(window is not None)] + [float(v) for v in window or (0.0,) * 4] + [
        FRUSTUM_CLAMP, float(camera.width), float(camera.height), float(kernel_size),
        float(scaling_modifier)]


def _kernel_inputs(means3d, scales, quats, opacities, mask) -> tuple:
    n, dev = means3d.shape[0], means3d.device
    for name, x, shape in (("means3d", means3d, (n, 3)), ("scales", scales, (n, 3)),
                           ("quats", quats, (n, 4)), ("opacities", opacities, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != dev:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (n,)
                             or mask.device != dev):
        raise ValueError(f"mask: expected bool ({n},) on {dev}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if n >= 2**31:
        raise ValueError(f"{n} splats: the kernels index them with int32")
    quats = quats.contiguous()
    if quats.data_ptr() % 16:                       # the kernels read a row as one float4
        quats = quats.clone()
    return (means3d.contiguous(), scales.contiguous(), quats, opacities.contiguous(),
            None if mask is None else mask.contiguous())


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _cotangent(g) -> tuple:
    """(tensor, row stride) of a cotangent with unit stride within a row;
    None is zero."""
    if g is None:
        return None, 0
    if g.dim() == 2 and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


class _Projection(torch.autograd.Function):
    """The projection's kernels: the forward launches ``skyfall_project_fwd``,
    the backward ``skyfall_project_bwd``, which recomputes the forward from
    the saved inputs.  ``radius`` and ``radius_xy`` carry no gradient."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, mask, camera, kernel_size,
                scaling_modifier):
        inputs = _kernel_inputs(means3d, scales, quats, opacities, mask)
        dev, n = means3d.device, means3d.shape[0]
        cam = _camera_args(camera, dev, kernel_size, scaling_modifier)
        f32 = dict(dtype=torch.float32, device=dev)
        mean2d, conic = torch.empty((n, 2), **f32), torch.empty((n, 3), **f32)
        depth, opacity, comp = (torch.empty(n, **f32) for _ in range(3))
        radius = torch.empty(n, dtype=torch.int32, device=dev)
        radius_xy = torch.empty((n, 2), dtype=torch.int32, device=dev)
        project_gaussians.launches += 1
        with torch.cuda.device(dev):
            rc = _library().skyfall_project_fwd(
                *cam, n, *map(_ptr, inputs), mean2d.data_ptr(), conic.data_ptr(),
                depth.data_ptr(), radius.data_ptr(), opacity.data_ptr(), comp.data_ptr(),
                radius_xy.data_ptr(), rt._stream_ptr(dev))
        if rc != 0:
            raise RuntimeError(f"skyfall_project_fwd launch failed: cudaError {rc}")
        ctx.save_for_backward(*inputs)
        ctx.camera, ctx.kernel_size, ctx.scaling_modifier = camera, kernel_size, scaling_modifier
        ctx.mark_non_differentiable(radius, radius_xy)
        ctx.set_materialize_grads(False)
        return mean2d, conic, depth, radius, opacity, comp, radius_xy

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, _g_radius, g_opacity, g_comp, _g_radius_xy):
        means3d, scales, quats, opacities, mask = ctx.saved_tensors
        dev, n = means3d.device, means3d.shape[0]
        cam = _camera_args(ctx.camera, dev, ctx.kernel_size, ctx.scaling_modifier)
        cots = [_cotangent(g) for g in (g_mean2d, g_conic, g_depth, g_opacity, g_comp)]
        grads = [torch.empty_like(x) for x in (means3d, scales, quats, opacities)]
        project_gaussians.backward_launches += 1
        with torch.cuda.device(dev):
            rc = _library().skyfall_project_bwd(
                *cam, n, *map(_ptr, (means3d, scales, quats, opacities, mask)),
                *[v for g, stride in cots for v in (_ptr(g), stride)],
                *map(_ptr, grads), rt._stream_ptr(dev))
        if rc != 0:
            raise RuntimeError(f"skyfall_project_bwd launch failed: cudaError {rc}")
        return (*grads, None, None, None, None)


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    camera: Camera,
    kernel_size: float = 0.1,
    mask: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
    cov3d: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Full projection stage: 3D Gaussian state -> screen-space splats.  The
    kernels for CUDA tensors with ``cov3d=None``, else
    ``project_gaussians_torch`` (the module docstring gives the rule); the
    arguments are the plain version's."""
    if not means3d.is_cuda or cov3d is not None:
        return project_gaussians_torch(means3d, scales, quats, opacities, camera,
                                       kernel_size=kernel_size, mask=mask,
                                       scaling_modifier=scaling_modifier, cov3d=cov3d)
    mean2d, conic, depth, radius, opacity, comp, radius_xy = _Projection.apply(
        means3d, scales, quats, opacities, mask, camera, kernel_size, scaling_modifier)
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=depth, radius=radius,
                              opacity=opacity, compensation=comp, radius_xy=radius_xy)


project_gaussians.launches = 0
project_gaussians.backward_launches = 0


def smallest_axis_normals(scales: torch.Tensor, quats: torch.Tensor,
                          means3d: torch.Tensor, cam_center: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian normal: the principal axis with the smallest scale,
    sign-flipped to face the camera."""
    r = quat_to_rotmat(quats)                 # (N, 3, 3) columns are axes
    idx = torch.argmin(scales, dim=-1)
    axes = torch.take_along_dim(r, idx[:, None, None], dim=2)[..., 0]
    to_cam = cam_center[None, :] - means3d
    sign = torch.sign(torch.sum(axes * to_cam, dim=-1, keepdim=True))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    return axes * sign
