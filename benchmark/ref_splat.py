"""Plain PyTorch reference of the Gaussian-splatting paths the benchmark times.

It follows the published method (3D Gaussian Splatting, Kerbl et al. 2023;
Mip-Splatting's 3D filter and 2D dilation with its opacity compensation, Yu
et al. 2024; a WildGaussians-style per-image appearance MLP) with the
numerics of ``skyfall_gs_tpu_torch`` at commit a752ef2: ``core/camera.py``,
``core/transforms.py``, ``core/sh.py``, ``model/appearance.py``,
``model/gaussians.py``, ``ops/projection.py``, ``ops/binning.py``,
``ops/rasterize_ref.py``, ``ops/ssim.py``, ``ops/losses.py``,
``model/optim.py`` and ``utils/general.py`` were transcribed, not imported.
It imports nothing of the program.  From the benchmark's own inputs it works
out again whatever the program derives: the camera matrices from the
camera-to-world poses, the 3D filter from the training cameras, its own tile
lists by its own binning, and the gradients by autograd.

Compositing walks each tile's depth-sorted list in chunks of entries,
vectorized over tiles, entries and pixels, with the transmittance of a chunk
as a cumulative product: the same rules as the kernels (alpha = min(0.99,
op exp(power)), skip power > 0 or alpha < 1/255, stop before the entry that
takes T under 1e-4, nothing resumes), in another float order.

Precision is float32 with TF32 off.  ``Precision(tf32=True)`` rounds the
inputs of every matrix product and convolution to TF32's 11 significant
bits: the control that ``correct`` must reject.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

TILE = 16
P = TILE * TILE
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR_CULL_Z = 0.2
FRUSTUM_CLAMP = 1.3
SH_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest (ties to even) at TF32's 11 significant bits."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


@dataclass(frozen=True)
class Precision:
    tf32: bool = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        # Rounded forward, identity backward: the backward products read the
        # rounded values autograd saved.
        return x + (round_tf32(x) - x).detach() if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


FP32 = Precision()
TF32 = Precision(tf32=True)


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ----------------------------------------------------------------------------
# Cameras
# ----------------------------------------------------------------------------

@dataclass
class RefCamera:
    world_view: torch.Tensor   # (4, 4) world -> camera
    full_proj: torch.Tensor    # (4, 4) world -> clip
    center: torch.Tensor       # (3,)
    tan_fovx: float
    tan_fovy: float
    focal_x: float
    focal_y: float
    width: int
    height: int
    uid: int


def ref_camera(c2w: np.ndarray, fov_x: float, fov_y: float, width: int, height: int,
               uid: int, device, znear: float = 0.01, zfar: float = 100.0) -> RefCamera:
    """A pinhole camera from a COLMAP-convention camera-to-world pose (float64
    on the host, float32 on ``device``); principal point at the centre."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    tx, ty = math.tan(fov_x / 2.0), math.tan(fov_y / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return RefCamera(world_view=t(w2c), full_proj=t(proj @ w2c),
                     center=t(np.linalg.inv(w2c)[:3, 3]), tan_fovx=tx, tan_fovy=ty,
                     focal_x=width / (2.0 * tx), focal_y=height / (2.0 * ty),
                     width=int(width), height=int(height), uid=int(uid))


# ----------------------------------------------------------------------------
# Splat activations, colours, 3D filter
# ----------------------------------------------------------------------------

def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def filtered_scales_opacity(p: dict, filter_3d: torch.Tensor):
    """Scales sqrt(s^2 + f^2) and opacities sigmoid(o) sqrt(det s^2 / det(s^2 + f^2))
    (the coefficient floored as the program floors it)."""
    s2 = torch.exp(p["scaling"]) ** 2
    f2 = filter_3d[:, None] ** 2
    det1 = torch.prod(s2, 1)
    det2 = torch.prod(s2 + f2, 1)
    ratio = det1 / torch.clamp_min(det2, 1e-30)
    coef = torch.where(ratio > 1e-12, torch.sqrt(torch.clamp_min(ratio, 1e-12)),
                       torch.zeros_like(ratio))
    return torch.sqrt(s2 + f2), torch.sigmoid(p["opacity"][:, 0]) * coef


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    x, y, z = dirs.unbind(-1)
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, SH_C0), -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * xy, _C2[1] * yz, _C2[2] * (2 * zz - xx - yy), _C2[3] * xz, _C2[4] * (xx - yy),
        _C3[0] * y * (3 * xx - yy), _C3[1] * xy * z, _C3[2] * y * (4 * zz - xx - yy),
        _C3[3] * z * (2 * zz - 3 * xx - 3 * yy), _C3[4] * x * (4 * zz - xx - yy),
        _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3 * yy)], -1)


def colors(p: dict, cam: RefCamera, cam_embedding: torch.Tensor,
           prec: Precision = FP32) -> torch.Tensor:
    """Per-splat RGB for ``cam``: the appearance MLP tones the degree-3 SH
    coefficients with ``cam_embedding``, then SH + 0.5, clamped at 0."""
    n = p["xyz"].shape[0]
    feats = torch.cat([p["features_dc"], p["features_rest"]], 1)       # (N, 16, 3)
    flat = torch.clamp_max(feats.reshape(n, -1), 1.0)
    mlp = p["appearance_mlp"]
    x = torch.cat([flat[:, :3], p["embeddings"], cam_embedding[None].expand(n, -1)], -1)
    x = torch.relu(prec.mm(x, mlp["l0"]["w"]) + mlp["l0"]["b"])
    x = torch.relu(prec.mm(x, mlp["l1"]["w"]) + mlp["l1"]["b"])
    out = (prec.mm(x, mlp["l2"]["w"]) + mlp["l2"]["b"]) * 0.01
    k = feats.shape[1]
    offset = torch.cat([out[:, :3] / SH_C0, flat.new_zeros((n, (k - 1) * 3))], -1)
    toned = torch.clamp_max(flat * out[:, 3:].repeat(1, k) + offset, 1.0).reshape(n, k, 3)
    d = p["xyz"] - cam.center[None]
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    rgb = torch.sum(toned * sh_basis(d)[:, :, None], 1)
    return torch.clamp_min(rgb + 0.5, 0.0)


@torch.no_grad()
def filter_3d(xyz: torch.Tensor, cams: list, prec: Precision = FP32) -> torch.Tensor:
    """Mip-Splatting's 3D filter: the nearest covering camera's depth over the
    largest focal times sqrt(0.2); uncovered splats take the largest covered
    distance (cameras cover a +-15% margin around their frame)."""
    dist = torch.full_like(xyz[:, 0], float("inf"))
    covered = torch.zeros_like(dist, dtype=torch.bool)
    for c in cams:
        t = prec.mm(xyz, c.world_view[:3, :3].T) + c.world_view[:3, 3]
        z = t[:, 2]
        zc = torch.clamp_min(z, 0.001)
        x = t[:, 0] / zc * c.focal_x + c.width / 2.0
        y = t[:, 1] / zc * c.focal_y + c.height / 2.0
        ok = ((z > 0.2) & (x >= -0.15 * c.width) & (x <= 1.15 * c.width)
              & (y >= -0.15 * c.height) & (y <= 1.15 * c.height))
        dist = torch.minimum(dist, torch.where(ok, zc, float("inf")))
        covered |= ok
    far = torch.max(torch.where(covered, dist, float("-inf")))
    far = far if torch.isfinite(far) else torch.ones_like(far)
    return torch.where(covered, dist, far) / max(c.focal_x for c in cams) * math.sqrt(0.2)


# ----------------------------------------------------------------------------
# EWA projection
# ----------------------------------------------------------------------------

def project(xyz, scales, quats, opacity, cam: RefCamera, kernel_size: float,
            prec: Precision = FP32) -> dict:
    """Screen-space splats: pixel centres, conics, view depth, opacity with
    the 2D-dilation compensation, the touched-tile half-extents and
    visibility."""
    wv = cam.world_view
    depth_true = prec.mm(xyz, wv[2, :3][:, None])[:, 0] + wv[2, 3]
    keep = depth_true > NEAR_CULL_Z
    xyz = torch.where(keep[:, None], xyz, (cam.center + wv[2, :3])[None])
    scales = torch.clamp_max(scales, 1e4)
    rot = quat_to_rotmat(quats)
    m = rot * scales[:, None, :]
    cov3 = prec.mm(m, m.transpose(1, 2))
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)
    clip = prec.mm(hom, cam.full_proj.T)
    w = 1.0 / (clip[:, 3] + 1e-7)
    px = ((clip[:, 0] * w + 1.0) * cam.width - 1.0) * 0.5
    py = ((clip[:, 1] * w + 1.0) * cam.height - 1.0) * 0.5
    t = prec.mm(xyz, wv[:3, :3].T) + wv[:3, 3]
    tz = torch.clamp_min(t[:, 2], 1e-6)
    lim_x, lim_y = FRUSTUM_CLAMP * cam.tan_fovx, FRUSTUM_CLAMP * cam.tan_fovy
    tx = torch.clamp(t[:, 0] / tz, -lim_x, lim_x) * tz
    ty = torch.clamp(t[:, 1] / tz, -lim_y, lim_y) * tz
    iz = 1.0 / tz
    j00, j02 = cam.focal_x * iz, -cam.focal_x * tx * iz * iz
    j11, j12 = cam.focal_y * iz, -cam.focal_y * ty * iz * iz
    r = wv[:3, :3]
    v = prec.mm(prec.mm(r[None], cov3), r.T[None])
    c00 = j00 * j00 * v[:, 0, 0] + 2 * j00 * j02 * v[:, 0, 2] + j02 * j02 * v[:, 2, 2]
    c01 = (j00 * j11 * v[:, 0, 1] + j00 * j12 * v[:, 0, 2] + j02 * j11 * v[:, 1, 2]
           + j02 * j12 * v[:, 2, 2])
    c11 = j11 * j11 * v[:, 1, 1] + 2 * j11 * j12 * v[:, 1, 2] + j12 * j12 * v[:, 2, 2]
    det0 = c00 * c11 - c01 * c01
    a, c = c00 + kernel_size, c11 + kernel_size
    det = a * c - c01 * c01
    ratio = det0 / torch.clamp_min(det, 1e-12)
    comp = torch.where(ratio > 1e-6, torch.sqrt(torch.clamp_min(ratio, 1e-6)),
                       torch.zeros_like(ratio))
    inv = 1.0 / torch.clamp_min(det, 1e-12)
    conic = torch.stack([c * inv, -c01 * inv, a * inv], -1)
    op = torch.clamp(opacity * comp, 1e-12, 1.0)
    log_term = torch.clamp_min(2.0 * torch.log(255.0 * op), 1e-6)
    rx = torch.ceil(torch.sqrt(log_term) * torch.sqrt(torch.clamp_min(a, 0.0)) + 0.5)
    ry = torch.ceil(torch.sqrt(log_term) * torch.sqrt(torch.clamp_min(c, 0.0)) + 0.5)
    mean2d = torch.stack([px, py], -1)
    on_screen = ((px + rx >= 0) & (px - rx < cam.width) & (py + ry >= 0)
                 & (py - ry < cam.height))
    visible = (keep & (det > 0) & (op >= ALPHA_EPS) & on_screen).detach()
    depth = torch.where(keep, depth_true, depth_true.detach() * 0 + 1.0)
    return {"mean2d": mean2d, "conic": conic, "depth": depth, "opacity": opacity * comp,
            "rxy": torch.stack([rx, ry], -1).detach(), "visible": visible}


# ----------------------------------------------------------------------------
# Binning and compositing
# ----------------------------------------------------------------------------

@dataclass
class Bins:
    order: torch.Tensor    # (E,) splat index of each entry, sorted by (tile, depth)
    start: torch.Tensor    # (T,) first entry of each tile
    count: torch.Tensor    # (T,) entries of each tile
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def bin_splats(proj: dict, height: int, width: int) -> Bins:
    """Every (splat, touched tile) entry, sorted by tile then view depth."""
    ty, tx = -(-height // TILE), -(-width // TILE)
    m = proj["mean2d"].detach()
    rx, ry = proj["rxy"][:, 0], proj["rxy"][:, 1]

    def idx(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int64)

    x0, x1 = idx(m[:, 0] - rx, tx), idx(m[:, 0] + rx + TILE - 1, tx)
    y0, y1 = idx(m[:, 1] - ry, ty), idx(m[:, 1] + ry + TILE - 1, ty)
    rw = x1 - x0
    count = torch.where(proj["visible"], rw * (y1 - y0), torch.zeros_like(rw))
    sid = torch.repeat_interleave(torch.arange(m.shape[0], device=m.device), count)
    rank = torch.arange(sid.shape[0], device=m.device) - (torch.cumsum(count, 0) - count)[sid]
    rws = torch.clamp_min(rw[sid], 1)
    tile = (y0[sid] + rank // rws) * tx + x0[sid] + rank % rws
    o1 = torch.argsort(proj["depth"].detach()[sid], stable=True)
    o2 = torch.argsort(tile[o1], stable=True)
    tiles = torch.bincount(tile, minlength=ty * tx)
    return Bins(order=sid[o1[o2]], start=torch.cumsum(tiles, 0) - tiles, count=tiles,
                tiles_x=tx, tiles_y=ty)


def _chunk(acc, T, done, px, py, ok, m, con, op, ch):
    """Composite one chunk of K entry slots of R tiles at their P pixels."""
    dx = px[:, None, :] - m[:, :, 0:1]
    dy = py[:, None, :] - m[:, :, 1:2]
    power = (-0.5 * (con[:, :, 0:1] * dx * dx + con[:, :, 2:3] * dy * dy)
             - con[:, :, 1:2] * dx * dy)
    alpha = torch.clamp_max(op[:, :, None] * torch.exp(power), ALPHA_MAX)
    use = ok[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_EPS) & ~done[:, None, :]
    alpha = torch.where(use, alpha, torch.zeros_like(alpha))
    om = 1.0 - alpha
    t_after = T[:, None, :] * torch.cumprod(om, 1)
    keep = use & (t_after >= T_EPS)
    t_before = torch.cat([T[:, None, :], t_after[:, :-1]], 1)
    w = torch.where(keep, alpha * t_before, torch.zeros_like(alpha))
    acc = acc + torch.sum(w[:, :, None, :] * ch[:, :, :, None], 1)
    T = T * torch.prod(torch.where(keep, om, torch.ones_like(om)), 1)
    stop = use & ~keep
    # Work: pairs walked before their pixel stopped, passing pairs, walked entries.
    before = done[:, None, :] | (torch.cumsum(stop.to(torch.int32), 1) - stop.to(torch.int32) > 0)
    awake = ok[:, :, None] & ~before
    work = torch.stack([awake.sum(), (use & ~before).sum(), awake.any(2).sum()])
    return acc, T, done | stop.any(1), work


def composite(proj: dict, chans: torch.Tensor, bins: Bins, height: int, width: int,
              chunk: int = 64, checkpoint: bool = False):
    """Front-to-back blend of ``chans`` (N, C) over each tile's sorted list.

    Returns ((H, W, C) premultiplied channels, (H, W) final transmittance,
    work dict: walked pairs, passing pairs, walked entries).  ``checkpoint``
    recomputes each chunk in the backward pass, so a differentiable render
    holds one chunk's intermediates at a time."""
    dev = chans.device
    nt, c = bins.tiles_x * bins.tiles_y, chans.shape[1]
    t = torch.arange(nt, device=dev)[:, None]
    pix = torch.arange(P, device=dev)[None]
    px = ((t % bins.tiles_x) * TILE + pix % TILE).to(torch.float32)
    py = ((t // bins.tiles_x) * TILE + pix // TILE).to(torch.float32)
    acc = chans.new_zeros((nt, c, P))
    T = chans.new_ones((nt, P))
    done = torch.zeros((nt, P), dtype=torch.bool, device=dev)
    work = torch.zeros(3, dtype=torch.int64, device=dev)
    e_last = max(bins.order.shape[0] - 1, 0)
    lanes = torch.arange(chunk, device=dev)
    k = 0
    while True:
        rows = torch.nonzero((bins.count > k) & ~done.all(1))[:, 0]
        if rows.numel() == 0:
            break
        slot = k + lanes[None]
        ok = slot < bins.count[rows, None]
        e = bins.order[torch.clamp(bins.start[rows, None] + slot, max=e_last)]
        args = (acc[rows], T[rows], done[rows], px[rows], py[rows], ok,
                proj["mean2d"][e], proj["conic"][e], proj["opacity"][e], chans[e])
        if checkpoint:
            a, tr, d, wk = torch.utils.checkpoint.checkpoint(_chunk, *args, use_reentrant=False)
        else:
            a, tr, d, wk = _chunk(*args)
        acc = acc.index_copy(0, rows, a)
        T = T.index_copy(0, rows, tr)
        done = done.index_copy(0, rows, d)
        work = work + wk
        k += chunk

    def image(x):
        x = x.reshape(bins.tiles_y, bins.tiles_x, -1, TILE, TILE).permute(0, 3, 1, 4, 2)
        return x.reshape(bins.tiles_y * TILE, bins.tiles_x * TILE, -1)[:height, :width]

    w = [int(v) for v in work]
    return image(acc), image(T[:, None, :])[..., 0], {
        "pairs": w[0], "passing": w[1], "walked": w[2], "entries": int(bins.count.sum())}


def render(p: dict, filt: torch.Tensor, cam: RefCamera, cam_embedding: torch.Tensor,
           bg: torch.Tensor, kernel_size: float, prec: Precision = FP32,
           checkpoint: bool = False) -> dict:
    """Colour (H, W, 3) with the background, alpha-normalized depth, alpha,
    and the compositing work, for one camera."""
    scales, opac = filtered_scales_opacity(p, filt)
    proj = project(p["xyz"], scales, p["rotation"], opac, cam, kernel_size, prec)
    rgb = colors(p, cam, cam_embedding, prec)
    chans = torch.cat([rgb, proj["depth"][:, None]], -1)
    bins = bin_splats(proj, cam.height, cam.width)
    out, tfin, work = composite(proj, chans, bins, cam.height, cam.width,
                                checkpoint=checkpoint)
    alpha = 1.0 - tfin
    return {"color": out[..., :3] + tfin[..., None] * bg, "depth": out[..., 3]
            / torch.clamp_min(alpha, 1e-8), "alpha": alpha, "work": work}


# ----------------------------------------------------------------------------
# Losses, Adam, the learning-rate schedule
# ----------------------------------------------------------------------------

def _ssim(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    xs = torch.arange(11, dtype=torch.float64, device=a.device) - 5
    g = torch.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    g = prec.r((g / g.sum()).to(torch.float32))
    ch = a.shape[1]
    kh, kw = g.view(1, 1, 11, 1).repeat(ch, 1, 1, 1), g.view(1, 1, 1, 11).repeat(ch, 1, 1, 1)

    def blur(x):
        x = F.conv2d(prec.r(x), kh, padding=(5, 0), groups=ch)
        return F.conv2d(prec.r(x), kw, padding=(0, 5), groups=ch)

    mu0, mu1 = blur(a), blur(b)
    s00, s11, s01 = blur(a * a) - mu0 * mu0, blur(b * b) - mu1 * mu1, blur(a * b) - mu0 * mu1
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * mu0 * mu1 + c1) * (2 * s01 + c2)
                      / ((mu0 * mu0 + mu1 * mu1 + c1) * (s00 + s11 + c2)))


def _pearson_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    bad = ~torch.isfinite(pred) | ~torch.isfinite(gt)
    x = torch.where(bad, 0.0, gt).reshape(-1)
    y = torch.where(bad, 0.0, pred).reshape(-1)
    x, y = x - x.mean(), y - y.mean()
    return 1.0 - torch.sum(x * y) / torch.sqrt(torch.sum(x * x) * torch.sum(y * y) + 1e-12)


def _entropy(opacity: torch.Tensor) -> torch.Tensor:
    o = torch.clamp(opacity, 1e-3, 1 - 1e-3)
    return torch.mean(-(o * torch.log(o) + (1 - o) * torch.log(1 - o)))


def training_loss(out: dict, gt: torch.Tensor, mask: torch.Tensor, gt_depth: torch.Tensor,
                  opacity: torch.Tensor, w: dict, lambda_opacity: float,
                  prec: Precision = FP32, rows: Optional[int] = None) -> torch.Tensor:
    """(1 - l) L1 + l (1 - SSIM) on the masked images, + lambda_depth Pearson
    depth loss, + lambda_opacity mean binary entropy of the opacities.
    ``rows`` keeps only the first rows of the view: a planted fault."""
    if rows is not None:
        out = {k: out[k][:rows] for k in ("color", "depth")}
        gt, mask, gt_depth = gt[:rows], mask[:rows], gt_depth[:rows]
    img = (out["color"] * mask[..., None]).permute(2, 0, 1)
    ref = (gt * mask[..., None]).permute(2, 0, 1)
    l1 = torch.mean(torch.abs(img - ref))
    loss = (1 - w["lambda_dssim"]) * l1 + w["lambda_dssim"] * (
        1 - _ssim(img[None], ref[None], prec))
    loss = loss + w["lambda_depth"] * _pearson_loss(gt_depth * mask, out["depth"] * mask)
    return loss + lambda_opacity * _entropy(opacity)


def lr_at(step: int, lr_init: float, lr_final: float, delay_mult: float,
          max_steps: int) -> float:
    """The scheduled xyz learning rate in float32 (no delay steps)."""
    f32 = np.float32
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    v = np.exp(np.log(f32(max(lr_init, 1e-30))) * (f32(1) - t)
               + np.log(f32(max(lr_final, 1e-30))) * t)
    return float(f32(1.0) * v)


def leaves(p: dict) -> list:
    """``(name, tensor)`` per parameter leaf, nested dicts flattened with
    '/' in sorted key order."""
    out = []
    for k, v in p.items():
        if isinstance(v, dict):
            out += [(f"{k}/{n}", t) for n, t in leaves(v)]
        else:
            out.append((k, v))
    return out


@torch.no_grad()
def adam(p: dict, g: dict, mu: dict, nu: dict, lr: dict, count: int,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> None:
    """One Adam step in place (flat dicts by leaf name)."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    for k, t in p.items():
        mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
        nu[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
        t.addcdiv_(mu[k], torch.sqrt(nu[k] / c2).add_(eps), value=-lr[k] / c1)


def nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def train_steps(init: dict, filt: torch.Tensor, views: list,
                picks: list, lrs: list, w: dict, lambda_opacity: float, bg: torch.Tensor,
                kernel_size: float, prec: Precision = FP32,
                half_view: bool = False) -> dict:
    """Follow the program's first steps: for each pick, render view
    ``views[pick]`` (camera, image, mask, depth), take the loss's gradients
    by autograd, and update every leaf by Adam with ``lrs[step][leaf]``.

    Returns the losses, the first step's gradients and the parameters
    after the last step (flat dicts).
    ``half_view`` takes the loss over the first half of each view's rows:
    a planted fault."""
    flat = {k: v.detach().clone() for k, v in leaves(init)}
    mu = {k: torch.zeros_like(v) for k, v in flat.items()}
    nu = {k: torch.zeros_like(v) for k, v in flat.items()}
    out = {"losses": []}
    for step, (i, lr) in enumerate(zip(picks, lrs), 1):
        cam, gt, mask, depth = views[i]
        params = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        p = nest(params)
        r = render(p, filt, cam, p["appearance_embeddings"][min(cam.uid,
                   p["appearance_embeddings"].shape[0] - 1)], bg, kernel_size, prec,
                   checkpoint=True)
        loss = training_loss(r, gt, mask, depth, torch.sigmoid(p["opacity"][:, 0]), w,
                             lambda_opacity, prec, gt.shape[0] // 2 if half_view else None)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(flat[k]) if g is None else g for k, g in grads.items()}
        out["losses"].append(float(loss.detach()))
        if step == 1:
            out["grads1"] = {k: g.detach().clone() for k, g in grads.items()}
        adam(flat, grads, mu, nu, lr, step)
        del params, p, r, loss, grads
    out["params"] = flat
    return out
