"""Tiled rasterizer: the production compositing backend.

Port of ``skyfall_gs_tpu/ops/rasterize_tiled.py``.  Binning (ops/binning.py)
sorts the (splat, tile) entries; two kernels composite each 16x16 tile's
depth-sorted run:

  * forward  — front-to-back blend of 7 channels and the final
    transmittance (``csrc/composite.cu::fwd_kernel``, replacing the Pallas
    ``_fwd_kernel``);
  * backward — recomputes the forward per entry, forms every entry's
    gradient row with the suffix trick, including the two AbsGS rows, and
    adds it into its gaussian's row of the gradient table
    (``csrc/composite.cu::bwd_kernel``, replacing ``_bwd_kernel``).

Each kernel has a plain PyTorch version here (``composite_fwd_torch`` /
``composite_bwd_torch``).  The wrappers ``composite_fwd`` / ``composite_bwd``
run the plain version for CPU tensors and the CUDA kernel for CUDA tensors;
there is no fallback from one to the other.  Each wrapper counts its kernel
launches in ``.launches``.

Layout.  The per-gaussian table is (N+1, 16) float32, one row per splat
plus a zero dummy row N:
  cols 0..6   blend channels (r, g, b, depth, nx, ny, nz)
  col  7      zero pad (rows are four 16-byte vectors)
  cols 8..13  mx, my, conic a, b, c, opacity
  cols 14,15  AbsGS dummies (zeros in; backward emits sum|dmx|, sum|dmy|)
The backward returns the gradient of that table, (N+1, 16): every entry's
(16,) gradient row summed into its gaussian's row (the transpose of the
gather).  The kernel adds them with atomics, so the sums come out in an
order that differs from run to run; the plain version forms the rows per
entry and sums them with one ``index_add_`` over ``gather_idx``.
Outputs are tile-major: ``out`` (T, 7, 256), ``T_final`` (T, 256).

Both kernels skip, per warp of 32 pixels (a 16x2 strip of the tile), the
entries whose alpha >= 1/255 ellipse cannot reach the strip
(``strip_mask_torch`` is the plain transcription of the CUDA predicate).
``composite_work`` counts the work these inputs need, for the kernels'
bounds; nothing on the main path calls it.

Compositing rules (shared with rasterize_ref): pixel centers are integer
coordinates plus the subpixel offset; ``power = -0.5 (a dx^2 + c dy^2) -
b dx dy``; ``alpha = min(0.99, op exp(power))``; an entry is skipped when
``power > 0`` or ``alpha < 1/255``; T is the true running product, and
``keep = T_after >= 1e-4`` — the stopping splat is not composited and
nothing resumes after it.  ``T_final`` is T after the last kept entry.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from skyfall_gs_tpu_torch.ops.binning import TILE, bin_gaussians, num_tiles
from skyfall_gs_tpu_torch.ops.rasterize_ref import ALPHA_EPS, ALPHA_MAX, T_EPS

P = TILE * TILE      # pixels per tile = 256
NA = 16              # table / gradient columns per entry
NCH = 7              # blended channels

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# Built libraries go to <repo>/build/, keyed by a hash of the sources.
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


# ----------------------------------------------------------------------------
# Build and bind the CUDA library (plain C interface, loaded with ctypes)
# ----------------------------------------------------------------------------

def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    if "CUDA_HOME" in os.environ:
        return str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` with nvcc into ``build/`` (once per source
    hash) and return the shared library's path.  Raises with nvcc's stderr
    if the build fails.  ptxas's register/shared-memory report is kept
    beside the library as ``.log``."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    lib = _BUILD_DIR / f"libskyfall_composite_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.skyfall_composite_fwd.argtypes = [ptr] * 8 + [i32, i32, ptr]
    lib.skyfall_composite_fwd.restype = i32
    lib.skyfall_composite_bwd.argtypes = [ptr] * 11 + [i32, i32, ptr]
    lib.skyfall_composite_bwd.restype = i32
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def _check_inputs(table, gather_idx, tile_start, tile_count, offx, offy):
    dev = table.device
    t_total = tile_start.shape[0]
    _check("table", table, torch.float32, (table.shape[0], NA), dev)
    _check("gather_idx", gather_idx, torch.int64, (gather_idx.shape[0],), dev)
    _check("tile_start", tile_start, torch.int32, (t_total,), dev)
    _check("tile_count", tile_count, torch.int32, (t_total,), dev)
    _check("offx", offx, torch.float32, (t_total, P), dev)
    _check("offy", offy, torch.float32, (t_total, P), dev)


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------------
# Both walk each tile's run one entry slot at a time, vectorized over
# (tiles, pixels), with the kernels' operation order: T is the same
# sequential product in the same float32 rounding, so the alpha >= 1/255 and
# T >= 1e-4 decisions are the kernels' decisions (a cumprod would round T
# differently and flip ``keep`` for pixels within an ulp of 1e-4, moving the
# output by up to 1e-2 there).

def _pixel_centers(t_total: int, tiles_x: int, offx, offy):
    dev = offx.device
    t = torch.arange(t_total, device=dev)[:, None]
    p = torch.arange(P, device=dev)[None, :]
    px = ((t % tiles_x) * TILE + p % TILE).to(torch.float32) + offx
    py = ((t // tiles_x) * TILE + p // TILE).to(torch.float32) + offy
    return px, py


def _entry_slot(table, gather_idx, tile_start, tile_count, e: int, px, py, T):
    """State of entry slot ``e`` of every tile's run, at every pixel."""
    valid = e < tile_count                                   # (T,)
    idx = torch.clamp_max(tile_start.to(torch.int64) + e, gather_idx.shape[0] - 1)
    r = table[gather_idx[idx]]                               # (T, 16)
    col = r[:, :NCH]
    mx, my, ca, cb, cc, op = (r[:, k:k + 1] for k in range(8, 14))
    dx = px - mx
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha_un = op * torch.exp(power)
    alpha = torch.clamp_max(alpha_un, ALPHA_MAX)
    use = valid[:, None] & (power <= 0.0) & (alpha >= ALPHA_EPS)
    t_after = T * (1.0 - alpha)
    return idx, valid, col, (ca, cb, cc, op), dx, dy, alpha_un, alpha, use, t_after


def composite_fwd_torch(table, gather_idx, tile_start, tile_count, offx, offy,
                        tiles_x: int):
    """Plain version of the forward kernel: (out (T, 7, P), T_final (T, P))."""
    t_total = tile_start.shape[0]
    px, py = _pixel_centers(t_total, tiles_x, offx, offy)
    acc = torch.zeros((t_total, NCH, P), dtype=torch.float32, device=table.device)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    n_slots = int(tile_count.max()) if t_total else 0
    for e in range(n_slots):
        _, _, col, _, _, _, _, alpha, use, t_after = _entry_slot(
            table, gather_idx, tile_start, tile_count, e, px, py, T)
        use = use & ~done
        stop = use & (t_after < T_EPS)
        keep = use & ~stop
        done = done | stop
        w = torch.where(keep, alpha * T, 0.0)
        acc = acc + w[:, None, :] * col[:, :, None]
        T = torch.where(keep, t_after, T)
    return acc, T


def composite_bwd_torch(table, gather_idx, tile_start, tile_count, offx, offy,
                        out, tfin, dout, dtfin, tiles_x: int):
    """Plain version of the backward kernel: the gradient of the (N+1, 16)
    table, formed as per-entry rows in sorted entry order and summed per
    gaussian by one ``index_add_``."""
    t_total = tile_start.shape[0]
    px, py = _pixel_centers(t_total, tiles_x, offx, offy)
    dent = torch.zeros((gather_idx.shape[0], NA), dtype=torch.float32,
                       device=table.device)
    b_tot = torch.sum(dout * out, dim=1) + dtfin * tfin      # (T, P)
    T = torch.ones_like(px)
    Q = torch.zeros_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    n_slots = int(tile_count.max()) if t_total else 0
    for e in range(n_slots):
        idx, valid, col, (ca, cb, cc, op), dx, dy, alpha_un, alpha, use, t_after = \
            _entry_slot(table, gather_idx, tile_start, tile_count, e, px, py, T)
        use = use & ~done
        stop = use & (t_after < T_EPS)
        keep = use & ~stop
        done = done | stop
        w = torch.where(keep, alpha * T, 0.0)
        a_dot = torch.sum(dout * col[:, :, None], dim=1)     # c . dC per pixel
        w_adot = w * a_dot
        Q = Q + w_adot
        gate = keep & (alpha_un < ALPHA_MAX)
        dpower = torch.where(gate, w_adot - (b_tot - Q) * (alpha_un / (1.0 - alpha)), 0.0)
        u = dpower * dx
        v = dpower * dy
        sx = ca * u + cb * v          # dpower * d(power)/d(mx)
        sy = cc * v + cb * u
        rows = torch.cat([
            torch.sum(dout * w[:, None, :], dim=2),               # d channels
            torch.zeros_like(op),
            sx.sum(1, keepdim=True),
            sy.sum(1, keepdim=True),
            -0.5 * (u * dx).sum(1, keepdim=True),
            -(u * dy).sum(1, keepdim=True),
            -0.5 * (v * dy).sum(1, keepdim=True),
            dpower.sum(1, keepdim=True) * torch.where(op > 0.0, 1.0 / op, 0.0),
            sx.abs().sum(1, keepdim=True),
            sy.abs().sum(1, keepdim=True),
        ], dim=1)
        dent[idx[valid]] = rows[valid]
        T = torch.where(keep, t_after, T)
    return torch.zeros_like(table).index_add_(0, gather_idx, dent)


# ----------------------------------------------------------------------------
# The strip cull and the work count
# ----------------------------------------------------------------------------
# Margins of the cull, as in csrc/composite.cu: k' = k (1 + MARGIN_REL +
# MARGIN_COND a c / det) + MARGIN_ABS, then each half-extent x EXTENT_REL +
# EXTENT_ABS pixels.
MARGIN_REL = 1e-4
MARGIN_COND = 4e-6
MARGIN_ABS = 1e-5
EXTENT_REL = 1.001
EXTENT_ABS = 0.01
WARPS = P // 32      # warp strips per tile, 16x2 pixels each


def strip_bounds_torch(px, py):
    """Per tile and warp strip: (x min, x max, y min, y max) of the strip's
    pixel centres, (T, 8, 4); ``csrc/composite.cu::strip_bounds``."""
    t_total = px.shape[0]
    x = px.reshape(t_total, WARPS, 32)
    y = py.reshape(t_total, WARPS, 32)
    return torch.stack([x.amin(2), x.amax(2), y.amin(2), y.amax(2)], dim=2)


def strip_mask_torch(rows, strips):
    """Plain transcription of ``csrc/composite.cu::strip_mask``: which warp
    strips the alpha >= 1/255 ellipse of each row can reach.

    ``rows`` (E, 16) table rows, ``strips`` (E, 8, 4) the bounds of each
    row's tile; returns (E, 8) bool.  The ellipse q(dx, dy) <= k with
    k = 2 ln(255 op) has half-extents sqrt(k c / det), sqrt(k a / det);
    op < 1/255 reaches no strip, a conic that is not positive definite or
    not finite reaches every strip.
    """
    mx, my, a, b, c, op = (rows[:, k] for k in range(8, 14))
    det = (a.double() * c.double() - b.double() * b.double()).float()
    k = torch.clamp_min(2.0 * torch.log(255.0 * op), 0.0)
    km = k * (1.0 + MARGIN_REL + MARGIN_COND * (a * c / det)) + MARGIN_ABS
    ex = torch.sqrt(km * c / det) * EXTENT_REL + EXTENT_ABS
    ey = torch.sqrt(km * a / det) * EXTENT_REL + EXTENT_ABS
    every = ~((a > 0) & (c > 0) & (det > 0) & torch.isfinite(a * c) & torch.isfinite(op)
              & torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(ex)
              & torch.isfinite(ey))
    mx, my, ex, ey = (v[:, None] for v in (mx, my, ex, ey))
    reach = ((strips[..., 0] - mx <= ex) & (mx - strips[..., 1] <= ex)
             & (strips[..., 2] - my <= ey) & (my - strips[..., 3] <= ey))
    reach = reach | every[:, None]
    return reach & ~(op < ALPHA_EPS)[:, None]


def composite_work(table, gather_idx, tile_start, tile_count, offx, offy,
                   tiles_x: int) -> dict:
    """Count the compositing work these inputs need, walking the entries as
    the plain forward does (a pixel stops at its terminating entry, a tile
    once every pixel has stopped).

    Returns a dict of ints: ``entries``; ``walked`` entries before each
    tile's exit; ``pairs``, the (entry, pixel) pairs before each pixel
    stops; ``kept_pairs``, those of them in warp strips the strip mask
    keeps (the pairs the kernels evaluate); ``passing``, those that pass
    power <= 0 and alpha >= 1/255; ``warp_slots``, the walked (entry, warp)
    slots with a pixel not yet stopped; ``culled``, those the strip mask
    drops; ``live``, those with a passing pair; and ``tile_walked``, a (T,)
    tensor of entries walked per tile.
    """
    t_total = tile_start.shape[0]
    px, py = _pixel_centers(t_total, tiles_x, offx, offy)
    strips = strip_bounds_torch(px, py)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    tile_walked = torch.zeros(t_total, dtype=torch.int64, device=table.device)
    n = dict.fromkeys(("pairs", "kept_pairs", "passing", "warp_slots", "culled", "live"), 0)
    n_slots = int(tile_count.max()) if t_total else 0
    for e in range(n_slots):
        idx, valid, _, _, _, _, _, _, use, t_after = _entry_slot(
            table, gather_idx, tile_start, tile_count, e, px, py, T)
        awake = ~done & valid[:, None]                       # pairs walked at slot e
        passing = use & awake
        slots = awake.reshape(t_total, WARPS, 32).any(2)
        reach = strip_mask_torch(table[gather_idx[idx]], strips)
        tile_walked += slots.any(1)
        n["pairs"] += int(awake.sum())
        n["kept_pairs"] += int((awake.reshape(t_total, WARPS, 32) & reach[..., None]).sum())
        n["passing"] += int(passing.sum())
        n["warp_slots"] += int(slots.sum())
        n["culled"] += int((slots & ~reach).sum())
        n["live"] += int((slots & passing.reshape(t_total, WARPS, 32).any(2)).sum())
        stop = passing & (t_after < T_EPS)
        T = torch.where(passing & ~stop, t_after, T)
        done = done | stop
    return {"entries": int(tile_count.sum()), "walked": int(tile_walked.sum()),
            **n, "tile_walked": tile_walked}


# ----------------------------------------------------------------------------
# Kernel wrappers: plain version on CPU tensors, CUDA kernel on CUDA tensors
# ----------------------------------------------------------------------------

def composite_fwd(table, gather_idx, tile_start, tile_count, offx, offy,
                  tiles_x: int):
    """Forward compositing: (out (T, 7, P), T_final (T, P))."""
    if not table.is_cuda:
        return composite_fwd_torch(table, gather_idx, tile_start, tile_count,
                                   offx, offy, tiles_x)
    _check_inputs(table, gather_idx, tile_start, tile_count, offx, offy)
    t_total = tile_start.shape[0]
    out = torch.empty((t_total, NCH, P), dtype=torch.float32, device=table.device)
    tfin = torch.empty((t_total, P), dtype=torch.float32, device=table.device)
    composite_fwd.launches += 1
    rc = _library().skyfall_composite_fwd(
        table.data_ptr(), gather_idx.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), offx.data_ptr(), offy.data_ptr(), out.data_ptr(),
        tfin.data_ptr(), t_total, tiles_x, _stream_ptr(table.device))
    if rc != 0:
        raise RuntimeError(f"skyfall_composite_fwd launch failed: cudaError {rc}")
    return out, tfin


composite_fwd.launches = 0


def composite_bwd(table, gather_idx, tile_start, tile_count, offx, offy,
                  out, tfin, dout, dtfin, tiles_x: int):
    """Backward compositing: the gradient of the (N+1, 16) table."""
    if not table.is_cuda:
        return composite_bwd_torch(table, gather_idx, tile_start, tile_count,
                                   offx, offy, out, tfin, dout, dtfin, tiles_x)
    _check_inputs(table, gather_idx, tile_start, tile_count, offx, offy)
    t_total = tile_start.shape[0]
    for name, x, shape in (("out", out, (t_total, NCH, P)), ("tfin", tfin, (t_total, P)),
                           ("dout", dout, (t_total, NCH, P)), ("dtfin", dtfin, (t_total, P))):
        _check(name, x, torch.float32, shape, table.device)
    dtable = torch.zeros_like(table)                         # the kernel adds into it
    composite_bwd.launches += 1
    rc = _library().skyfall_composite_bwd(
        table.data_ptr(), gather_idx.data_ptr(), tile_start.data_ptr(),
        tile_count.data_ptr(), offx.data_ptr(), offy.data_ptr(), out.data_ptr(),
        tfin.data_ptr(), dout.data_ptr(), dtfin.data_ptr(), dtable.data_ptr(),
        t_total, tiles_x, _stream_ptr(table.device))
    if rc != 0:
        raise RuntimeError(f"skyfall_composite_bwd launch failed: cudaError {rc}")
    return dtable


composite_bwd.launches = 0


class _Composite(torch.autograd.Function):
    """Differentiable composite over the binned entry stream; the backward
    returns the gradient of the (N+1, 16) table directly."""

    @staticmethod
    def forward(ctx, table, gather_idx, tile_start, tile_count, offx, offy, tiles_x):
        out, tfin = composite_fwd(table, gather_idx, tile_start, tile_count,
                                  offx, offy, tiles_x)
        ctx.save_for_backward(table, gather_idx, tile_start, tile_count, offx, offy,
                              out, tfin)
        ctx.tiles_x = tiles_x
        return out, tfin

    @staticmethod
    def backward(ctx, dout, dtfin):
        table, gather_idx, tile_start, tile_count, offx, offy, out, tfin = \
            ctx.saved_tensors
        dtable = composite_bwd(table, gather_idx, tile_start, tile_count, offx, offy,
                               out, tfin, dout.contiguous(), dtfin.contiguous(),
                               ctx.tiles_x)
        return dtable, None, None, None, None, None, None


# ----------------------------------------------------------------------------
# Public entry
# ----------------------------------------------------------------------------

def default_capacity(n: int) -> int:
    """Shape-only fallback capacity (~4 tiles per splat) for ad-hoc calls;
    production paths measure it (render.measure_bin_capacity)."""
    return max(1 << 16, 4 * n)


def composite_inputs(mean2d, conic, depth, radius, opacity, channels,
                     height: int, width: int, subpixel_offset=None,
                     mean2d_abs_dummy=None, cap: Optional[int] = None,
                     radius_xy=None):
    """Bin the splats and lay out the kernels' inputs.

    Returns ``(table (N+1, 16), binned, offx (T, P), offy (T, P))``: the
    per-gaussian table with its zero dummy row N (differentiable w.r.t. the
    splat attributes), the binning, and the tile-major subpixel offsets.
    """
    n = mean2d.shape[0]
    if channels.shape[1] != NCH:
        raise ValueError(f"expected {NCH} blend channels, got {channels.shape[1]}")
    tiles_y, tiles_x = num_tiles(height, width)
    t_total = tiles_y * tiles_x
    binned = bin_gaussians(mean2d, depth, radius, height, width,
                           cap=default_capacity(n) if cap is None else cap,
                           radius_xy=radius_xy)

    if mean2d_abs_dummy is None:
        mean2d_abs_dummy = torch.zeros_like(mean2d)
    table = torch.cat(
        [channels, torch.zeros_like(opacity)[:, None], mean2d, conic,
         opacity[:, None], mean2d_abs_dummy], dim=1)
    table = F.pad(table, (0, 0, 0, 1)).contiguous()         # dummy row N

    hp, wp = tiles_y * TILE, tiles_x * TILE
    if subpixel_offset is None:
        offx = offy = torch.zeros((t_total, P), dtype=torch.float32, device=mean2d.device)
    else:
        sp = F.pad(subpixel_offset, (0, 0, 0, wp - width, 0, hp - height))
        sp = sp.reshape(tiles_y, TILE, tiles_x, TILE, 2).permute(0, 2, 1, 3, 4)
        sp = sp.reshape(t_total, P, 2)
        offx = sp[..., 0].contiguous()
        offy = sp[..., 1].contiguous()
    return table, binned, offx, offy


def composite_tiled(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    opacity: torch.Tensor,
    channels: torch.Tensor,
    height: int,
    width: int,
    subpixel_offset: Optional[torch.Tensor] = None,
    mean2d_abs_dummy: Optional[torch.Tensor] = None,
    cap: Optional[int] = None,
    inference: bool = False,
    radius_xy: Optional[torch.Tensor] = None,
):
    """Tile-binned differentiable composite.

    Same contract as ops.rasterize_ref.composite_reference, plus AbsGS
    absolute screen gradients routed into ``mean2d_abs_dummy``'s gradient.
    ``inference=True`` runs the forward kernel alone, outside autograd.

    Returns:
        (out (H, W, 7) premultiplied channels, T_final (H, W),
         overflow () — duplicated entries dropped because ``cap`` was
         undersized; nonzero means the highest-index splats are missing from
         both the render and its gradients).
    """
    tiles_y, tiles_x = num_tiles(height, width)
    hp, wp = tiles_y * TILE, tiles_x * TILE
    table, binned, offx, offy = composite_inputs(
        mean2d, conic, depth, radius, opacity, channels, height, width,
        subpixel_offset, mean2d_abs_dummy, cap, radius_xy)
    args = (binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy,
            tiles_x)
    if inference:
        out, tfin = composite_fwd(table.detach(), *args)
    else:
        out, tfin = _Composite.apply(table, *args)
    img = (out.reshape(tiles_y, tiles_x, NCH, TILE, TILE)
           .permute(0, 3, 1, 4, 2).reshape(hp, wp, NCH))[:height, :width]
    tfin_img = (tfin.reshape(tiles_y, tiles_x, TILE, TILE)
                .permute(0, 2, 1, 3).reshape(hp, wp))[:height, :width]
    return img, tfin_img, binned.overflow
