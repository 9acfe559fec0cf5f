"""Tile binning for the tiled rasterizer: duplicate -> sort -> tile ranges.

Port of ``skyfall_gs_tpu/ops/binning.py``, redesigned for the GPU:

  1. each splat's touched-tile rectangle (the exact ``radius_xy`` AABB);
  2. one entry per (splat, tile) pair under a static capacity ``cap``
     (entries past ``cap`` are dropped and counted in ``overflow``);
  3. ONE ``torch.sort`` on an int64 key ``tile << 32 | float-bits(depth)``.
     Visible depths are > NEAR_CULL_Z > 0, so their IEEE bits order like
     the floats, and the key carries the full-precision depth;
  4. ``searchsorted`` for the per-tile run ranges.

The int64 key removes the TPU packing limits (``cap < 2^24``,
``tiles_x < 128``) and the quantized-depth tie class.  Each tile's run is
read exactly from ``tile_start`` by the kernels, so the TPU's chunk-aligned
read base and boundary-accumulation flags have no counterpart here.
Everything is integer bookkeeping with no gradient, and it makes no host
sync (the capacity is static).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skyfall_gs_tpu_torch.utils import trace

TILE = 16  # pixels per tile side; 16 x 16 = 256 pixels = one thread block


class BinnedTiles(NamedTuple):
    """Depth-sorted per-tile entry layout.

    ``gather_idx`` points into a source array padded with one trailing dummy
    row (index N): every slot outside a live tile run gathers the dummy row,
    so any gradient it carries lands on a row the caller drops.
    """

    gather_idx: torch.Tensor   # (cap,) int64 gaussian index (N = dummy)
    tile_start: torch.Tensor   # (num_tiles,) int32 run starts in sorted order
    tile_count: torch.Tensor   # (num_tiles,) int32 live entries per tile
    num_entries: torch.Tensor  # () int64 total duplicated entries (pre-drop)
    overflow: torch.Tensor     # () int64 entries dropped due to capacity


def num_tiles(height: int, width: int) -> tuple[int, int]:
    return -(-height // TILE), -(-width // TILE)


def _tile_rects(mean2d, radius, tiles_y, tiles_x, radius_xy=None):
    """Per-splat touched-tile rectangle (the exact cutoff AABB when
    ``radius_xy`` is given, else the square of ``radius``)."""
    if radius_xy is None:
        rx = ry = radius.to(torch.float32)
    else:
        rx = radius_xy[:, 0].to(torch.float32)
        ry = radius_xy[:, 1].to(torch.float32)
    mx, my = mean2d[:, 0], mean2d[:, 1]

    def tile_index(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int64)

    x0 = tile_index(mx - rx, tiles_x)
    y0 = tile_index(my - ry, tiles_y)
    x1 = tile_index(mx + rx + TILE - 1, tiles_x)
    y1 = tile_index(my + ry + TILE - 1, tiles_y)
    rect_w = x1 - x0
    count = torch.where(radius > 0, rect_w * (y1 - y0), torch.zeros_like(rect_w))
    return x0, y0, rect_w, count


def per_splat_entries(mean2d, radius, height: int, width: int,
                      radius_xy=None) -> torch.Tensor:
    """(N,) duplicated-entry count each splat would produce (0 = culled)."""
    tiles_y, tiles_x = num_tiles(height, width)
    return _tile_rects(mean2d, radius, tiles_y, tiles_x, radius_xy)[3]


def count_entries(mean2d, radius, height: int, width: int,
                  radius_xy=None) -> torch.Tensor:
    """Total duplicated (splat, tile) entries a view would produce — used to
    right-size the binning capacity."""
    return torch.sum(per_splat_entries(mean2d, radius, height, width, radius_xy))


def capacity_for_entries(worst_entries: int) -> int:
    """Production capacity for a measured worst-view entry count: a 1.2x
    margin rounded up to 64k buckets (the JAX package's formula, so both
    packages train at the same capacity)."""
    bucket = 64 * 1024
    return max(-(-int(worst_entries * 1.2) // bucket) * bucket, bucket)


@trace.span("render.bin")
def bin_gaussians(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    height: int,
    width: int,
    cap: int,
    radius_xy=None,
) -> BinnedTiles:
    """Build the per-tile entry layout.

    Args:
        mean2d: (N, 2) pixel-space centers.
        depth: (N,) view-space z used as the sort key (> 0 where visible).
        radius: (N,) int32 screen radii; 0 = culled.
        cap: static capacity for duplicated entries (excess is dropped and
            counted in ``overflow``).
    """
    mean2d = mean2d.detach()
    depth = depth.detach()
    n = mean2d.shape[0]
    dev = mean2d.device
    tiles_y, tiles_x = num_tiles(height, width)
    t_total = tiles_y * tiles_x

    x0, y0, rect_w, count = _tile_rects(mean2d, radius, tiles_y, tiles_x, radius_xy)
    cum_incl = torch.cumsum(count, 0)
    total = cum_incl[-1] if n > 0 else torch.zeros((), dtype=torch.int64, device=dev)
    n_live = torch.clamp_max(total, cap)
    # Entries the view asks for against the keys sorted for it (all ``cap``).
    trace.count("render.entries", total)
    trace.count("render.sorted", cap)

    # Entry e belongs to the first splat whose inclusive prefix exceeds e;
    # its rank inside that splat's rectangle gives the tile.
    entry = torch.arange(cap, dtype=torch.int64, device=dev)
    live = entry < n_live
    gidx = torch.clamp_max(torch.searchsorted(cum_incl, entry, right=True), max(n - 1, 0))
    rank = entry - (cum_incl - count)[gidx]
    rw = torch.clamp_min(rect_w[gidx], 1)
    tile = (y0[gidx] + rank // rw) * tiles_x + x0[gidx] + rank % rw
    depth_bits = depth.to(torch.float32).view(torch.int32).to(torch.int64)[gidx]
    key = torch.where(live, (tile << 32) | depth_bits,
                      torch.full_like(tile, t_total << 32))

    key_s, order = torch.sort(key)
    tile_s = key_s >> 32
    tile_edges = torch.searchsorted(
        tile_s, torch.arange(t_total + 1, dtype=torch.int64, device=dev))
    tile_start = tile_edges[:-1].to(torch.int32)
    tile_count = (tile_edges[1:] - tile_edges[:-1]).to(torch.int32)
    # Live entries sort before the sentinel keys of the dead ones; route the
    # dead slots to the dummy row n.
    gather_idx = torch.where(live, gidx[order], torch.full_like(gidx, n))
    return BinnedTiles(
        gather_idx=gather_idx,
        tile_start=tile_start,
        tile_count=tile_count,
        num_entries=total,
        overflow=torch.clamp_min(total - cap, 0),
    )
