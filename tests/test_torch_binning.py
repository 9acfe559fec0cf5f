"""Port parity: tile binning.

The port sorts one int64 key (tile << 32 | float bits of the depth); the
JAX package sorts a 31-bit key with the depth quantized, so splats closer
than its quantum may order differently.  Tile entry sets, counts, the
overflow count and the capacity formula must be exactly equal; the order
inside a tile is compared by depth (the port's must be the sorted order of
JAX's depths), not by position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.ops import binning as jbin
from skyfall_gs_tpu.ops.projection import project_gaussians
from skyfall_gs_tpu_torch.ops import binning as tbin
from tests.conftest import make_random_splats, make_test_camera

torch.set_num_threads(1)


def projected(rng, n, width, height, spread=0.8):
    d = make_random_splats(rng, n, spread=spread)
    p = project_gaussians(d["means3d"], d["scales"], d["quats"], d["opacities"],
                          make_test_camera(width, height))
    return [np.array(x) for x in (p.mean2d, p.depth, p.radius, p.radius_xy)]


def bin_both(arrays, height, width, cap):
    mean2d, depth, radius, radius_xy = arrays
    ref = jbin.bin_gaussians(*map(jnp.asarray, (mean2d, depth, radius)), height, width,
                             cap=cap, chunk=256, radius_xy=jnp.asarray(radius_xy))
    port = tbin.bin_gaussians(*map(torch.from_numpy, (mean2d, depth, radius)), height,
                              width, cap=cap, radius_xy=torch.from_numpy(radius_xy))
    return ref, port


def assert_same_tiles(ref, port, depth):
    n = depth.shape[0]
    np.testing.assert_array_equal(port.tile_count.numpy(), np.asarray(ref.tile_count))
    assert int(port.num_entries) == int(ref.num_entries)
    assert int(port.overflow) == int(ref.overflow)
    starts, counts = port.tile_start.numpy(), port.tile_count.numpy()
    assert (starts[1:] == starts[:-1] + counts[:-1]).all()
    gi_p, gi_r = port.gather_idx.numpy(), np.asarray(ref.gather_idx)
    live = int(counts.sum())
    assert (gi_p[live:] == n).all()                     # dead slots: dummy row
    for s_p, s_r, c in zip(starts, np.asarray(ref.tile_start), counts):
        ids_p, ids_r = gi_p[s_p:s_p + c], gi_r[s_r:s_r + c]
        np.testing.assert_array_equal(np.sort(ids_p), np.sort(ids_r))
        d = depth[ids_p]
        assert (np.diff(d) >= 0).all()
        np.testing.assert_array_equal(d, np.sort(depth[ids_r]))


@pytest.mark.parametrize("width,height", [(32, 32), (64, 48)])
def test_entry_sets_and_depth_order(rng, width, height):
    arrays = projected(rng, 80, width, height)
    ref, port = bin_both(arrays, height, width, cap=4096)
    assert int(port.overflow) == 0 and int(port.num_entries) > 80
    assert_same_tiles(ref, port, arrays[1])


def test_overflow_drops_the_same_entries(rng):
    arrays = projected(rng, 80, 64, 48)
    total = int(tbin.count_entries(*map(torch.from_numpy, arrays[:1] + arrays[2:3]),
                                   48, 64, radius_xy=torch.from_numpy(arrays[3])))
    ref, port = bin_both(arrays, 48, 64, cap=total - 37)
    assert int(port.overflow) == 37
    assert_same_tiles(ref, port, arrays[1])


def test_counts_and_capacity_formula(rng):
    mean2d, depth, radius, radius_xy = projected(rng, 120, 96, 64)
    args_t = [torch.from_numpy(x) for x in (mean2d, radius)]
    args_j = [jnp.asarray(x) for x in (mean2d, radius)]
    for rxy in (None, radius_xy):
        kw_t = {} if rxy is None else {"radius_xy": torch.from_numpy(rxy)}
        kw_j = {} if rxy is None else {"radius_xy": jnp.asarray(rxy)}
        np.testing.assert_array_equal(
            tbin.per_splat_entries(*args_t, 64, 96, **kw_t).numpy(),
            np.asarray(jbin.per_splat_entries(*args_j, 64, 96, **kw_j)))
        assert int(tbin.count_entries(*args_t, 64, 96, **kw_t)) == \
            int(jbin.count_entries(*args_j, 64, 96, **kw_j))
    for worst in (0, 1, 54_612, 54_614, 541_153, 2_500_000):
        assert tbin.capacity_for_entries(worst) == jbin.capacity_for_entries(worst)


def test_wide_images_bin_past_the_tpu_packing_limit(rng):
    """129 tiles across: the JAX key packing refuses it; the int64 key does
    not.  Checked against a brute-force expansion of the tile rectangles."""
    width, height = 129 * 16, 32
    n = 40
    mean2d = np.stack([rng.uniform(0, width, n), rng.uniform(0, height, n)], 1)
    mean2d = mean2d.astype(np.float32)
    depth = rng.uniform(1, 10, n).astype(np.float32)
    radius_xy = rng.integers(1, 40, (n, 2)).astype(np.int32)
    radius = radius_xy.max(1).astype(np.int32)
    with pytest.raises(ValueError, match="packing limits"):
        jbin.bin_gaussians(jnp.asarray(mean2d), jnp.asarray(depth), jnp.asarray(radius),
                           height, width, cap=8192, radius_xy=jnp.asarray(radius_xy))
    port = tbin.bin_gaussians(torch.from_numpy(mean2d), torch.from_numpy(depth),
                              torch.from_numpy(radius), height, width, cap=8192,
                              radius_xy=torch.from_numpy(radius_xy))
    tiles_x = 129
    expect = {t: [] for t in range(2 * tiles_x)}
    for i in range(n):
        x0, x1 = (np.clip(np.floor((mean2d[i, 0] + s * radius_xy[i, 0] + (s > 0) * 15) / 16),
                          0, tiles_x) for s in (-1, 1))
        y0, y1 = (np.clip(np.floor((mean2d[i, 1] + s * radius_xy[i, 1] + (s > 0) * 15) / 16),
                          0, 2) for s in (-1, 1))
        for ty in range(int(y0), int(y1)):
            for tx in range(int(x0), int(x1)):
                expect[ty * tiles_x + tx].append(i)
    gi = port.gather_idx.numpy()
    for t, ids in expect.items():
        s, c = int(port.tile_start[t]), int(port.tile_count[t])
        assert list(gi[s:s + c]) == sorted(ids, key=lambda i: depth[i])
