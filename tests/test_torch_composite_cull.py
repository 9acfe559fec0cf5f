"""The compositing kernels' strip cull and work count (ops/rasterize_tiled.py).

``strip_mask_torch`` is the plain transcription of the CUDA predicate that
lets a warp of 32 pixels (a 16x2 strip of its tile) skip an entry.  It must
be conservative: every (entry, pixel) pair that passes the plain forward's
alpha test (``power <= 0`` and ``alpha >= 1/255``) lies in a strip the
predicate keeps, or the kernels would drop a contribution.  Checked on
chip_smoke.py's phase-2 screen scene, on a 96 px version of its bench
scene, on opacity at exactly 1/255 and just under it, on degenerate and
huge conics, and on pairs sampled at the ellipse boundary of badly
conditioned conics.  ``composite_work`` is held against counts taken by
hand, and the slice's backward against the JAX package's tiled composite.
"""

import os
import sys

import numpy as np
import pytest
import torch

from skyfall_gs_tpu.ops.rasterize_tiled import composite_tiled as jtiled
from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt
from skyfall_gs_tpu_torch.ops.rasterize_ref import ALPHA_EPS
from tests.test_torch_rasterize import (
    assert_grads_close, jax_composite, port_composite, readout_weights, screen_splats)
from tests.test_torch_kernels import strip_edge_scene

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
EPS = np.float32(ALPHA_EPS)


def passing(rows, px, py):
    """(E, K) pairs that pass the plain forward's alpha test, for E rows and
    K pixel centres each (the arithmetic of ``rt._entry_slot``)."""
    mx, my, ca, cb, cc, op = (rows[:, k:k + 1] for k in range(8, 14))
    dx, dy = px - mx, py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(op * torch.exp(power), rt.ALPHA_MAX)
    return (power <= 0.0) & (alpha >= ALPHA_EPS)


def cull_violations(table, binned, offx, offy, tiles_x):
    """Walk every entry slot of every tile: (pairs passing the alpha test in
    a strip the predicate drops, passing pairs, walked warp-slots the
    predicate drops)."""
    t_total = binned.tile_start.shape[0]
    px, py = rt._pixel_centers(t_total, tiles_x, offx, offy)
    strips = rt.strip_bounds_torch(px, py)
    T = torch.ones_like(px)
    bad = n_pass = culled = 0
    for e in range(int(binned.tile_count.max())):
        idx, valid, *_, use, _ = rt._entry_slot(table, binned.gather_idx, binned.tile_start,
                                                binned.tile_count, e, px, py, T)
        reach = rt.strip_mask_torch(table[binned.gather_idx[idx]], strips)
        use = use.reshape(t_total, rt.WARPS, 32)
        bad += int((use & ~reach[..., None]).sum())
        n_pass += int(use.sum())
        culled += int((valid[:, None] & ~reach).sum())
    return bad, n_pass, culled


def screen_inputs(s, size, offset=None, cap=1 << 16):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in s.items()}
    off = None if offset is None else torch.from_numpy(offset)
    table, binned, offx, offy = rt.composite_inputs(
        t["mean2d"], t["conic"], t["depth"], t["radius"], t["opacity"], t["channels"],
        size, size, subpixel_offset=off, cap=cap, radius_xy=t["radius_xy"])
    assert int(binned.overflow) == 0
    return table, binned, offx, offy, rt.num_tiles(size, size)[1]


def test_cull_is_conservative_on_the_screen_scene():
    """The phase-2 scene: a dense low-opacity cluster (tiles of more than
    1k entries), an opaque wall and a random field, with subpixel offsets."""
    mean2d, conic, depth, radius, opacity, channels, radius_xy, offset = \
        chip_smoke.screen_scene(np.random.default_rng(0))
    s = dict(mean2d=mean2d, conic=conic, depth=depth, radius=radius, opacity=opacity,
             channels=channels, radius_xy=radius_xy)
    bad, n_pass, culled = cull_violations(*screen_inputs(s, 128, offset))
    assert bad == 0
    assert n_pass > 100_000 and culled > 10_000, (n_pass, culled)


def test_cull_is_conservative_on_the_bench_scene_at_96px():
    state, cams = chip_smoke.bench_scene(np.random.default_rng(0), "cpu", n=20_000, img=96)
    table, binned, offx, offy = chip_smoke.bench_inputs(torch, rt, state, cams[0], 1 << 17)
    assert int(binned.overflow) == 0 and int(binned.num_entries) > 5_000
    bad, n_pass, culled = cull_violations(table, binned, offx, offy, rt.num_tiles(96, 96)[1])
    assert bad == 0
    assert n_pass > 10_000 and culled > 0, (n_pass, culled)


def point_splats(mean, conic, opacity, radius=4):
    n = len(opacity)
    return dict(mean2d=np.float32(mean).reshape(n, 2), conic=np.float32(conic).reshape(n, 3),
                depth=np.arange(1, n + 1, dtype=np.float32), radius=np.full(n, radius, np.int32),
                radius_xy=np.full((n, 2), radius, np.int32), opacity=np.float32(opacity),
                channels=np.ones((n, 7), np.float32))


@pytest.mark.parametrize("conic", [(0.5, 0.0, 0.5), (1e6, 0.0, 1e6), (3.0, 2.9, 3.0)])
def test_opacity_at_one_over_255_and_just_under(conic):
    """A splat centred on a pixel with op = 1/255 passes there (power 0,
    alpha = op) and only near there; just under 1/255 it passes nowhere and
    reaches no strip.  Huge and badly conditioned conics included."""
    under = np.nextafter(EPS, np.float32(0))
    s = point_splats([[8.0, 8.0], [8.0, 24.0]], [conic, conic], [EPS, under])
    table, binned, offx, offy, tiles_x = screen_inputs(s, 32)
    bad, n_pass, _ = cull_violations(table, binned, offx, offy, tiles_x)
    assert bad == 0 and n_pass >= 1
    px, py = rt._pixel_centers(4, 2, offx, offy)
    strips = rt.strip_bounds_torch(px, py)
    reach = rt.strip_mask_torch(table[:2], strips[[0, 2]])
    assert reach[0, 4] and int(reach[0].sum()) <= 2       # rows 8-9: the centre's strip
    assert not reach[1].any()


def test_degenerate_and_non_finite_rows_reach_every_strip():
    nan = float("nan")
    rows = torch.zeros((6, rt.NA))
    rows[:, 8:10] = 8.0
    rows[:, 13] = 0.5
    rows[0, 10:13] = torch.tensor([1.0, 2.0, 1.0])          # det < 0
    rows[1, 10:13] = torch.tensor([1.0, 1.0, 1.0])          # det = 0
    rows[2, 10:13] = torch.tensor([-1.0, 0.0, 1.0])         # not positive definite
    rows[3, 10:13] = torch.tensor([nan, 0.0, 1.0])          # NaN conic
    rows[4, 10:13] = torch.tensor([1.0, 0.0, 1.0])
    rows[4, 8] = float("inf")                                 # non-finite mean
    rows[5, 10:13] = torch.tensor([1.0, 0.0, 1.0])
    rows[5, 13] = nan                                         # NaN opacity
    strips = torch.tensor([[1e4, 1e4 + 15, 1e4, 1e4 + 1]]).repeat(6, 8, 1)  # far away
    assert rt.strip_mask_torch(rows, strips).all()
    rows[:, 13] = 0.0                                         # op < 1/255: never
    assert not rt.strip_mask_torch(rows, strips).any()


def test_cull_is_conservative_at_the_ellipse_boundary():
    """Pairs sampled within 1e-3 of the alpha >= 1/255 ellipse of 4,000
    random conics with condition numbers up to 1e5, each pixel its own
    one-pixel strip: every pair that passes is kept."""
    rng = np.random.default_rng(7)
    n, k = 4000, 64
    sig_small = np.exp(rng.uniform(np.log(0.3), np.log(3.0), n))
    sig_large = sig_small * np.exp(rng.uniform(0.0, np.log(300.0), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cov = rot @ (np.stack([sig_large, sig_small], 1)[:, :, None] ** 2 * np.eye(2)) \
        @ np.swapaxes(rot, 1, 2)
    inv = np.linalg.inv(cov)
    op = np.where(rng.uniform(size=n) < 0.2, EPS * (1 + rng.uniform(0, 1e-5, n)),
                  np.exp(rng.uniform(np.log(EPS), 0, n))).astype(np.float32)
    mean = rng.uniform(-50, 50, (n, 2)).astype(np.float32)
    rows = torch.zeros((n, rt.NA))
    rows[:, 8:10] = torch.from_numpy(mean)
    rows[:, 10:13] = torch.from_numpy(np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], 1)
                                      .astype(np.float32))
    rows[:, 13] = torch.from_numpy(op)
    # Points q(d) = kk (1 + u), u in [-1e-3, 1e-3], on random directions.
    kk = np.maximum(2 * np.log(255.0 * op.astype(np.float64)), 0.0)
    ang = rng.uniform(0, 2 * np.pi, (n, k))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1)
    qd = np.einsum("nki,nij,nkj->nk", dirs, inv, dirs)
    scale = np.sqrt(kk[:, None] * (1 + rng.uniform(-1e-3, 1e-3, (n, k))) / qd)
    pts = mean[:, None, :] + dirs * scale[..., None]
    px = torch.from_numpy(pts[..., 0].astype(np.float32))
    py = torch.from_numpy(pts[..., 1].astype(np.float32))
    use = passing(rows, px, py)
    strips = torch.stack([px, px, py, py], -1)               # one pixel per "strip"
    reach = torch.stack([rt.strip_mask_torch(rows, strips[:, i:i + 8])
                         for i in range(0, k, 8)], 1).reshape(n, k)
    assert int(use.sum()) > n * k // 4
    assert not bool((use & ~reach).any())


def test_cull_keeps_pairs_at_the_strip_edges():
    """Splats whose ellipses end, within 1e-3, at the pixel bounding a warp
    strip (the scene the card test renders through the CUDA cull): no
    passing pair is dropped, and many of those edge pixels pass."""
    s, offset, anchor = strip_edge_scene(np.random.default_rng(5), 256)
    table, binned, offx, offy, tiles_x = screen_inputs(s, 256, offset)
    bad, n_pass, culled = cull_violations(table, binned, offx, offy, tiles_x)
    assert bad == 0 and culled > 0
    n = len(anchor)
    at_edge = passing(table[:n], torch.from_numpy(anchor[:, :1]), torch.from_numpy(anchor[:, 1:]))
    assert int(at_edge.sum()) > n // 4, int(at_edge.sum())


def hand_scene():
    """Two 16x16 tiles.  Tile 0, front to back: E, a small splat (op 0.5,
    conic 2) at pixel (2, 0) that passes at 9 pixels of strips 0 and 1;
    A (op 0.9), B and C (op 0.99) covering both tiles, C stopping every
    pixel; D behind, never walked.  Tile 1: A, B, C, D."""
    big = (1e-6, 0.0, 1e-6)
    s = point_splats([[2.0, 0.0], [16.0, 8.0], [16.0, 8.0], [16.0, 8.0], [16.0, 8.0]],
                     [(2.0, 0.0, 2.0), big, big, big, big], [0.5, 0.9, 0.99, 0.99, 0.99],
                     radius=30)
    s["radius"][0] = 3
    s["radius_xy"][0] = 3
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    table, binned, offx, offy = rt.composite_inputs(
        t["mean2d"], t["conic"], t["depth"], t["radius"], t["opacity"], t["channels"],
        16, 32, cap=64, radius_xy=t["radius_xy"])
    return table, binned, offx, offy


def test_composite_work_matches_counts_taken_by_hand():
    table, binned, offx, offy = hand_scene()
    assert binned.tile_count.tolist() == [5, 4]
    w = rt.composite_work(table, binned.gather_idx, binned.tile_start, binned.tile_count,
                          offx, offy, 2)
    assert w["tile_walked"].tolist() == [4, 3]
    counts = {k: v for k, v in w.items() if k != "tile_walked"}
    # E's six culled strips hold 6 x 32 pixels, all still awake at slot 0.
    assert counts == {"entries": 9, "walked": 7, "pairs": 7 * 256, "kept_pairs": 7 * 256 - 6 * 32,
                      "passing": 9 + 6 * 256, "warp_slots": 7 * 8, "culled": 6,
                      "live": 2 + 6 * 8}


def test_stopping_splat_and_those_behind_it_get_zero_gradients():
    """On the hand scene the stopping splat C (never composited) and D
    behind it get exactly zero rows from the plain backward, the composited
    ones do not."""
    table, binned, offx, offy = hand_scene()
    args = (table, binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy)
    out, tfin = rt.composite_fwd_torch(*args, 2)
    rng = np.random.default_rng(2)
    dout = torch.from_numpy(rng.normal(0, 1, tuple(out.shape)).astype(np.float32))
    dtfin = torch.from_numpy(rng.normal(0, 1, tuple(tfin.shape)).astype(np.float32))
    g = rt.composite_bwd_torch(*args, out, tfin, dout, dtfin, 2)
    assert g.shape == table.shape
    assert (g[3:] == 0).all()                                 # C, D and the dummy row
    assert (g[:3, 13] != 0).all() and (g[:3, :3] != 0).all()
    assert float(tfin.max()) < 1.1e-3                         # T after B: C stops every pixel


def test_slice_gradients_match_the_jax_oracle_on_an_occluded_scene():
    """The composite with the per-gaussian backward, end to end through
    autograd, against the JAX package's tiled composite (Pallas, interpret
    mode) on a 32x32 scene where opaque splats occlude the rest down to
    T ~ 1e-3, AbsGS gradients included."""
    rng = np.random.default_rng(11)
    s = screen_splats(rng, 120)
    s["opacity"][:20] = 0.97
    wout, wt = readout_weights(rng, 32, 32)
    _, tf_j, g_j = jax_composite(jtiled, s, 32, 32, wout, wt)
    _, tfin, g = port_composite(s, 32, 32, wout, wt)
    assert float(tfin.min()) < 1e-2
    np.testing.assert_allclose(tfin, tf_j, atol=1e-2)
    assert_grads_close(g, g_j, 1e-3)
