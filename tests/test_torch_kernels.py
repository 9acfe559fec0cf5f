"""The compositing kernels themselves (skyfall_gs_tpu_torch/csrc).

The CUDA tests need a card and skip without one; run them on a GPU machine
with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: this file imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed).  The build test runs anywhere.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'composite.cu(1): error: boom' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(rt, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom"):
        rt.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


def strip_edge_scene(rng, size: int):
    """One splat per 16x16 tile whose alpha >= 1/255 ellipse ends at a pixel
    on one edge of one of the tile's 16x2 warp strips: the pixel that bounds
    the strip on that side (its x min, x max, y min or y max) is the
    ellipse's extreme point along that axis, moved by a factor within 1e-3
    of 1 (inside or outside).  Conics of condition up to ~1e5, a fifth of
    the opacities within 1e-5 of 1/255, random subpixel offsets.

    Returns (splats as numpy arrays, offset (size, size, 2), anchor pixel
    centres (n, 2)).
    """
    eps = np.float32(1.0 / 255.0)
    tiles = size // 16
    n = tiles * tiles
    offset = rng.uniform(-0.5, 0.5, (size, size, 2)).astype(np.float32)
    grid = np.arange(size, dtype=np.float32)
    cx = grid[None, :] + offset[..., 0]
    cy = grid[:, None] + offset[..., 1]
    sig_small = np.exp(rng.uniform(np.log(0.12), np.log(2.0), n))
    sig_large = np.minimum(sig_small * np.exp(rng.uniform(0.0, np.log(300.0), n)), 40.0)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    cov = rot @ (np.stack([sig_large, sig_small], 1)[:, :, None] ** 2 * np.eye(2)) \
        @ np.swapaxes(rot, 1, 2)
    conic = np.linalg.inv(cov)[:, [0, 0, 1], [0, 1, 1]].astype(np.float32)
    op = np.where(rng.uniform(size=n) < 0.2, eps * (1 + rng.uniform(0, 1e-5, n)),
                  np.exp(rng.uniform(np.log(eps), 0, n))).astype(np.float32)
    a, b, cc = (conic[:, i].astype(np.float64) for i in range(3))
    det = a * cc - b * b
    k = np.maximum(2 * np.log(255.0 * op.astype(np.float64)), 0.0)
    ex, ey = np.sqrt(k * cc / det), np.sqrt(k * a / det)
    side = rng.integers(0, 4, n)
    warp = rng.integers(0, 8, n)
    ty, tx = np.divmod(np.arange(n), tiles)
    anchor = np.empty((n, 2))
    reach = np.empty((n, 2))                       # anchor - mean at the extreme point
    for i in range(n):
        rows = slice(16 * ty[i] + 2 * warp[i], 16 * ty[i] + 2 * warp[i] + 2)
        cols = slice(16 * tx[i], 16 * tx[i] + 16)
        sx, sy = cx[rows, cols].ravel(), cy[rows, cols].ravel()
        j = (np.argmin(sx), np.argmax(sx), np.argmin(sy), np.argmax(sy))[side[i]]
        anchor[i] = sx[j], sy[j]
        reach[i] = ((ex[i], -b[i] / cc[i] * ex[i]), (-ex[i], b[i] / cc[i] * ex[i]),
                    (-b[i] / a[i] * ey[i], ey[i]), (b[i] / a[i] * ey[i], -ey[i]))[side[i]]
    mean = anchor - reach * (1 + rng.uniform(-1e-3, 1e-3, n))[:, None]
    splats = dict(
        mean2d=mean.astype(np.float32), conic=conic, opacity=op,
        depth=rng.uniform(1.0, 10.0, n).astype(np.float32),
        radius=np.ceil(3.0 * sig_large).astype(np.int32),
        radius_xy=np.ceil(np.stack([ex, ey], 1) + 0.5).astype(np.int32),
        channels=rng.uniform(-1.0, 1.0, (n, 7)).astype(np.float32))
    return splats, offset, anchor.astype(np.float32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_forward_equals_plain_at_the_strip_edges_on_the_card():
    """The CUDA strip cull (fast log, fused multiply-adds) keeps every pair
    that passes: on splats whose ellipses end at the edge pixels of warp
    strips the forward equals its plain version exactly, and the
    per-gaussian gradients agree per column."""
    cs = _cuda()
    dev = torch.device("cuda")
    size = 512
    s, offset, _ = strip_edge_scene(np.random.default_rng(5), size)
    t = {k: torch.from_numpy(v).to(dev) for k, v in s.items()}
    table, binned, offx, offy = rt.composite_inputs(
        t["mean2d"], t["conic"], t["depth"], t["radius"], t["opacity"], t["channels"],
        size, size, subpixel_offset=torch.from_numpy(offset).to(dev), cap=1 << 20,
        radius_xy=t["radius_xy"])
    assert int(binned.overflow) == 0
    args = (table, binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy,
            size // 16)
    out_k, tf_k = rt.composite_fwd(*args)
    out_p, tf_p = rt.composite_fwd_torch(*args)
    assert torch.equal(out_k, out_p) and torch.equal(tf_k, tf_p)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = cs.kernels_vs_plain(torch, rt, (table, binned, offx, offy, size // 16),
                              torch.randn(tuple(out_p.shape), device=dev, generator=gen),
                              torch.randn(tuple(tf_p.shape), device=dev, generator=gen))
    assert res["grad_rel_colmax"] <= 1e-4
    assert res["grad_rel_norm"] <= 1e-4


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both kernels against their plain versions on the card, on a scene
    with a saturated tile and tiles of more than 1k entries."""
    cs = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    m, c, d, r, o, ch, rxy, off = [torch.from_numpy(a).to(dev) for a in
                                   cs.screen_scene(np.random.default_rng(0))]
    table, binned, offx, offy = rt.composite_inputs(
        m, c, d, r, o, ch, 128, 128, subpixel_offset=off, cap=1 << 16, radius_xy=rxy)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = binned.tile_start.shape[0]
    res = cs.kernels_vs_plain(torch, rt, (table, binned, offx, offy, 8),
                              torch.randn((t, rt.NCH, rt.P), device=dev, generator=gen),
                              torch.randn((t, rt.P), device=dev, generator=gen))
    assert res["fwd_max_abs"] <= 1e-4
    assert res["grad_rel_colmax"] <= 1e-4
    assert res["grad_rel_norm"] <= 1e-4
    assert res["grad"].shape == table.shape


@pytest.mark.cuda
def test_kernel_wrappers_count_launches_and_check_inputs():
    cs = _cuda()
    dev = torch.device("cuda")
    m, c, d, r, o, ch, rxy, _ = [torch.from_numpy(a).to(dev) for a in
                                 cs.screen_scene(np.random.default_rng(1))]
    table, binned, offx, offy = rt.composite_inputs(m, c, d, r, o, ch, 128, 128,
                                                    cap=1 << 16, radius_xy=rxy)
    args = (binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy, 8)
    before = (rt.composite_fwd.launches, rt.composite_bwd.launches)
    out, tfin = rt.composite_fwd(table, *args)
    grad = rt.composite_bwd(table, *args[:5], out, tfin, torch.ones_like(out),
                            torch.ones_like(tfin), 8)
    assert (rt.composite_fwd.launches, rt.composite_bwd.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    assert grad.shape == table.shape
    with pytest.raises(ValueError, match="table"):
        rt.composite_fwd(table.double(), *args)
    with pytest.raises(ValueError, match="dout"):
        rt.composite_bwd(table, *args[:5], out, tfin, torch.ones_like(out).double(),
                         torch.ones_like(tfin), 8)
    with pytest.raises(ValueError, match="gather_idx"):
        rt.composite_bwd(table, binned.gather_idx.int(), *args[1:5], out, tfin,
                         torch.ones_like(out), torch.ones_like(tfin), 8)
    assert (rt.composite_fwd.launches, rt.composite_bwd.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    torch.cuda.synchronize()
