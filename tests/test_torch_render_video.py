"""Port parity: the inference path (ops/rasterize.py ``_apply_entry_budget``
and ``entry_budget``, viz/paths.py, viz/video.py).

Tolerances, and why:
  * the entry-budget keep mask is integer bookkeeping over the same float32
    ratios with a stable sort, so it is IDENTICAL to JAX's, ties and an
    oversized splat included;
  * rendered frames (RGB) follow tests/test_torch_rasterize.py: 1e-5
    absolute except at pixels where a compositing threshold flips between
    two float32 roundings (<= 1% of pixels, 1e-2); radii after the budget
    are identical;
  * colourized depth frames: the depth percentiles and the colour table
    index move with those same ulps, so mean abs 1e-3 and max 0.1;
  * trajectory JSON files are byte-identical and the parsed cameras agree
    to 1e-6 (float32 matrices from the same float64 poses).
"""

import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.model.render import render as jrender
from skyfall_gs_tpu.ops import projection as jproj
from skyfall_gs_tpu.viz import paths as jpaths
from skyfall_gs_tpu.viz import video as jvideo
from skyfall_gs_tpu_torch.io.png import read_png
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.render import render as trender
from skyfall_gs_tpu_torch.ops import projection as tproj
from skyfall_gs_tpu_torch.ops import rasterize as tras
from skyfall_gs_tpu_torch.ops.binning import per_splat_entries
from skyfall_gs_tpu_torch.viz import paths as tpaths
from skyfall_gs_tpu_torch.viz import video as tvideo
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras
from tests.test_torch_rasterize import assert_forward_close, screen_splats

torch.set_num_threads(1)
# skyfall_gs_tpu.ops re-exports the function ``rasterize`` under the module's name
jras = importlib.import_module("skyfall_gs_tpu.ops.rasterize")


# ----------------------------------------------------------------------------
# _apply_entry_budget
# ----------------------------------------------------------------------------

def budget_case(rng, w=64, h=48):
    """Screen splats with exact ratio ties (duplicated splats), culled
    splats (all tied at -1) and one oversized splat covering every tile."""
    s = screen_splats(rng, n=120, width=w, height=h, spread=1.0)
    dup = rng.choice(120, 30, replace=False)
    s = {k: np.concatenate([v, v[dup]]) for k, v in s.items()}
    s["radius"][:5] = 0
    s["radius_xy"][:5] = 0
    s["mean2d"][7] = (w / 2, h / 2)
    s["radius"][7] = 200
    s["radius_xy"][7] = (200, 200)
    s["opacity"][7] = 0.9
    n = len(s["radius"])
    s["compensation"] = np.ones(n, np.float32)
    return s


def _proj(mod, s, arr):
    return mod.ProjectedGaussians(**{k: arr(s[k]) for k in (
        "mean2d", "conic", "depth", "radius", "opacity", "compensation", "radius_xy")})


@pytest.mark.parametrize("frac", [0.02, 0.1, 0.35, 0.7, 1.0])
def test_entry_budget_keep_mask_is_jax_s(rng, frac):
    s = budget_case(rng)
    jcam, tcam = cameras(64, 48)
    counts = per_splat_entries(torch.from_numpy(s["mean2d"]), torch.from_numpy(s["radius"]),
                               48, 64, radius_xy=torch.from_numpy(s["radius_xy"]))
    total = int(counts.sum())
    assert int(counts[7]) == 12 and total > 12            # the oversized splat: all tiles
    budget = max(int(frac * total), 1)
    jp = jras._apply_entry_budget(_proj(jproj, s, jnp.asarray), jcam, budget)
    tp = tras._apply_entry_budget(_proj(tproj, s, torch.from_numpy), tcam, budget)
    keep = tp.radius.numpy() > 0
    np.testing.assert_array_equal(keep, np.asarray(jp.radius) > 0)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    np.testing.assert_array_equal(tp.radius_xy.numpy(), np.asarray(jp.radius_xy))
    kept = int(counts.numpy()[keep].sum())
    assert kept <= budget
    if frac < 1.0:
        assert 0 < keep.sum() < (counts.numpy() > 0).sum()
    assert tp.radius.dtype == torch.int32 and tp.radius_xy.dtype == torch.int32


def test_entry_budget_is_inference_only(rng):
    jcam, tcam = cameras(32, 32)
    st = jg.create_from_points(rng.normal(0, 0.5, (40, 3)).astype(np.float32),
                               rng.uniform(0, 1, (40, 3)).astype(np.float32))
    ts = tg.state_from_numpy(jax_state_to_numpy(st))
    with pytest.raises(ValueError, match="inference-only"):
        trender(ts, tcam, torch.zeros(3), entry_budget=100)
    with pytest.raises(ValueError, match="inference-only"):
        jrender(st, jcam, jnp.zeros(3), entry_budget=100)


@pytest.fixture(scope="module")
def scene_state():
    rng = np.random.default_rng(11)
    n = 300
    st = jg.create_from_points(rng.normal(0, 0.6, (n, 3)).astype(np.float32),
                               rng.uniform(0, 1, (n, 3)).astype(np.float32),
                               max_sh_degree=1, init_opacity=0.7, capacity=320)
    st = st.replace(aux=st.aux.replace(filter_3d=jnp.full(st.params.capacity, 0.01)))
    return st, tg.state_from_numpy(jax_state_to_numpy(st))


@pytest.mark.parametrize("budget", [None, 400, 1500])
def test_render_with_entry_budget_matches_jax(scene_state, budget):
    js, ts = scene_state
    jcam, tcam = cameras(40, 32)
    ref = jax.jit(lambda m, c: jrender(m, c, jnp.zeros(3), inference=True, testing=True,
                                       entry_budget=budget))(js, jcam)
    out = trender(ts, tcam, torch.zeros(3), inference=True, testing=True,
                  entry_budget=budget)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    assert_forward_close(out.color.numpy(), np.asarray(ref.color))
    assert_forward_close(out.alpha.numpy(), np.asarray(ref.alpha))
    assert int(out.overflow) == int(ref.overflow) == 0
    n_vis = int((out.radii > 0).sum())
    if budget == 400:
        full = trender(ts, tcam, torch.zeros(3), inference=True, testing=True)
        assert n_vis < int((full.radii > 0).sum())


# ----------------------------------------------------------------------------
# Trajectories
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(target=[0, 0, 0], elevation_deg=45.0, radius=300.0,
                                     num_frames=5),
                                dict(target=[1.5, -2.0, 0.5], elevation_deg=70.0, radius=4.0,
                                     num_frames=3, fov_deg=40.0, width=64, height=48,
                                     fps=30)])
def test_orbit_paths_and_parsing_match_jax(tmp_path, kw):
    tpaths.save_orbit_path(str(tmp_path / "t.json"), **kw)
    jpaths.save_orbit_path(str(tmp_path / "j.json"), **kw)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for a, b in zip(tpaths.gen_orbit_path(kw["target"], kw["elevation_deg"], kw["radius"], 4),
                    jpaths.gen_orbit_path(kw["target"], kw["elevation_deg"], kw["radius"], 4)):
        np.testing.assert_array_equal(a, b)
    assert tpaths.ges_to_orbit(200.0, 10.0, 130.0) == jpaths.ges_to_orbit(200.0, 10.0, 130.0)
    tc, tr, tfps = tpaths.load_trajectory(str(tmp_path / "t.json"))
    jc, jr = jpaths.parse_trajectory_json(json.loads((tmp_path / "j.json").read_text()))
    assert tr == jr == kw["radius"] and tfps == kw.get("fps", 24)
    assert len(tc) == len(jc) == kw["num_frames"]
    for a, b in zip(tc, jc):
        assert (a.width, a.height, a.uid) == (b.width, b.height, int(b.uid))
        for k in ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy",
                  "focal_x", "focal_y"):
            np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("traj") / "p.json")
    jpaths.save_orbit_path(path, [0, 0, 0], 35.0, 3.0, num_frames=3, width=48, height=48)
    return path


@pytest.mark.parametrize("mode, budget", [("rgb", None), ("depth", None), ("rgb", 900)])
def test_render_trajectory_matches_jax(scene_state, trajectory, mode, budget):
    js, ts = scene_state
    jcams, _, _ = jpaths.load_trajectory(trajectory)
    tcams, _, _ = tpaths.load_trajectory(trajectory)
    jframes, _ = jvideo.render_trajectory(js, jcams, mode=mode, entry_budget=budget,
                                          report_fps=False)
    tframes, fps = tvideo.render_trajectory(ts, tcams, mode=mode, entry_budget=budget,
                                            report_fps=False)
    assert fps > 0 and len(tframes) == len(jframes) == 3
    for a, b in zip(tframes, jframes):
        assert a.shape == b.shape == (48, 48, 3)
        if mode == "rgb":
            assert_forward_close(a, np.asarray(b))
        else:
            diff = np.abs(a - np.asarray(b))
            assert diff.mean() <= 1e-3 and diff.max() <= 0.1, (diff.mean(), diff.max())
    assert max(float(np.abs(f).max()) for f in tframes) > 0.1


def test_recompute_filter_matches_jax(scene_state, trajectory):
    js, ts = scene_state
    jcams, _, _ = jpaths.load_trajectory(trajectory)
    tcams, _, _ = tpaths.load_trajectory(trajectory)
    ref = jvideo.recompute_filter_for_trajectory(js, jcams)
    got = tvideo.recompute_filter_for_trajectory(
        tg.state_from_numpy(jax_state_to_numpy(js)), tcams)
    np.testing.assert_allclose(got.aux.filter_3d.numpy(), np.asarray(ref.aux.filter_3d),
                               rtol=1e-6)


def test_render_trajectory_raises_on_overflow(scene_state, trajectory, monkeypatch):
    _, ts = scene_state
    tcams, _, _ = tpaths.load_trajectory(trajectory)
    monkeypatch.setattr(tvideo, "measure_bin_capacity", lambda *a, **k: 64)
    with pytest.raises(RuntimeError, match="binning overflow"):
        tvideo.render_trajectory(ts, tcams, report_fps=False)


# ----------------------------------------------------------------------------
# write_video
# ----------------------------------------------------------------------------

def _frames(rng, n=4, h=24, w=32):
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n)]


def test_write_video_writes_an_mp4(tmp_path, rng):
    out = tvideo.write_video(str(tmp_path / "sub" / "v.mp4"), _frames(rng), fps=12)
    assert out == str(tmp_path / "sub" / "v.mp4")
    assert (tmp_path / "sub" / "v.mp4").stat().st_size > 0


def test_write_video_png_directory_without_opencv(tmp_path, rng, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)          # import cv2 -> ImportError
    frames = _frames(rng)
    out = tvideo.write_video(str(tmp_path / "v.mp4"), frames)
    assert out == str(tmp_path / "v") and "PNG frames" in capsys.readouterr().out
    files = sorted((tmp_path / "v").iterdir())
    assert [f.name for f in files] == [f"{i:05d}.png" for i in range(4)]
    for f, frame in zip(files, frames):
        np.testing.assert_array_equal(read_png(str(f)), (frame * 255).astype(np.uint8))
