"""Port parity: the small tools (cli/merge_images.py, cli/align_ges.py,
cli/convert.py, cli/render_videos.py) and the scene launcher
(parallel/launcher.py).

The host-only tools are copies, so their outputs are held EQUAL to the JAX
package's: merged frames byte for byte, COLMAP's command sequence and the
tree it leaves, the launcher's and render_videos' job lists (with the
module names swapped and ``--device`` added).  ``align_ges``' score is an
SSIM of renders, held to the JAX package's at 1e-4 (two rasterizers,
float32).
"""

import argparse
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.cli import align_ges as jalign
from skyfall_gs_tpu.cli import convert as jconvert
from skyfall_gs_tpu.cli import merge_images as jmerge
from skyfall_gs_tpu.cli import render_videos as jrender_videos
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.parallel import launcher as jlauncher
from skyfall_gs_tpu.train.checkpoint import save_checkpoint
from skyfall_gs_tpu.train.step import init_train_state
from skyfall_gs_tpu_torch.cli import align_ges, convert, merge_images, render_videos
from skyfall_gs_tpu_torch.cli.render_video import load_state_from_checkpoint
from skyfall_gs_tpu_torch.parallel.launcher import SceneJob, make_training_jobs, run_scene_jobs

torch.set_num_threads(1)


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ----------------------------------------------------------------------------
# merge_images (tests/test_eval_cli.py:98-128 on the port)
# ----------------------------------------------------------------------------

def test_merge_images_wipe_and_side(tmp_path, rng):
    la, lb = tmp_path / "a", tmp_path / "b"
    os.makedirs(la), os.makedirs(lb)
    for i in range(3):
        cv2.imwrite(str(la / f"{i:03d}.png"), np.full((32, 32, 3), 40, np.uint8))
        cv2.imwrite(str(lb / f"{i:03d}.png"), np.full((32, 32, 3), 200, np.uint8))
    out = tmp_path / "out"
    merge_images.main(["--left", str(la), "--right", str(lb), "--out", str(out)])
    m = cv2.imread(str(out / "001.png")).astype(np.float32) / 255.0
    assert abs(m[0, 4, 0] - 40 / 255.0) < 0.02
    assert abs(m[0, 28, 0] - 200 / 255.0) < 0.02
    out2 = tmp_path / "out2"
    merge_images.main(["--left", str(la), "--right", str(lb), "--out", str(out2),
                       "--mode", "side"])
    assert cv2.imread(str(out2 / "000.png")).shape[1] == 64
    a = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    b = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(merge_images.merge_pair(a, b, 0.0)[:, 1:], b[:, 1:])


@pytest.mark.parametrize("flags", [[], ["--mode", "side"], ["--sweep"]],
                         ids=["wipe", "side", "sweep"])
def test_merge_images_equals_jax(tmp_path, rng, flags):
    la, lb = tmp_path / "a", tmp_path / "b"
    os.makedirs(la), os.makedirs(lb)
    for i in range(4):
        cv2.imwrite(str(la / f"{i:03d}.png"), rng.integers(0, 256, (24, 40, 3), np.uint8))
        cv2.imwrite(str(lb / f"{i:03d}.png"), rng.integers(0, 256, (12, 20, 3), np.uint8))
    os.remove(lb / "002.png")                       # a frame missing on one side
    for mod, out in ((merge_images, "t"), (jmerge, "j")):
        mod.main(["--left", str(la), "--right", str(lb), "--out", str(tmp_path / out)]
                 + flags)
    got, ref = tree(tmp_path / "t"), tree(tmp_path / "j")
    assert sorted(got) == ["000.png", "001.png", "003.png"] and got == ref


# ----------------------------------------------------------------------------
# align_ges
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ges(tmp_path_factory):
    """A tiny checkpoint (64 splats) and two random 32 px "GES" frames
    (the JAX slow test's fixture)."""
    root = tmp_path_factory.mktemp("ges")
    rng = np.random.default_rng(0)
    n = 64
    pts = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                    rng.normal(0, 1, n)], 1).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
    save_checkpoint(str(root / "ck.npz"),
                    init_train_state(create_from_points(pts, cols, capacity=128,
                                                        init_opacity=0.9)), 1)
    os.makedirs(root / "frames")
    for i in range(2):
        cv2.imwrite(str(root / "frames" / f"f{i}.png"),
                    (rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8))
    return root


def test_align_ges_score_matches_jax(ges):
    from skyfall_gs_tpu.cli.render_video import load_state_from_checkpoint as jload

    args = argparse.Namespace(target_x=0.0, target_y=0.0, elevation=45.0, radius=60.0,
                              fov=60.0)
    ref = align_ges._load_frames(str(ges / "frames"), 2)
    assert len(ref) == 2 and ref[0].shape == (32, 32, 3)
    np.testing.assert_array_equal(ref[0], jalign._load_frames(str(ges / "frames"), 2)[0])
    ref_t = torch.from_numpy(np.stack(ref)).permute(0, 3, 1, 2).contiguous()
    state, _ = load_state_from_checkpoint(str(ges / "ck.npz"), device="cpu")
    jstate, _ = jload(str(ges / "ck.npz"))
    scores = []
    for alt in (-10.0, 35.0):
        s = align_ges.score_alignment(state, alt, args, ref_t)
        np.testing.assert_allclose(s, jalign.score_alignment(jstate, alt, args, ref),
                                   rtol=0, atol=1e-4)
        scores.append(s)
    assert scores[0] != scores[1]


def test_align_ges_main_writes_the_aligned_orbit(ges, tmp_path):
    out_json = str(tmp_path / "path.json")
    best = align_ges.main(["--checkpoint", str(ges / "ck.npz"), "--ges_frames",
                           str(ges / "frames"), "--iters", "2", "--num_frames", "2",
                           "--radius", "60", "--out_path", out_json, "--device", "cpu"])
    path = json.load(open(out_json))
    assert len(path["camera_path"]) == 240
    assert (path["render_width"], path["render_height"]) == (32, 32)
    assert path["_target"] == [0.0, 0.0, best]
    # the same two ternary steps, replayed through score_alignment
    args = argparse.Namespace(target_x=0.0, target_y=0.0, elevation=45.0, radius=60.0,
                              fov=60.0)
    state, _ = load_state_from_checkpoint(str(ges / "ck.npz"), device="cpu")
    ref = torch.from_numpy(np.stack(align_ges._load_frames(str(ges / "frames"), 2)))
    ref = ref.permute(0, 3, 1, 2).contiguous()
    lo, hi = -50.0, 150.0
    for _ in range(2):
        m1, m2 = lo + (hi - lo) / 3.0, hi - (hi - lo) / 3.0
        if align_ges.score_alignment(state, m1, args, ref) < \
                align_ges.score_alignment(state, m2, args, ref):
            lo = m1
        else:
            hi = m2
    assert best == 0.5 * (lo + hi)


def test_align_ges_finds_a_known_altitude_on_the_satellite_city(tmp_path):
    """GES frames rendered from a model at a known target altitude z*: the
    search over [-10, 110] m, where SSIM(altitude) rises to z* and falls
    after it on this scene (beyond that range the tails wiggle by ~0.01:
    not unimodal), ends within its final bracket of z*."""
    from skyfall_gs_tpu_torch.io.synthetic import satellite_city
    from skyfall_gs_tpu_torch.model.gaussians import create_from_points as tcreate
    from skyfall_gs_tpu_torch.model.render import render
    from skyfall_gs_tpu_torch.train.checkpoint import save_checkpoint as tsave
    from skyfall_gs_tpu_torch.train.step import init_train_state as tinit
    from skyfall_gs_tpu_torch.viz.paths import gen_orbit_path, parse_trajectory_json

    z_star, lo, hi, iters = 25.0, -10.0, 110.0, 8
    pts, cols = satellite_city(np.random.default_rng(0), 2000)
    state = tcreate(pts, cols, capacity=2048, init_opacity=0.9)
    state.aux.filter_3d.fill_(0.5)
    tsave(str(tmp_path / "city.npz"), tinit(state), 1)
    cams, _ = parse_trajectory_json({"render_height": 36, "render_width": 64, "camera_path": [
        {"camera_to_world": c.flatten().tolist(), "fov": 60.0}
        for c in gen_orbit_path([0.0, 0.0, z_star], 45.0, 200.0, 2)]})
    os.makedirs(tmp_path / "ges")
    for i, cam in enumerate(cams):
        img = render(state, cam, torch.zeros(3), testing=True, inference=True).color
        cv2.imwrite(str(tmp_path / "ges" / f"{i}.png"),
                    (torch.clamp(img, 0, 1) * 255).to(torch.uint8).numpy()[..., ::-1])
    best = align_ges.main(["--checkpoint", str(tmp_path / "city.npz"), "--ges_frames",
                           str(tmp_path / "ges"), "--num_frames", "2", "--alt_lo", str(lo),
                           "--alt_hi", str(hi), "--out_path", str(tmp_path / "p.json"),
                           "--device", "cpu"])
    assert abs(best - z_star) <= (hi - lo) * (2 / 3) ** iters

    args = argparse.Namespace(target_x=0.0, target_y=0.0, elevation=45.0, radius=200.0,
                              fov=60.0)
    ref = torch.from_numpy(np.stack(align_ges._load_frames(str(tmp_path / "ges"), 2)))
    ref = ref.permute(0, 3, 1, 2).contiguous()
    curve = [align_ges.score_alignment(state, a, args, ref) for a in np.arange(lo, hi + 1, 20)]
    peak = int(np.argmax(curve))
    assert peak in (1, 2) and curve[peak] > 0.9        # the grid points beside 25 m
    assert np.all(np.diff(curve[:peak + 1]) > 0) and np.all(np.diff(curve[peak:]) < 0), curve


def test_device_defaults_to_cuda_and_raises_without_it(ges, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        align_ges.main(["--checkpoint", str(ges / "ck.npz"), "--ges_frames",
                        str(ges / "frames")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_videos.main(["--output_root", str(tmp_path), "--scenes", "a",
                            "--camera_paths", str(tmp_path)])
    assert not (tmp_path / "render_logs").exists()


# ----------------------------------------------------------------------------
# The launcher (tests/test_infra.py:91-113 on the port) and render_videos
# ----------------------------------------------------------------------------

def test_launcher_runs_jobs_and_isolates_failures(tmp_path):
    jobs = [SceneJob("ok", [sys.executable, "-c", "print('fine')"]),
            SceneJob("bad", [sys.executable, "-c", "raise SystemExit(3)"]),
            SceneJob("ok2", [sys.executable, "-c", "import os; print(os.environ['SLOT'])"]),
            SceneJob("missing", [str(tmp_path / "no_such_program")])]
    out = run_scene_jobs(jobs, str(tmp_path), num_workers=2,
                         slot_envs=[{"SLOT": "s0"}, {"SLOT": "s1"}])
    assert {j.name: j.returncode for j in out} == {"ok": 0, "bad": 3, "ok2": 0, "missing": 127}
    assert "fine" in open(tmp_path / "ok.log").read()
    assert open(tmp_path / "ok2.log").read().strip() in ("s0", "s1")
    assert "could not start" in open(tmp_path / "missing.log").read()


@pytest.mark.parametrize("kw", [dict(idu=True), dict(extra_args=["--iterations", "200"],
                                                     python="/usr/bin/python3")],
                         ids=["idu", "extra_args"])
def test_make_training_jobs_matches_jax(kw):
    jobs = make_training_jobs(["JAX_004", "NYC_010"], "/data", "/out", **kw)
    ref = jlauncher.make_training_jobs(["JAX_004", "NYC_010"], "/data", "/out", **kw)
    assert [j.name for j in jobs] == [j.name for j in ref]
    for j, r in zip(jobs, ref):
        assert r.argv[2] == "skyfall_gs_tpu.cli.train"
        assert j.argv == r.argv[:2] + ["skyfall_gs_tpu_torch.cli.train"] + r.argv[3:]
    if kw.get("idu"):
        assert "--iterative_datasets_update" in jobs[0].argv
        assert any("chkpnt30000" in a for a in jobs[0].argv)


@pytest.mark.parametrize("flags", [["--num_workers", "2"], ["--mode", "depth", "--iteration",
                                                            "200"]], ids=["rgb", "depth"])
def test_render_videos_jobs_match_jax(tmp_path, monkeypatch, flags):
    paths = tmp_path / "paths"
    os.makedirs(paths)
    for name in ("camera_path_a.json", "camera_path_b.json"):
        (paths / name).write_text("{}")
    got = {}

    def capture(key):
        def run(jobs, log_dir, num_workers=1, slot_envs=None):
            got[key] = (jobs, log_dir, num_workers)
            return jobs
        return run

    monkeypatch.setattr(render_videos, "run_scene_jobs", capture("t"))
    monkeypatch.setattr(jrender_videos, "run_scene_jobs", capture("j"))
    argv = ["--output_root", str(tmp_path), "--scenes", "s1", "s2", "--camera_paths",
            str(paths)] + flags
    render_videos.main(argv + ["--device", "cpu"])
    jrender_videos.main(argv)
    (tjobs, tlog, tn), (jjobs, jlog, jn) = got["t"], got["j"]
    assert (tlog, tn) == (jlog, jn) and len(tjobs) == len(jjobs) == 4
    for t, j in zip(tjobs, jjobs):
        assert t.name == j.name
        assert j.argv[2] == "skyfall_gs_tpu.cli.render_video"
        assert t.argv == (j.argv[:2] + ["skyfall_gs_tpu_torch.cli.render_video"]
                          + j.argv[3:] + ["--device", "cpu"])


# ----------------------------------------------------------------------------
# convert, against a fake colmap
# ----------------------------------------------------------------------------

FAKE_COLMAP = """#!{python}
import os, shutil, sys
with open(os.environ["FAKE_COLMAP_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
args = dict(zip(sys.argv[2::2], sys.argv[3::2]))
if sys.argv[1] == "mapper":
    os.makedirs(os.path.join(args["--output_path"], "0"), exist_ok=True)
    open(os.path.join(args["--output_path"], "0", "cameras.bin"), "wb").write(b"cam")
elif sys.argv[1] == "image_undistorter":
    out = args["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "wb").write(name.encode())
    shutil.copytree(args["--image_path"], os.path.join(out, "images"), dirs_exist_ok=True)
"""


@pytest.mark.parametrize("flags", [[], ["--skip_matching"], ["--resize", "--no_gpu"]],
                         ids=["default", "skip_matching", "resize"])
def test_convert_matches_jax(tmp_path, monkeypatch, rng, flags):
    bin_dir = tmp_path / "bin"
    os.makedirs(bin_dir)
    (bin_dir / "colmap").write_text(FAKE_COLMAP.format(python=sys.executable))
    (bin_dir / "colmap").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    logs = {}
    for mod, name in ((convert, "t"), (jconvert, "j")):
        scene = tmp_path / name / "scene"
        os.makedirs(scene / "input")
        for i in range(2):
            cv2.imwrite(str(scene / "input" / f"{i}.png"),
                        np.random.default_rng(i).integers(0, 256, (32, 48, 3), np.uint8))
        if "--skip_matching" in flags:
            os.makedirs(scene / "distorted" / "sparse" / "0")
        log = tmp_path / name / "colmap.log"
        monkeypatch.setenv("FAKE_COLMAP_LOG", str(log))
        mod.main(["-s", str(scene)] + flags)
        logs[name] = log.read_text().replace(str(scene), "<scene>")
    assert logs["t"] == logs["j"]
    steps = [line.split()[0] for line in logs["t"].splitlines()]
    assert steps == (["image_undistorter"] if "--skip_matching" in flags else
                     ["feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"])
    got, ref = tree(tmp_path / "t" / "scene"), tree(tmp_path / "j" / "scene")
    assert got == ref
    assert {"sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin"} <= set(got)
    assert ("images_8/1.png" in got) == ("--resize" in flags)
    if "--resize" in flags:
        assert cv2.imread(str(tmp_path / "t" / "scene" / "images_2" / "0.png")).shape == \
            (16, 24, 3)
        assert "--SiftExtraction.use_gpu 0" in logs["t"]


def test_convert_without_colmap_exits(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        convert.main(["-s", str(tmp_path)])
    assert e.value.code == 1

