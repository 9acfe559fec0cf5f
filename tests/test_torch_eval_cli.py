"""The port's evaluation CLIs (cli/eval_photometric.py, cli/eval_geometry.py)
end to end on synthetic artifacts on the CPU: the JAX package's CLI tests
rerun on the port, and ``evaluate_scene`` of both packages on one scene.

Tolerance: the two packages' ``evaluate_scene`` on checkpoints written
from one numpy state by each package's own ``save_checkpoint`` agree on
MAE and RMSE within 1e-3 m and on completeness within 1e-3 (the depth
renders differ by float32 compositing order only; the DSM chain after them
is the same numpy code).
"""

import os

import cv2
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.cli.eval_geometry import evaluate_scene as jevaluate_scene
from skyfall_gs_tpu.cli.eval_photometric import main as jphoto_main
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.train import checkpoint as jckpt
from skyfall_gs_tpu.train.step import init_train_state as jinit_train_state
from skyfall_gs_tpu_torch.cli import eval_geometry, eval_photometric
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.train import checkpoint as tckpt
from skyfall_gs_tpu_torch.train.step import init_train_state
from tests.test_io import _make_satellite_fixture
from tests.test_torch_core import jax_state_to_numpy

torch.set_num_threads(1)


def _write_video(path, frames, fps=24):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write((np.clip(f[..., ::-1], 0, 1) * 255).astype(np.uint8))
    vw.release()


class TestPhotometricCLI:
    def test_full_run_matches_jax(self, tmp_path, rng):
        frames = [rng.uniform(0.2, 0.8, (64, 64, 3)).astype(np.float32) for _ in range(6)]
        noisy = [np.clip(f + rng.normal(0, 0.05, f.shape), 0, 1).astype(np.float32)
                 for f in frames]
        os.makedirs(tmp_path / "gt")
        os.makedirs(tmp_path / "ours")
        _write_video(tmp_path / "gt" / "S1.mp4", frames)
        _write_video(tmp_path / "ours" / "S1.mp4", noisy)
        argv = ["--root", str(tmp_path), "--methods", "ours", "--scenes", "S1", "S2",
                "--num_frames", "4", "--no_resize"]
        rows = eval_photometric.main(argv + ["--out_csv", str(tmp_path / "res.csv"),
                                             "--device", "cpu"])
        jphoto_main(argv + ["--out_csv", str(tmp_path / "jres.csv")])
        text = open(tmp_path / "res.csv").read()
        assert "psnr" in text and "ours" in text
        import csv as csvmod

        got = list(csvmod.DictReader(open(tmp_path / "res.csv")))
        want = list(csvmod.DictReader(open(tmp_path / "jres.csv")))
        assert len(rows) == len(got) == len(want) == 1      # S2 has no videos: skipped
        assert float(got[0]["psnr"]) > 15
        assert got[0].keys() == want[0].keys()
        for k in ("psnr", "ssim", "psnr_std", "ssim_std"):
            assert float(got[0][k]) == pytest.approx(float(want[0][k]), rel=1e-5, abs=1e-6), k

    def test_device_cuda_without_a_card_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_photometric.main(["--root", str(tmp_path), "--methods", "m", "--scenes", "s",
                                   "--out_csv", str(tmp_path / "r.csv")])


@pytest.fixture(scope="module")
def plane_scene(tmp_path_factory):
    """A flat-ish plane of splats around z = 10 (the JAX CLI test's), its
    checkpoint written by each package from one numpy state, a 2-view
    satellite scene looking down at it and a 64x64 GT DSM (truth 10 m)."""
    tmp = tmp_path_factory.mktemp("plane")
    rng = np.random.default_rng(0)
    n = 400
    pts = np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                    10.0 + rng.normal(0, 0.2, n)], 1).astype(np.float32)
    cols = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    jst = jinit_train_state(create_from_points(pts, cols, capacity=512, init_opacity=0.95))
    jckpt.save_checkpoint(str(tmp / "j.npz"), jst, 1)
    tckpt.save_checkpoint(str(tmp / "t.npz"), init_train_state(
        tg.state_from_numpy(jax_state_to_numpy(jst.model))), 1)
    scene_dir = str(tmp / "scene")
    _make_satellite_fixture(scene_dir, rng, n_frames=2, size=32)
    gt_dir = str(tmp / "gt")
    os.makedirs(gt_dir)
    np.savetxt(os.path.join(gt_dir, "TEST_DSM.txt"), [-50.0, -50.0, 64, 1.5625])
    cv2.imwrite(os.path.join(gt_dir, "TEST_DSM.tif"), np.full((64, 64), 10.0, np.float32))
    # A second AOI with a water class over a quarter of the grid.
    np.savetxt(os.path.join(gt_dir, "WATER_DSM.txt"), [-50.0, -50.0, 64, 1.5625])
    gt = 10.0 + 0.05 * np.arange(64, dtype=np.float32)[None, :].repeat(64, 0)
    cv2.imwrite(os.path.join(gt_dir, "WATER_DSM.tif"), gt)
    cls = np.full((64, 64), 2, np.uint8)
    cls[:32, :32] = 9
    cv2.imwrite(os.path.join(gt_dir, "WATER_CLS.tif"), cls)
    return tmp, scene_dir, gt_dir


class TestGeometryCLI:
    def test_full_scene_eval(self, plane_scene):
        """Checkpoint -> depth render -> DSM -> registration -> MAE."""
        tmp, scene_dir, gt_dir = plane_scene
        m = eval_geometry.evaluate_scene(str(tmp / "t.npz"), scene_dir, gt_dir, "TEST",
                                         device="cpu")
        assert np.isfinite(m["mae"])
        assert m["completeness"] > 0.05
        assert m["mae"] < 2.0

    @pytest.mark.parametrize("aoi", ["TEST", "WATER"])
    def test_matches_jax(self, plane_scene, aoi):
        tmp, scene_dir, gt_dir = plane_scene
        got = eval_geometry.evaluate_scene(str(tmp / "t.npz"), scene_dir, gt_dir, aoi,
                                           device="cpu")
        want = jevaluate_scene(str(tmp / "j.npz"), scene_dir, gt_dir, aoi)
        assert got["iteration"] == want["iteration"] == 1 and got["scene"] == aoi
        assert got["cloud_points"] > 0 and got["valid_pixels"] > 0
        for k in ("mae", "rmse", "completeness"):
            assert got[k] == pytest.approx(want[k], abs=1e-3), (k, got[k], want[k])
        for k in ("shift_dx", "shift_dy"):
            assert got[k] == want[k], k

    def test_cli_writes_csv_and_dsm_and_raises_on_overflow(self, plane_scene, tmp_path,
                                                           monkeypatch):
        tmp, scene_dir, gt_dir = plane_scene
        from skyfall_gs_tpu_torch.viz.paths import save_orbit_path

        path = save_orbit_path(str(tmp_path / "paths"), [0.0, 0.0, 10.0], 80.0, 300.0,
                               num_frames=3, width=40, height=32)
        argv = ["--checkpoint", str(tmp / "t.npz"), "-s", scene_dir, "--gt_dir", gt_dir,
                "--aoi_id", "TEST", "--camera_path", path,
                "--device", "cpu"]
        m = eval_geometry.main(argv + ["--out_dir", str(tmp_path / "out"),
                                       "--csv", str(tmp_path / "m.csv")])
        assert np.isfinite(m["mae"]) and (tmp_path / "m.csv").is_file()
        assert np.load(tmp_path / "out" / "TEST_dsm_pred.npy").shape == (64, 64)
        from skyfall_gs_tpu_torch.model import render as trender

        monkeypatch.setattr(trender, "measure_bin_capacity", lambda *a, **k: 8)
        with pytest.raises(RuntimeError, match="binning overflow"):
            eval_geometry.main(argv)
