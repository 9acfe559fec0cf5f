"""Port parity: the command-line chain (cli/train.py, cli/gen_render_path.py,
cli/render_video.py, cli/create_fused_ply.py) on the CPU.

The chain of tests/test_cli_pipeline.py runs through the port's CLIs with
``--device cpu`` on the 48 px satellite scene that the JAX package's
``scripts/make_synthetic_satellite.py`` writes: scene from disk -> 24
training iterations with densification -> checkpoint and PLY -> orbit path
-> videos from the checkpoint and from a fused PLY, and a ``.splat``.  The
artifacts are held against the JAX package's: ``cfg_args.json`` equal for
the same argv, the same checkpoint keys and shapes, the same PLY layout;
the render tools read checkpoints of both packages.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

from skyfall_gs_tpu import config as jconfig
from skyfall_gs_tpu.cli import gen_render_path as jpath_cli
from skyfall_gs_tpu.cli import render_video as jrv
from skyfall_gs_tpu.cli import train as jtrain_cli
from skyfall_gs_tpu.io import gaussian_ply as jply
from skyfall_gs_tpu.train import checkpoint as jckpt
from skyfall_gs_tpu.train.step import init_train_state as jinit
from skyfall_gs_tpu_torch.cli import create_fused_ply, gen_render_path, render_video
from skyfall_gs_tpu_torch.cli import train as train_cli
from skyfall_gs_tpu_torch.io.gaussian_ply import load_splat
from skyfall_gs_tpu_torch.io.ply import read_ply
from tests.test_cli_pipeline import _write_scene

torch.set_num_threads(1)
IT = 24


def train_argv(scene_dir, model_dir):
    return ["-s", str(scene_dir), "-m", str(model_dir), "--eval",
            "--iterations", str(IT),
            "--densify_from_iter", "8", "--densification_interval", "8",
            "--densify_until_iter", "20",
            "--test_iterations", str(IT), "--save_iterations", str(IT),
            "--checkpoint_iterations", str(IT), "--quiet"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    _write_scene(root / "scene")
    trainer, state = train_cli.main(train_argv(root / "scene", root / "model")
                                    + ["--device", "cpu"])
    return root, trainer, state


def test_train_writes_the_jax_artifact_layout(chain):
    root, trainer, state = chain
    model = root / "model"
    for name in ("cfg_args.json", "input.ply", "cameras.json", f"chkpnt{IT}.npz",
                 f"point_cloud/iteration_{IT}/point_cloud.ply", "metrics.jsonl"):
        assert (model / name).is_file() and (model / name).stat().st_size > 0, name
    assert state.step == IT and int(trainer.max_overflow) == 0
    assert trainer.scene.scene_type == "satellite" and trainer.scene.num_train == 5
    records = [json.loads(line) for line in open(model / "metrics.jsonl")]
    assert [r["iter"] for r in records if r["type"] == "densify"] == [16]
    assert any(r["type"] == "eval" and r["split"] == "test" and np.isfinite(r["psnr"])
               for r in records)

    # cfg_args.json: what the JAX CLI writes for the same argv
    args = jtrain_cli.build_parser().parse_args(train_argv(root / "scene", model))
    jconfig.save_config(str(root / "jcfg"), *[jconfig.extract_config(args, c) for c in (
        jconfig.ModelConfig, jconfig.PipelineConfig, jconfig.OptimizationConfig)])
    assert (model / "cfg_args.json").read_text() == (root / "jcfg" / "cfg_args.json").read_text()

    # checkpoint: the JAX package's keys and shapes
    ckpt = str(model / f"chkpnt{IT}.npz")
    jstate, it = jrv.load_state_from_checkpoint(ckpt)
    assert it == IT and int(jstate.num_alive) == int(state.model.num_alive)
    jckpt.save_checkpoint(str(root / "j.npz"), jinit(jstate), IT)
    with np.load(ckpt) as t, np.load(str(root / "j.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        assert json.loads(str(t["__meta__"])) == json.loads(str(j["__meta__"]))

    # PLY: the JAX package's layout
    jply.save_gaussian_ply(jstate, str(root / "j.ply"))
    ply = str(model / "point_cloud" / f"iteration_{IT}" / "point_cloud.ply")
    assert list(read_ply(ply)) == list(read_ply(str(root / "j.ply")))
    assert len(read_ply(ply)["x"]) == int(state.model.num_alive)


def test_render_and_export_read_both_packages_artifacts(chain):
    root, _, state = chain
    model = root / "model"
    out = root / "renders"
    path = gen_render_path.main(["--output_folder", str(out), "--elevation", "45",
                                 "--radius", "300", "--num_frame", "3", "--fov", "60",
                                 "--height", "48", "--width", "48"])
    jpath_cli.main(["--output_folder", str(root / "jpaths"), "--elevation", "45",
                    "--radius", "300", "--num_frame", "3", "--fov", "60",
                    "--height", "48", "--width", "48"])
    assert open(path).read() == open(root / "jpaths" / os.path.basename(path)).read()
    assert len(json.load(open(path))["camera_path"]) == 3

    # the port's checkpoint, and the same state saved by the JAX package
    jstate, _ = jrv.load_state_from_checkpoint(str(model / f"chkpnt{IT}.npz"))
    jckpt.save_checkpoint(str(root / "jax.npz"), jinit(jstate), IT)
    for name, ckpt in (("port", model / f"chkpnt{IT}.npz"), ("jax", root / "jax.npz")):
        frames, fps = render_video.main(["--checkpoint", str(ckpt), "--camera_path", path,
                                         "--out", str(out / f"{name}.mp4"), "--device", "cpu"])
        assert len(frames) == 3 and fps > 0 and (out / f"{name}.mp4").stat().st_size > 0
        assert max(float(f.max()) for f in frames) > 0.05
        create_fused_ply.main(["-c", str(ckpt), "-o", str(out / f"{name}.ply"),
                               "--device", "cpu"])
        create_fused_ply.main(["-c", str(ckpt), "-o", str(out / f"{name}.splat"),
                               "--device", "cpu"])
        n = int(state.model.num_alive)
        assert len(read_ply(str(out / f"{name}.ply"))["x"]) == n
        assert "filter_3D" not in read_ply(str(out / f"{name}.ply"))
        assert len(load_splat(str(out / f"{name}.splat"))["xyz"]) == n
    assert (out / "port.ply").read_bytes() == (out / "jax.ply").read_bytes()
    assert (out / "port.splat").read_bytes() == (out / "jax.splat").read_bytes()

    # standalone PLYs: the fused one (filter recomputed from the path) in
    # depth mode under an entry budget, the snapshot with the scale histogram
    frames, _ = render_video.main(["--ply", str(out / "port.ply"), "--camera_path", path,
                                   "--out", str(out / "fused_depth.mp4"), "--mode", "depth",
                                   "--entry_budget", "3000", "--device", "cpu"])
    assert len(frames) == 3 and (out / "fused_depth.mp4").stat().st_size > 0
    snap = model / "point_cloud" / f"iteration_{IT}" / "point_cloud.ply"
    render_video.main(["--ply", str(snap), "--camera_path", path, "--out",
                       str(out / "snap.mp4"), "--scale_histogram", "--device", "cpu"])
    assert (out / "snap.mp4").stat().st_size > 0


def test_write_satellite_scene_matches_the_jax_script(tmp_path):
    """``io.synthetic.write_satellite_scene`` against
    ``scripts/make_synthetic_satellite.py`` (same size, points, views,
    seed): the same files, cameras to 1e-5, the init cloud to 1e-4, images
    within one 8-bit level, masks equal, depths to 1e-4 relative where the
    mask is set."""
    from skyfall_gs_tpu_torch.io.colmap import read_points3d_text
    from skyfall_gs_tpu_torch.io.png import read_png
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene

    _write_scene(tmp_path / "j")
    n = write_satellite_scene(str(tmp_path / "t"), size=48, n_points=1200, n_views=6, seed=0)
    assert n == 400
    names = sorted(p.relative_to(tmp_path / "j").as_posix() for p in (tmp_path / "j").rglob("*"))
    assert names == sorted(p.relative_to(tmp_path / "t").as_posix()
                           for p in (tmp_path / "t").rglob("*"))
    for split in ("train", "test"):
        t, j = (json.loads((tmp_path / d / f"transforms_{split}.json").read_text())
                for d in ("t", "j"))
        assert t["R"] == j["R"] and t["T"] == j["T"] and len(t["frames"]) == len(j["frames"])
        for a, b in zip(t["frames"], j["frames"]):
            assert a["file_path"] == b["file_path"]
            for k in ("transform_matrix_rotated", "fl_x", "fl_y", "cx", "cy"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
    (xt, ct, _), (xj, cj, _) = (read_points3d_text(str(tmp_path / d / "points3D.txt"))
                                for d in ("t", "j"))
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ct, cj)
    for i in range(6):
        name = f"img_{i:03d}"
        it, ij = (read_png(str(tmp_path / d / f"{name}.png")).astype(int) for d in ("t", "j"))
        assert np.abs(it - ij).max() <= 1
        mt, mj = (np.load(tmp_path / d / "masks" / f"{name}.npy") for d in ("t", "j"))
        dt, dj = (np.load(tmp_path / d / "depths_moge" / f"{name}.npy") for d in ("t", "j"))
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_allclose(dt[mt > 0], dj[mt > 0], rtol=1e-4)
        assert mt.sum() > 0.2 * mt.size


@pytest.mark.parametrize("color_mapped", [False, True], ids=["plain", "color_mapped"])
def test_create_fused_ply_on_its_device_writes_the_same_bytes(chain, tmp_path, color_mapped):
    """The checkpoint loads on --device (here the CPU); the files equal those
    of the export run on a state loaded on the CPU, as the tool did before
    it took --device.  ``--color_mapped`` bakes a random appearance MLP."""
    from skyfall_gs_tpu_torch.io.gaussian_ply import save_fused_ply, save_splat
    from skyfall_gs_tpu_torch.model.appearance import AppearanceConfig
    from skyfall_gs_tpu_torch.model.gaussians import create_from_points
    from skyfall_gs_tpu_torch.train.checkpoint import save_checkpoint
    from skyfall_gs_tpu_torch.train.step import init_train_state

    ckpt = str(chain[0] / "model" / f"chkpnt{IT}.npz")
    flags = []
    if color_mapped:
        rng = np.random.default_rng(3)
        ckpt, flags = str(tmp_path / "app.npz"), ["--color_mapped"]
        save_checkpoint(ckpt, init_train_state(create_from_points(
            rng.normal(size=(200, 3)).astype(np.float32),
            rng.uniform(size=(200, 3)).astype(np.float32), num_cameras=8,
            appearance=AppearanceConfig(True, 2, 8), seed=3)), 1)
    state, _ = render_video.load_state_from_checkpoint(ckpt)
    assert state.appearance.enabled == color_mapped
    save_fused_ply(state, str(tmp_path / "ref.ply"), color_mapped=color_mapped)
    save_splat(state, str(tmp_path / "ref.splat"))
    for ext in ("ply", "splat"):
        create_fused_ply.main(["-c", ckpt, "-o", str(tmp_path / f"out.{ext}"),
                               "--device", "cpu"] + flags)
        assert (tmp_path / f"out.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()


def test_ges_path_matches_jax(tmp_path):
    argv = ["--elevation", "0", "--radius", "250", "--ges", "--alt_tar", "20",
            "--alt_cam", "400", "--num_frame", "4", "--width", "64", "--height", "32"]
    p = gen_render_path.main(["--output_folder", str(tmp_path / "t")] + argv)
    jpath_cli.main(["--output_folder", str(tmp_path / "j")] + argv)
    assert open(p).read() == open(tmp_path / "j" / os.path.basename(p)).read()
    with pytest.raises(SystemExit):
        gen_render_path.main(["--output_folder", str(tmp_path), "--ges"])


@pytest.mark.parametrize("flags, where", [
    (["--gui_port"], None),
    (["--data_parallel", "2"], None),
    (["--shard_gaussians", "-1"], "ROADMAP: left out of the port"),
    ([], "partial multi-host"),          # with half a multi-host environment
], ids=["gui_port", "data_parallel", "shard_gaussians", "multi_host"])
def test_unported_options_raise(chain, tmp_path, monkeypatch, flags, where):
    if flags == ["--gui_port"]:
        # Ported: --gui_port opens a listening viewer bridge that serves
        # one frame per iteration.
        from skyfall_gs_tpu_torch.viz import network_gui
        from tests.test_torch_viewer import Viewer, connect, identity_request

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        viewer = Viewer(port, [identity_request()] * 2)

        class ConnectedGUI(network_gui.NetworkGUI):
            def __init__(self, host, port):
                super().__init__(host, port)
                connect(self)

        monkeypatch.setattr(network_gui, "NetworkGUI", ConnectedGUI)
        trainer, state = train_cli.main(["-s", str(chain[0] / "scene"), "-m",
                                         str(tmp_path / "m"), "--iterations", "2",
                                         "--gui_port", str(port), "--device", "cpu",
                                         "--quiet"])
        viewer.join()
        assert isinstance(trainer.gui, ConnectedGUI) and state.step == 2
        assert [len(f) for f in viewer.frames] == [8 * 8 * 3] * 2
        assert viewer.verify == [str(chain[0] / "scene")] * 2
        return
    if flags == ["--data_parallel", "2"]:
        # Ported: two gloo ranks train view-parallel; rank 0 writes.
        out = train_cli.main(["-s", str(chain[0] / "scene"), "-m", str(tmp_path / "m"),
                              "--iterations", "2", "--checkpoint_iterations", "2",
                              "--device", "cpu", "--quiet"] + flags)
        assert out is None
        assert (tmp_path / "m" / "chkpnt2.npz").is_file()
        assert (tmp_path / "m" / "cfg_args.json").is_file()
        return
    if not flags:
        # Ported: a pod needs all of SKYFALL_COORDINATOR / _NUM_PROCESSES /
        # _PROCESS_ID; half a configuration raises before anything is written.
        for v in ("SKYFALL_COORDINATOR", "SKYFALL_PROCESS_ID"):
            monkeypatch.delenv(v, raising=False)
        monkeypatch.setenv("SKYFALL_NUM_PROCESSES", "2")
        with pytest.raises(RuntimeError, match=where):
            train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--device", "cpu"])
        assert not (tmp_path / "m").exists()
        return
    with pytest.raises(NotImplementedError, match=f"not ported \\({where}\\)"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--device", "cpu"]
                       + flags)
    assert not (tmp_path / "m").exists()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--device", "cpu",
                        "--data_parallel", "2"] + flags)


def test_device_and_required_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_video.main(["--ply", "x.ply", "--camera_path", "p.json", "--out", "o.mp4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_fused_ply.main(["-c", "x.npz", "-o", "o.ply"])
    with pytest.raises(SystemExit):
        train_cli.main(["-m", str(tmp_path / "m"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        render_video.main(["--camera_path", "p.json", "--out", "o.mp4", "--device", "cpu"])
    assert train_cli.resolve_device("cpu") == torch.device("cpu")
