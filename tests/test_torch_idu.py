"""Port parity: the Stage-2 IDU orchestrator (train/idu.py) and the
command line's Stage-2 switches.

Tolerances, and why:
  * host draws (view picks, the IDU / original coin, IDU pool pops, orbit
    uids and shuffles, pseudo stacks) come from the same
    ``random.Random(rng_seed)`` stream in both packages, so they are held
    EXACTLY, and so is the stream's final state;
  * orbit cameras 1e-6 (float32 matrices from the same float64 poses);
    orbit renders and depths 1e-4 (two rasterizers of the same splats); the
    PNG files decode to within one 8-bit level (a pixel within 1e-4 of a
    rounding boundary may land on either side);
  * no loss trajectory is compared across an IDU episode: the packages'
    ray-jitter / split streams differ (and densify splits at iteration 4),
    so only draws, layouts and checkpoints are held.
"""

import os

import numpy as np
import pytest
import torch

from skyfall_gs_tpu.priors import IdentityRefiner as JIdentity
from skyfall_gs_tpu.priors import RenderDepthPredictor as JRenderDepth
from skyfall_gs_tpu.train import checkpoint as jckpt
from skyfall_gs_tpu.train import idu as jidu
from skyfall_gs_tpu.train import loop as jloop
from skyfall_gs_tpu.train.idu import IDUOrchestrator as JOrch
from skyfall_gs_tpu_torch.cli import train as train_cli
from skyfall_gs_tpu_torch.io.png import read_png
from skyfall_gs_tpu_torch.priors import IdentityRefiner, RenderDepthPredictor
from skyfall_gs_tpu_torch.train import loop as tloop
from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator
from tests.test_cli_pipeline import _write_scene
from tests.test_torch_pseudo import scenes, small_orbits, trainers  # noqa: F401

torch.set_num_threads(1)


# ----------------------------------------------------------------------------
# Stage 2: the IDU orchestrator
# ----------------------------------------------------------------------------

IDU = dict(idu_render_size=32, idu_num_cams=2, idu_num_samples_per_view=2,
           idu_episode_iterations=10, idu_densify_until_iter=6, densify_from_iter=2,
           densification_interval=4, idu_opacity_reset_interval=10 ** 9,
           idu_testing_interval=10 ** 9, idu_train_ratio=0.5, idu_refine=False,
           sample_pseudo_interval=4)
TARGETS = [[0.0, 0.0, 0.0], [0.4, -0.3, 0.0]]


@pytest.mark.parametrize("elevation, radius, tag, random_ap", [
    (60.0, 3.5, "e60.0_r3.5", False),
    ([70.0, 50.0], [3.0, 3.5], "e_mixed", True),
], ids=["curriculum", "mixed"])
def test_idu_views_match_jax(scenes, tmp_path, elevation, radius, tag, random_ap):
    jtr, ttr, js, ts = trainers(scenes, tmp_path, **IDU, idu_random_ap=random_ap)
    jv = JOrch(jtr, JIdentity(), JRenderDepth()).generate_idu_views(
        js, TARGETS, elevation, radius, 60.0, tag)
    orch = IDUOrchestrator(ttr, IdentityRefiner(), RenderDepthPredictor())
    tv = orch.generate_idu_views(ts, TARGETS, elevation, radius, 60.0, tag)
    assert len(tv) == len(jv) == 8
    assert ttr.py_rng.getstate() == jtr.py_rng.getstate()
    for a, b in zip(tv, jv):
        assert a.camera.uid == int(b.camera.uid) and a.image_name == b.image_name == tag
        np.testing.assert_allclose(a.camera.full_proj.numpy(), np.asarray(b.camera.full_proj),
                                   atol=1e-6)
        np.testing.assert_allclose(a.image, b.image, atol=1e-4)
        np.testing.assert_allclose(a.depth, b.depth, atol=1e-4)
    assert orch.max_overflow == 0 and orch.episodes[0]["alpha_coverage"] > 0.1
    jdir, tdir = tmp_path / "j" / "idu" / tag, tmp_path / "t" / "idu" / tag
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["render",
                                                                   "render_depth.npy"]
    names = sorted(os.listdir(jdir / "render"))
    assert sorted(os.listdir(tdir / "render")) == names and len(names) == len(tv)
    for n in names:
        d = read_png(str(tdir / "render" / n)).astype(int) - read_png(
            str(jdir / "render" / n)).astype(int)
        assert np.abs(d).max() <= 1
    np.testing.assert_allclose(np.load(tdir / "render_depth.npy"),
                               np.load(jdir / "render_depth.npy"), atol=1e-4)


def _record_steps(monkeypatch, module, log, key):
    """Record each training step's camera uid (IDU views have uids 1000+)."""
    make = module.make_train_step

    def recording(*a, **kw):
        fn = make(*a, **kw)

        def step(state, camera, *rest, **kws):
            log.append((key, int(camera.uid)))
            return fn(state, camera, *rest, **kws)
        return step
    monkeypatch.setattr(module, "make_train_step", recording)


def test_train_episode_draws_and_checkpoint_match_jax(scenes, tmp_path, monkeypatch):
    small_orbits(monkeypatch)
    jtr, ttr, js, ts = trainers(scenes, tmp_path, **IDU)
    jlog, tlog = [], []
    for module in (jloop, jidu):
        _record_steps(monkeypatch, module, jlog, "step")
    _record_steps(monkeypatch, tloop, tlog, "step")
    for tr, log in ((jtr, jlog), (ttr, tlog)):
        gen = tr._gen_pseudo_stack_at
        tr._gen_pseudo_stack_at = (lambda g, lg: lambda e, r: lg.append(
            ("stack", round(e, 6), round(r, 6))) or g(e, r))(gen, log)
    js = JOrch(jtr, JIdentity(), JRenderDepth()).train_episode(
        js, 0, TARGETS, 60.0, 3.5, 60.0)
    ts = IDUOrchestrator(ttr, IdentityRefiner(), RenderDepthPredictor()).train_episode(
        ts, 0, TARGETS, 60.0, 3.5, 60.0)
    assert tlog == jlog
    uids = [e[1] for e in tlog if e[0] == "step"]
    assert len(uids) == 10 and any(u >= 1000 for u in uids) and any(u < 1000 for u in uids)
    assert sum(e[0] == "stack" for e in tlog) == 1
    assert ttr.py_rng.getstate() == jtr.py_rng.getstate()
    assert ts.step == int(js.step) == 10 and int(ttr.max_overflow) == 0
    for name in ("chkpnt10.npz", "point_cloud/iteration_10/point_cloud.ply"):
        assert (tmp_path / "t" / name).is_file()
    theirs, ours = np.load(tmp_path / "j" / "chkpnt10.npz"), np.load(
        tmp_path / "t" / "chkpnt10.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k
    back, it = jckpt.load_checkpoint(str(tmp_path / "t" / "chkpnt10.npz"), js)
    assert it == 10 and int(back.step) == 10
    np.testing.assert_array_equal(np.asarray(back.model.params.xyz),
                                  ts.model.params.xyz.numpy())


def test_train_episode_takes_the_lpips_step(scenes, tmp_path, monkeypatch):
    """With ``use_lpips_loss`` every step of an episode (refined IDU views
    and original views alike) is built with the Trainer's LPIPS scorer, as
    the JAX package's episodes are (random alex weights, published widths)."""
    from skyfall_gs_tpu_torch.eval.lpips import LPIPS
    from tests.test_torch_eval import lpips_state

    small_orbits(monkeypatch)
    _, ttr, _, ts = trainers(scenes, tmp_path, **{**IDU, "idu_refine": True},
                             use_lpips_loss=True)
    ttr._lpips = LPIPS("alex", *lpips_state("alex", seed=6), device="cpu")
    built, losses = [], []
    make = tloop.make_train_step

    def recording(*a, **kw):
        built.append(kw["lpips_fn"])
        fn = make(*a, **kw)

        def step(*args, **kws):
            state, metrics = fn(*args, **kws)
            losses.append(float(metrics.loss))
            return state, metrics
        return step

    monkeypatch.setattr(tloop, "make_train_step", recording)
    ts = IDUOrchestrator(ttr, IdentityRefiner(), RenderDepthPredictor()).train_episode(
        ts, 0, TARGETS, 60.0, 3.5, 60.0)
    assert ts.step == 10 and len(losses) == 10 and np.isfinite(losses).all()
    assert len(built) >= 2 and all(fn == ttr._lpips.score for fn in built)
    assert int(ttr.max_overflow) == 0


# ----------------------------------------------------------------------------
# The command line
# ----------------------------------------------------------------------------

STAGE1 = ["--iterations", "8", "--densify_from_iter", "10000", "--lambda_pseudo_depth",
          "0.5", "--sample_pseudo_interval", "4", "--start_sample_pseudo", "2",
          "--num_pseudo_cams", "8", "--checkpoint_iterations", "8", "--test_iterations",
          "8", "--save_iterations", "8", "--quiet", "--device", "cpu"]
STAGE2 = ["--iterative_datasets_update", "--idu_episodes", "1", "--idu_episode_iterations",
          "6", "--idu_densify_until_iter", "0", "--idu_render_size", "32", "--idu_num_cams",
          "2", "--idu_num_samples_per_view", "1", "--idu_grid_size", "1",
          "--idu_testing_interval", "6", "--quiet", "--device", "cpu"]


@pytest.fixture(scope="module")
def satellite(tmp_path_factory):
    root = tmp_path_factory.mktemp("sat")
    _write_scene(root / "scene")
    return root


def test_cli_stage1_pseudo_then_iterative_datasets_update(satellite, monkeypatch):
    small_orbits(monkeypatch, size=48, radius=None)
    scene, model = satellite / "scene", satellite / "model"
    trainer, state = train_cli.main(["-s", str(scene), "-m", str(model)] + STAGE1)
    assert state.step == 8 and isinstance(trainer.depth_predictor, RenderDepthPredictor)
    orch, state = train_cli.main(["-s", str(scene), "-m", str(model), "--start_checkpoint",
                                  str(model / "chkpnt8.npz")] + STAGE2)
    assert isinstance(orch, IDUOrchestrator) and state.step == 14
    assert isinstance(orch.refiner, IdentityRefiner) and orch.max_overflow == 0
    tag = model / "idu" / "e85.0_r300.0"
    assert len(os.listdir(tag / "render")) == 2 and (tag / "render_depth.npy").is_file()
    assert (model / "chkpnt14.npz").is_file()
    assert (model / "point_cloud" / "iteration_14" / "point_cloud.ply").is_file()


@pytest.mark.parametrize("flags, error, match", [
    (["--iterative_datasets_update"], SystemExit, None),
    (["--iterative_datasets_update", "--start_checkpoint", "CKPT", "--refiner", "flowedit"],
     RuntimeError, "velocity_fn"),
    (["--iterative_datasets_update", "--start_checkpoint", "CKPT", "--idu_use_flow_edit"],
     RuntimeError, "velocity_fn"),
    (["--iterative_datasets_update", "--start_checkpoint", "CKPT", "--depth_model", "moge"],
     RuntimeError, "weights"),
    (["--lambda_pseudo_depth", "0.5", "--depth_model", "moge"], RuntimeError, "weights"),
    (["--lambda_pseudo_depth", "0.5", "--depth_model", "midas"], KeyError, "unknown"),
], ids=["no-checkpoint", "flowedit", "use-flow-edit", "moge-idu", "moge-pseudo",
        "unknown"])
def test_cli_stage2_backends_without_weights_raise(satellite, tmp_path, flags, error, match):
    flags = [str(tmp_path / "none.npz") if f == "CKPT" else f for f in flags]
    with pytest.raises(error, match=match):
        train_cli.main(["-s", str(satellite / "scene"), "-m", str(tmp_path / "m"),
                        "--iterations", "1", "--device", "cpu", "--quiet"] + flags)
