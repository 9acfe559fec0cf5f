"""Port parity: the synthetic city scene, the Stage-1 Trainer, checkpoints
and PLY snapshots (train/loop.py, io/synthetic.py, train/checkpoint.py,
io/gaussian_ply.py).

Tolerances, and why:
  * city-scene ground truth: the same geometry rendered by two
    rasterizers; pixels agree to 1e-6 in the mean (measured 4e-8), and a
    pixel within an ulp of a compositing threshold (T >= 1e-4, alpha >=
    1/255) may flip, by at most 2e-2 (measured max 7e-7: none flipped);
  * the 40-iteration trajectory (64 px, appearance and depth on, an
    opacity reset and its cooldown, no densify pass): the views picked
    are identical; per-step losses agree to 1e-4 relative (measured
    1.3e-6) and the final parameters to 1e-3 of each field's range
    (measured 7e-5, rotation).  Each Adam step moves an element by about
    lr * sign(g), so an element whose gradient sits near zero can take a
    different sign in the two packages; over 40 steps that bounds the
    drift by a few lr, far below the field's range;
  * checkpoints and PLY files carry arrays, so those compare EXACTLY.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu.io import gaussian_ply as jply
from skyfall_gs_tpu.io import synthetic as jsyn
from skyfall_gs_tpu.train import checkpoint as jckpt
from skyfall_gs_tpu.train.loop import Trainer as JTrainer
from skyfall_gs_tpu_torch.io import gaussian_ply as tply
from skyfall_gs_tpu_torch.io import synthetic as tsyn
from skyfall_gs_tpu_torch.io.ply import read_ply
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity
from skyfall_gs_tpu_torch.train import checkpoint as tckpt
from skyfall_gs_tpu_torch.train import step as tstep
from skyfall_gs_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_core import jax_state_to_numpy

torch.set_num_threads(1)
SCENE = dict(n_views=6, size=64, n_points=300, n_test=1)
ITERS = 40


def model_cfg(path):
    return ModelConfig(model_path=str(path), appearance_enabled=True,
                       appearance_n_fourier_freqs=2, appearance_embedding_dim=8)


def opt_cfg(**kw):
    base = dict(iterations=ITERS, densify_from_iter=10 ** 9, densify_until_iter=30,
                opacity_reset_interval=20, opacity_cooldown_iterations=8,
                lambda_depth=0.1, lambda_opacity=0.05, position_lr_max_steps=ITERS)
    base.update(kw)
    return OptimizationConfig(**base)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX scene, and the port's scene holding the JAX ground truth (so
    trajectories start from identical data)."""
    path = tmp_path_factory.mktemp("city")
    jscene = jsyn.make_city_scene(str(path), **SCENE)
    tscene = tsyn.make_city_scene(str(path), **SCENE)
    own = [(v.image, v.depth) for v in tscene.train_views + tscene.test_views]
    for tv, jv in zip(tscene.train_views + tscene.test_views,
                      jscene.train_views + jscene.test_views):
        tv.image, tv.depth = jv.image, jv.depth
    tscene.build_groups()
    return jscene, tscene, own


def test_city_scene_matches_jax(scenes):
    jscene, tscene, own = scenes
    np.testing.assert_array_equal(tscene.points, jscene.points)
    np.testing.assert_array_equal(tscene.colors, jscene.colors)
    assert tscene.cameras_extent == jscene.cameras_extent
    assert [v.image_name for v in tscene.test_views] == ["v5"]
    jviews = jscene.train_views + jscene.test_views
    for (img, dep), jv, tv in zip(own, jviews, tscene.train_views + tscene.test_views):
        assert tv.camera.uid == int(jv.camera.uid)
        np.testing.assert_allclose(tv.camera.full_proj.numpy(), np.asarray(jv.camera.full_proj),
                                   atol=1e-6)
        err = np.abs(img - jv.image)
        assert err.max() <= 2e-2 and err.mean() <= 1e-6, (err.max(), err.mean())
        hit = jv.depth > 0
        derr = np.abs(dep - jv.depth)[hit] / jv.depth[hit]
        assert np.mean(derr) <= 1e-5, np.mean(derr)
    g = next(iter(tscene.train_groups.values()))
    assert g.size == 5 and tuple(g.images.shape) == (5, 64, 64, 3) and g.has_depth


def _record(trainer, picks, losses):
    pick = trainer._pick_view

    def recorded():
        g, i = pick()
        picks.append(g.names[i])
        return g, i

    trainer._pick_view = recorded
    trainer.logger.log_step = lambda it, m, el: losses.append(float(m.loss))


def test_trainer_trajectory_matches_jax(scenes, tmp_path):
    jscene, tscene, _ = scenes
    jtr = JTrainer(model_cfg(tmp_path / "j"), opt_cfg(), PipelineConfig(fuse_steps=1), jscene,
                   rng_seed=3)
    ttr = TTrainer(model_cfg(tmp_path / "t"), opt_cfg(), PipelineConfig(), tscene, rng_seed=3)
    js = jtr.init_state()
    ts = tstep.init_train_state(tg.state_from_numpy(jax_state_to_numpy(js.model)))
    jpicks, jloss, tpicks, tloss = [], [], [], []
    _record(jtr, jpicks, jloss)
    _record(ttr, tpicks, tloss)
    js = jtr.train(jax.tree.map(jnp.copy, js), iterations=ITERS)
    ts = ttr.train(ts, iterations=ITERS)

    assert tpicks == jpicks and len(set(tpicks)) > 1
    assert ts.step == int(js.step) == ITERS == ts.opt.count
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    # the opacity reset at 20 visibly raised the loss in both
    assert tloss[20] > 1.5 * tloss[18]
    ref = dict(tg.flat_fields(js.model.params))
    for k, v in tg.flat_fields(ts.model.params):
        r = np.asarray(ref[k])
        span = max(float(r.max() - r.min()), 1e-6)
        assert float(np.abs(v.numpy() - r).max()) <= 1e-3 * span, k
    np.testing.assert_allclose(ts.model.aux.filter_3d.numpy(),
                               np.asarray(js.model.aux.filter_3d), rtol=1e-6)


def test_densify_in_loop_grows_points_and_capacity(scenes, tmp_path):
    _, tscene, _ = scenes
    tr = TTrainer(model_cfg(tmp_path), opt_cfg(densify_from_iter=5, densification_interval=10,
                                               densify_grad_threshold=1e-7),
                  PipelineConfig(), tscene, rng_seed=1)
    state = tr.init_state()
    n0, cap0 = int(state.model.num_alive), state.model.params.capacity
    state = tr.train(state, iterations=25, test_iterations=(25,), save_iterations=(25,))
    assert int(state.model.num_alive) > n0 and state.model.params.capacity > cap0
    for _, v in tg.flat_fields(state.model.params):
        assert v.shape[0] != cap0 and torch.isfinite(v).all()
    assert state.opt.mu.embeddings.shape[0] == state.model.params.capacity
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    dens = [r for r in records if r["type"] == "densify"]
    assert [r["iter"] for r in dens] == [10, 20] and all(r["n_dropped"] == 0 for r in dens)
    assert any(r["type"] == "eval" and r["split"] == "test" for r in records)
    ply = tply.load_gaussian_ply(
        str(tmp_path / "point_cloud" / "iteration_25" / "point_cloud.ply"))
    assert len(ply["xyz"]) == int(state.model.num_alive) and ply["sh_degree"] == 3
    # The binning capacity covers every train view, not only the first.
    worst = max(measure_bin_capacity(state.model, [c], kernel_size=0.1)
                for g in tscene.train_groups.values() for c in g.cameras)
    assert tr.bin_capacity >= worst


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_packages_and_resume(scenes, tmp_path, direction):
    jscene, tscene, _ = scenes
    jtr = JTrainer(model_cfg(tmp_path / "j"), opt_cfg(), PipelineConfig(fuse_steps=1), jscene)
    ttr = TTrainer(model_cfg(tmp_path / "t"), opt_cfg(), PipelineConfig(), tscene)
    if direction == "jax_to_port":
        js = jtr.train(jtr.init_state(), iterations=3, checkpoint_iterations=(3,))
        src = jax_state_to_numpy(js.model)
        moments = (js.opt.mu, js.opt.nu)
        ts = ttr.init_state(start_checkpoint=str(tmp_path / "j" / "chkpnt3.npz"))
        assert ttr.start_iteration == 3 and ts.step == 3 and ts.opt.count == 3
        got = tg.state_to_numpy(ts.model)
        got_moments = [{k: v.numpy().copy() for k, v in tg.flat_fields(m)}
                       for m in (ts.opt.mu, ts.opt.nu)]
        out = ttr._eval_render(ts.model, tscene.test_views[0].camera, ttr.bg)
        ref = jtr._eval_render(js.model, jscene.test_views[0].camera, jtr.bg)
        np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color), atol=2e-2)
        assert float(np.abs(out.color.numpy() - np.asarray(ref.color)).mean()) <= 1e-4
        # resume continues the iteration count
        ts = ttr.train(ts, iterations=6)
        assert ts.step == 6 and ts.opt.count == 6
    else:
        ts = ttr.train(ttr.init_state(), iterations=3, checkpoint_iterations=(3,))
        src = tg.state_to_numpy(ts.model)
        moments = (ts.opt.mu, ts.opt.nu)
        template = jtr.init_state()
        loaded, it = jckpt.load_checkpoint(str(tmp_path / "t" / "chkpnt3.npz"), template)
        assert it == 3 and int(loaded.step) == 3 and int(loaded.opt.count) == 3
        got = jax_state_to_numpy(loaded.model)
        got_moments = [{k: np.asarray(v) for k, v in tg.flat_fields(m)}
                       for m in (loaded.opt.mu, loaded.opt.nu)]
    for k, v in src.items():
        if k == "filter_3d" and direction == "jax_to_port":
            continue          # recomputed on load; compared through the render
        if isinstance(v, np.ndarray) or isinstance(v, dict):
            jax.tree.map(np.testing.assert_array_equal, got[k], v)
    for part, ref in zip(got_moments, moments):
        want = dict(tg.flat_fields(ref))
        assert part.keys() == want.keys()
        for k, v in part.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert tckpt.peek_checkpoint_meta(str(tmp_path / ("j" if direction == "jax_to_port"
                                                     else "t") / "chkpnt3.npz"))[
        "appearance"] == [True, 2, 8, 128]


def test_ply_matches_jax(scenes, tmp_path):
    jscene, _, _ = scenes
    jtr = JTrainer(model_cfg(tmp_path), opt_cfg(), PipelineConfig(fuse_steps=1), jscene)
    js = jtr.init_state()
    rest = np.asarray(js.model.params.features_rest)
    rest = rest + np.random.default_rng(0).normal(0, 0.1, rest.shape).astype(np.float32)
    jmodel = js.model.replace(params=js.model.params.replace(features_rest=jnp.asarray(rest)))
    jply.save_gaussian_ply(jmodel, str(tmp_path / "j.ply"))
    tply.save_gaussian_ply(tg.state_from_numpy(jax_state_to_numpy(jmodel)),
                           str(tmp_path / "t.ply"))
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    got, ref = tply.load_gaussian_ply(str(tmp_path / "j.ply")), \
        jply.load_gaussian_ply(str(tmp_path / "j.ply"))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v)
    assert list(read_ply(str(tmp_path / "t.ply")))[:9] == [
        "x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]


def test_trainer_with_lpips_loss_matches_jax(scenes, tmp_path):
    """``use_lpips_loss`` with a preset ``_lpips`` scorer (random alex
    weights at the published widths) on both Trainers: the same picks and
    losses (1e-4 relative) for 12 iterations."""
    from skyfall_gs_tpu.eval.lpips import LPIPS as JLPIPS
    from skyfall_gs_tpu_torch.eval.lpips import LPIPS as TLPIPS
    from tests.test_torch_eval import lpips_state

    jscene, tscene, _ = scenes
    backbone, lin = lpips_state("alex", seed=3)
    opt = opt_cfg(use_lpips_loss=True, lambda_dssim=0.3)
    jtr = JTrainer(model_cfg(tmp_path / "j"), opt, PipelineConfig(fuse_steps=1), jscene,
                   rng_seed=5)
    ttr = TTrainer(model_cfg(tmp_path / "t"), opt, PipelineConfig(), tscene, rng_seed=5)
    jtr._lpips = JLPIPS("alex", backbone, lin)
    ttr._lpips = TLPIPS("alex", backbone, lin, device="cpu")
    js = jtr.init_state()
    ts = tstep.init_train_state(tg.state_from_numpy(jax_state_to_numpy(js.model)))
    jpicks, jloss, tpicks, tloss = [], [], [], []
    _record(jtr, jpicks, jloss)
    _record(ttr, tpicks, tloss)
    jtr.train(js, iterations=12)
    ts = ttr.train(ts, iterations=12)
    assert tpicks == jpicks and len(tloss) == 12
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    assert {k[-1] for k in ttr._step_fns} == {ttr._lpips.score}


@pytest.mark.parametrize("case", ["mesh", "gui", "lpips", "orbax"])
def test_unported_options_raise(scenes, tmp_path, case):
    _, tscene, _ = scenes
    kw, opt = {}, {}
    if case == "mesh":
        # Ported: a 1-rank gloo mesh trains view-parallel and gaussian-sharded;
        # another mode raises.
        import torch.distributed as dist
        from skyfall_gs_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(1, backend="gloo", device="cpu", rank=0,
                         init_method=f"file://{tmp_path / 'rendezvous'}")
        try:
            tr = TTrainer(model_cfg(tmp_path), opt_cfg(), PipelineConfig(), tscene, mesh=mesh)
            state = tr.train(tr.init_state(), iterations=2)
            tg_ = TTrainer(model_cfg(tmp_path), opt_cfg(), PipelineConfig(), tscene, mesh=mesh,
                           mesh_mode="gauss")
            gstate = tg_.train(tg_.init_state(), iterations=2)
            with pytest.raises(ValueError, match="'view' or 'gauss'"):
                TTrainer(model_cfg(tmp_path), opt_cfg(), PipelineConfig(), tscene, mesh=mesh,
                         mesh_mode="grid")
        finally:
            dist.destroy_process_group()
        assert state.step == 2 and tr._mesh_B == 1
        assert gstate.step == 2 and tg_._mesh_B == 0 and tg_._gauss is mesh
        for s in (state, gstate):
            for _, v in tg.flat_fields(s.model.params):
                assert torch.isfinite(v).all()
        return
    elif case == "gui":
        # Ported: the Trainer takes a listening NetworkGUI.
        from skyfall_gs_tpu_torch.viz.network_gui import NetworkGUI
        from tests.test_torch_viewer import Viewer, connect, port_of

        gui = NetworkGUI("127.0.0.1", 0)
        tr = TTrainer(model_cfg(tmp_path), opt_cfg(), PipelineConfig(), tscene, gui=gui)
        viewer = Viewer(port_of(gui), [], replies=False)
        connect(tr.gui)
        viewer.join()
        gui.drop()
        return
    elif case == "lpips":
        # Ported: the step's scorer comes from local LPIPS weights, and
        # without them lpips_from_local_packages raises.
        tr = TTrainer(model_cfg(tmp_path), opt_cfg(use_lpips_loss=True), PipelineConfig(),
                      tscene)
        with pytest.raises(RuntimeError, match="unavailable locally"):
            tr._get_step_fn(use_depth=True)
        return
    # Ported: a sharded .orbax checkpoint (here written whole) resumes; a
    # path that holds none raises.
    from skyfall_gs_tpu_torch.train.checkpoint_sharded import save_checkpoint_sharded

    tr = TTrainer(model_cfg(tmp_path), opt_cfg(**opt), PipelineConfig(), tscene, **kw)
    state = tr.train(tr.init_state(), iterations=2)
    save_checkpoint_sharded(str(tmp_path / "chkpnt2.orbax"), state, 2)
    tr2 = TTrainer(model_cfg(tmp_path), opt_cfg(**opt), PipelineConfig(), tscene, **kw)
    resumed = tr2.init_state(start_checkpoint=str(tmp_path / "chkpnt2.orbax"))
    assert tr2.start_iteration == 2 and resumed.step == 2
    assert torch.equal(resumed.model.params.xyz, state.model.params.xyz)
    assert torch.equal(resumed.opt.nu.scaling, state.opt.nu.scaling)
    with pytest.raises(FileNotFoundError, match="no sharded checkpoint"):
        tr2.init_state(start_checkpoint=str(tmp_path / "ckpt.orbax"))


def test_metrics_logger_writes_the_jax_records(tmp_path):
    from skyfall_gs_tpu.train.logging import MetricsLogger as JLogger
    from skyfall_gs_tpu_torch.train.logging import MetricsLogger as TLogger
    from skyfall_gs_tpu_torch.train.step import StepMetrics

    logs = {}
    for name, cls, arr in (("j", JLogger, jnp.asarray), ("t", TLogger, torch.tensor)):
        lg = cls(str(tmp_path / name), log_every=2, flush_every=4)
        for it in range(1, 7):
            lg.log_step(it, StepMetrics(*[arr(float(it * k)) for k in range(6)],
                                        overflow=arr(0)), 0.5 * it)
        lg.log_densify(6, tdensify_stats(arr))
        lg.log_eval(6, "test", 0.1, 20.0)
        lg.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            logs[name] = [json.loads(line) for line in f]
    for r in logs["j"] + logs["t"]:
        r.pop("iters_per_sec", None)
    assert logs["t"] == logs["j"] and [r["iter"] for r in logs["t"]] == [2, 4, 6, 6, 6]


def tdensify_stats(arr):
    from skyfall_gs_tpu_torch.model.densify import DensifyStats

    return DensifyStats(*[arr(k) for k in (3, 4, 5, 0, 100)])
