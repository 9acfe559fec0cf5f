"""Port parity: the pseudo-view and photometric options of the training
step, and the Stage-1 pseudo-view supervision of the Trainer.

Tolerances, and why:
  * the step with ``use_pseudo`` / ``photometric`` (64 px, SH degree 3):
    loss 1e-4 relative, every gradient 1e-3 norm-relative (as
    tests/test_torch_step.py: two float32 renders, two rounding orders);
  * host draws (view picks, pseudo stacks and their pops) come from the
    same ``random.Random(rng_seed)`` stream in both packages, so they are
    held EXACTLY, and so is the stream's final state; pseudo cameras 1e-6;
  * the 12-iteration Stage-1 trajectory with pseudo views (32 px, no
    densify, no ray jitter): per-step losses 1e-4 relative, as
    tests/test_torch_trainer.py holds the plain trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu.core.camera import orbit_cameras as jorbit
from skyfall_gs_tpu.io import synthetic as jsyn
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.train import loop as jloop
from skyfall_gs_tpu.train import step as jstep
from skyfall_gs_tpu.train.loop import Trainer as JTrainer
from skyfall_gs_tpu_torch.core.camera import orbit_cameras as torbit
from skyfall_gs_tpu_torch.io import synthetic as tsyn
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.priors import RenderDepthPredictor
from skyfall_gs_tpu_torch.train import loop as tloop
from skyfall_gs_tpu_torch.train import step as tstep
from skyfall_gs_tpu_torch.train.loop import Trainer as TTrainer
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
SCENE = dict(n_views=5, size=32, n_points=200, n_test=1)
H = W = 64


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------------------
# The step: use_pseudo and photometric
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_scene():
    rng = np.random.default_rng(5)
    n, cap = 120, 128
    st = create_from_points(rng.normal(0, 0.8, (n, 3)).astype(np.float32),
                            rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)
    rest = np.zeros((cap, 15, 3), np.float32)
    rest[:n] = rng.normal(0, 0.1, (n, 15, 3))
    st = st.replace(active_sh_degree=3,
                    params=st.params.replace(features_rest=jnp.asarray(rest)),
                    aux=st.aux.replace(filter_3d=jnp.full(cap, 0.05)))
    mask = np.ones((H, W), np.float32)
    mask[:6] = 0.0
    view = (rng.uniform(0, 1, (H, W, 3)).astype(np.float32), mask,
            rng.uniform(1, 5, (H, W)).astype(np.float32))
    jcam, tcam = cameras(W, H)
    jpcam, tpcam = cameras(W, H, eye=(-1.5, 2.0, 2.2))
    pseudo_depth = rng.uniform(1, 5, (H, W)).astype(np.float32)
    return st, (jcam, tcam), (jpcam, tpcam), view, pseudo_depth


@pytest.mark.parametrize("use_pseudo", [False, True], ids=["plain", "pseudo"])
@pytest.mark.parametrize("photometric", [True, False], ids=["photo", "nophoto"])
def test_step_pseudo_and_photometric_match_jax(step_scene, use_pseudo, photometric):
    st, (jcam, tcam), (jpcam, tpcam), view, pdepth = step_scene
    cfg = OptimizationConfig(lambda_pseudo_depth=0.5)
    kw = dict(use_depth=True, use_pseudo=use_pseudo, photometric=photometric)
    jargs = (jpcam, jnp.asarray(pdepth), jnp.float32(0.6)) if use_pseudo else ()
    loss_j, aux_j, g_j, (gd_j, ga_j) = jax.jit(jstep._build_grads_fn(cfg, **kw))(
        st, jcam, *map(jnp.asarray, view), jnp.zeros(3), jax.random.PRNGKey(0), 0.01,
        *jargs)
    tkw = dict(pseudo_camera=tpcam, pseudo_gt_depth=_t(pdepth),
               pseudo_scale=0.6) if use_pseudo else {}
    loss, aux, g, (gd, ga) = tstep._build_grads_fn(cfg, **kw)(
        tg.state_from_numpy(jax_state_to_numpy(st)), tcam, *map(_t, view), torch.zeros(3),
        0.01, **tkw)
    assert abs(float(loss) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for k in ("l1", "depth_loss", "opacity_loss"):
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-4, atol=1e-7)
    assert (float(aux["l1"]) > 0) == photometric
    assert int(aux["overflow"]) == 0
    for k, v in tg.flat_fields(g):
        assert torch.isfinite(v).all()
        assert rel(v, getattr(g_j, k)) <= 1e-3, (k, rel(v, getattr(g_j, k)))
    assert rel(gd, gd_j) <= 1e-3 and rel(ga, ga_j) <= 1e-3


# ----------------------------------------------------------------------------
# Stage 1: pseudo-view supervision in the Trainer
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX city scene, and the port's holding the JAX ground truth."""
    path = tmp_path_factory.mktemp("city")
    jscene = jsyn.make_city_scene(str(path), **SCENE)
    tscene = tsyn.make_city_scene(str(path), **SCENE)
    for tv, jv in zip(tscene.train_views + tscene.test_views,
                      jscene.train_views + jscene.test_views):
        tv.image, tv.depth = jv.image, jv.depth
    tscene.build_groups()
    return jscene, tscene


def model_cfg(path):
    return ModelConfig(model_path=str(path))


def opt_cfg(**kw):
    base = dict(iterations=12, densify_from_iter=10 ** 9, densify_until_iter=0,
                opacity_reset_interval=10 ** 9, lambda_depth=0.1, lambda_opacity=0.01,
                position_lr_max_steps=12, lambda_pseudo_depth=0.5, sample_pseudo_interval=3,
                start_sample_pseudo=2, end_sample_pseudo=1000, num_pseudo_cams=16,
                target_std=0.5)
    base.update(kw)
    return OptimizationConfig(**base)


def trainers(scenes, tmp_path, seed=3, **opt):
    jscene, tscene = scenes
    jtr = JTrainer(model_cfg(tmp_path / "j"), opt_cfg(**opt), PipelineConfig(fuse_steps=1),
                   jscene, rng_seed=seed)
    ttr = TTrainer(model_cfg(tmp_path / "t"), opt_cfg(**opt), PipelineConfig(), tscene,
                   rng_seed=seed)
    js = jtr.init_state()
    ts = tstep.init_train_state(tg.state_from_numpy(jax_state_to_numpy(js.model)))
    ttr._refresh_filter(ts)
    return jtr, ttr, js, ts


def small_orbits(monkeypatch, size=32, radius=3.0):
    """The Trainers' pseudo-view orbit cameras at ``size`` px (and at
    ``radius`` unless it is None) in both packages, drawing from the stream
    exactly as the full-size ones do."""
    def wrap(fn):
        def orbit(target, ele, rad, **kw):
            kw.update(width=size, height=size)
            return fn(target, ele, rad if radius is None else radius, **kw)
        return orbit
    monkeypatch.setattr(jloop, "orbit_cameras", wrap(jorbit))
    monkeypatch.setattr(tloop, "orbit_cameras", wrap(torbit))


def test_stage1_pseudo_cameras_match_jax(scenes, tmp_path):
    jtr, ttr, _, _ = trainers(scenes, tmp_path)
    for it in (3, 400, 999):
        assert ttr._pseudo_curriculum(it) == jtr._pseudo_curriculum(it)
        jcams, tcams = jtr._gen_pseudo_stack(it), ttr._gen_pseudo_stack(it)
        assert len(tcams) == len(jcams) == 16
        for jc, tc in zip(jcams, tcams):
            assert tc.uid == int(jc.uid) and (tc.width, tc.height) == (512, 512)
            np.testing.assert_allclose(tc.full_proj.numpy(), np.asarray(jc.full_proj),
                                       atol=1e-6)
    assert ttr.py_rng.getstate() == jtr.py_rng.getstate()


def _record(trainer, log):
    pick, gen = trainer._pick_view, trainer._gen_pseudo_stack_at
    step = {"it": 0}

    def picked():
        g, i = pick()
        log.append(("view", g.names[i]))
        return g, i

    def stack(ele, rad):
        cams = gen(ele, rad)
        log.append(("stack", round(ele, 6), round(rad, 6), [int(c.uid) for c in cams]))
        return cams

    def depth(image):
        log.append(("pseudo", step["it"] + 1, image.shape))
        return image.mean(-1).astype(np.float32)

    def log_step(it, m, el):
        step["it"] = it
        log.append(("loss", it, float(m.loss)))

    trainer._pick_view, trainer._gen_pseudo_stack_at = picked, stack
    trainer.depth_predictor = depth
    trainer.logger.log_step = log_step


def test_stage1_pseudo_schedule_matches_jax(scenes, tmp_path, monkeypatch):
    """Which iterations draw a pseudo view, the views, stacks and pops all
    equal JAX's; the per-step losses agree to 1e-4 relative (the same
    trajectory as tests/test_torch_trainer.py, with the pseudo term)."""
    small_orbits(monkeypatch)
    jtr, ttr, js, ts = trainers(scenes, tmp_path)
    jlog, tlog = [], []
    _record(jtr, jlog)
    _record(ttr, tlog)
    js = jtr.train(js, iterations=12)
    ts = ttr.train(ts, iterations=12)
    strip = lambda log: [e for e in log if e[0] != "loss"]     # noqa: E731
    assert strip(tlog) == strip(jlog)
    assert [e[1] for e in tlog if e[0] == "pseudo"] == [3, 6, 9, 12]
    assert ttr.py_rng.getstate() == jtr.py_rng.getstate()
    jl = [e[2] for e in jlog if e[0] == "loss"]
    tl = [e[2] for e in tlog if e[0] == "loss"]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert ts.step == int(js.step) == 12 and int(ttr.max_overflow) == 0


def test_stage1_pseudo_supervision_path(scenes, tmp_path):
    """tests/test_train.py's test_stage1_pseudo_supervision_path on the port:
    the pseudo step runs with the render depth backend."""
    _, tscene = scenes
    tr = TTrainer(model_cfg(tmp_path), opt_cfg(iterations=9), PipelineConfig(), tscene,
                  depth_predictor=RenderDepthPredictor())
    tr._gen_pseudo_stack_at = lambda ele, rad: torbit(
        [0, 0, 0], ele, 3.0, num_cams=4, width=32, height=32, fov_deg=60.0, uids=[0] * 4)
    state = tr.train(tr.init_state(), iterations=9)
    assert state.step == 9 and int(tr.max_overflow) == 0
