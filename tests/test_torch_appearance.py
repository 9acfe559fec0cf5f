"""Port parity: appearance modeling (model/appearance.py), the appearance
colour path of model/render.py and an appearance-enabled training step.

Inputs are numpy arrays from a seed; MLP weights and embeddings are the
JAX package's own initialization, carried across with state_from_numpy.
Tolerances:
  * Fourier features, the toned SH and the colors: 1e-6 norm-relative
    (the same float32 formulas; only the matmul summation order differs);
  * one step: loss 1e-4 relative, every gradient (appearance MLP and
    embeddings included) 1e-3 norm-relative, as for the plain step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import OptimizationConfig
from skyfall_gs_tpu.model import appearance as jap
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.model.render import compute_colors as jcompute_colors
from skyfall_gs_tpu.train import step as jstep
from skyfall_gs_tpu_torch.model import appearance as tap
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model import render as trender
from skyfall_gs_tpu_torch.train import step as tstep
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
H = W = 32
CFG = jap.AppearanceConfig(enabled=True, n_fourier_freqs=2, embedding_dim=8, hidden=32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert np.isfinite(a).all()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fourier_features_and_apply_appearance(rng):
    xyz = rng.normal(0, 2, (50, 3)).astype(np.float32)
    feat = tap.fourier_position_features(xyz, 3)
    assert feat.shape == (50, 18)
    assert rel(feat, jap.fourier_position_features(xyz, 3)) <= 1e-6

    mlp, cams = jap.init_appearance(jax.random.PRNGKey(1), CFG, 4)
    features = rng.normal(0, 0.8, (50, 16, 3)).astype(np.float32)   # some > 1: clamped
    emb = rng.normal(0, 1, (50, CFG.gaussian_embedding_dim)).astype(np.float32)
    ref = jap.apply_appearance(mlp, jnp.asarray(emb), cams[2], jnp.asarray(features))
    port = tap.apply_appearance(jax.tree.map(_t, mlp), _t(emb), _t(cams[2]), _t(features))
    assert port.shape == (50, 16, 3)
    assert rel(port, ref) <= 1e-6
    assert float(port.max()) <= 1.0

    # The port's own init: the JAX shapes and bounds, from a torch generator.
    tmlp, tcams = tap.init_appearance(torch.Generator().manual_seed(0), CFG, 4)
    for k in mlp:
        for kk in ("w", "b"):
            assert tuple(tmlp[k][kk].shape) == mlp[k][kk].shape
            bound = 1.0 / np.sqrt(mlp[k]["w"].shape[0])
            assert float(tmlp[k][kk].abs().max()) <= bound
    assert tuple(tcams.shape) == cams.shape


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    n, cap = 60, 96
    st = create_from_points(rng.normal(0, 0.8, (n, 3)).astype(np.float32),
                            rng.uniform(0, 1, (n, 3)).astype(np.float32),
                            appearance=CFG, num_cameras=4, capacity=cap, seed=5)
    rest = np.zeros((cap, 15, 3), np.float32)
    rest[:n] = rng.normal(0, 0.1, (n, 15, 3))
    st = st.replace(active_sh_degree=3,
                    params=st.params.replace(features_rest=jnp.asarray(rest)),
                    aux=st.aux.replace(filter_3d=jnp.full(cap, 0.05)))
    mask = np.ones((H, W), np.float32)
    mask[:3] = 0.0
    view = (rng.uniform(0, 1, (H, W, 3)).astype(np.float32), mask,
            rng.uniform(1, 5, (H, W)).astype(np.float32))
    return st, view


def _cams(uid):
    jcam, tcam = cameras(W, H)
    tcam.uid = uid
    return jcam.replace(uid=jnp.int32(uid)), tcam


@pytest.mark.parametrize("uid,testing", [(1, False), (9, False), (-2, False), (1, True)])
def test_compute_colors_camera_embedding_rules(scene, uid, testing):
    """Training: the camera's embedding clip(uid, 0, M-1); testing: the
    fixed min(6, M-1); an explicit embedding wins over both."""
    st, _ = scene
    jcam, tcam = _cams(uid)
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    ref = jcompute_colors(st, jcam, testing=testing)
    got = trender.compute_colors(port, tcam, testing=testing)
    assert rel(got, ref) <= 1e-6
    table = port.params.appearance_embeddings
    row = 3 if testing else min(max(uid, 0), 3)
    np.testing.assert_array_equal(
        got.numpy(), trender.compute_colors(port, tcam, appearance_embedding=table[row]).numpy())
    other = trender.compute_colors(port, tcam, testing=testing,
                                   appearance_embedding=table[(row + 1) % 4])
    assert float((other - got).abs().max()) > 0


@pytest.mark.parametrize("testing_render", [False, True])
def test_appearance_step_matches_jax(scene, testing_render):
    st, view = scene
    cfg = OptimizationConfig()
    jcam, tcam = _cams(2)
    kw = dict(use_depth=True, testing_render=testing_render)
    loss_j, aux_j, g_j, (gd_j, ga_j) = jax.jit(jstep._build_grads_fn(cfg, **kw))(
        st, jcam, *map(jnp.asarray, view), jnp.zeros(3), jax.random.PRNGKey(0), 0.01)
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    loss, aux, g, (gd, ga) = tstep._build_grads_fn(cfg, **kw)(
        port, tcam, *map(_t, view), torch.zeros(3), 0.01)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    paths = [k for k, _ in tg.flat_fields(g)]
    assert "appearance_mlp/l0/w" in paths and "appearance_embeddings" in paths
    jflat = dict(tg.flat_fields(g_j))
    for k, v in tg.flat_fields(g):
        assert rel(v, jflat[k]) <= 1e-3, k
    assert rel(gd, gd_j) <= 1e-3 and rel(ga, ga_j) <= 1e-3
    # Only the embedding the render used gets a gradient.
    used = 3 if testing_render else 2
    rows = g.appearance_embeddings.abs().sum(1)
    assert float(rows[used]) > 0 and float(rows.sum() - rows[used]) == 0.0

    # A full step moves every appearance leaf with its own LR group.
    ts = tstep.init_train_state(port)
    before = {k: v.clone() for k, v in tg.flat_fields(ts.model.params)}
    ts, m = tstep.make_train_step(cfg, **kw)(ts, tcam, *map(_t, view), torch.zeros(3),
                                             1.6e-4, 0.01)
    np.testing.assert_allclose(float(m.loss), float(loss_j), rtol=1e-4)
    lr = dict(tg.flat_fields(tstep.make_lr_tree(ts.model.params, cfg, 1.6e-4)))
    assert lr["appearance_mlp/l2/w"] == cfg.appearance_mlp_lr
    assert lr["embeddings"] == cfg.embedding_lr
    for k, v in tg.flat_fields(ts.model.params):
        step = (v - before[k]).abs().max()
        assert float(step) <= 1.0001 * lr[k], k        # Adam's first step: lr * sign(g)
        if k.startswith("appearance"):
            assert float(step) > 0, k


def test_eval_render_uses_the_test_embedding(scene):
    st, _ = scene
    jcam, tcam = _cams(0)
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    out = tstep.make_eval_render()(port, tcam, torch.zeros(3))
    ref = jstep.make_eval_render()(st, jcam, jnp.zeros(3))
    np.testing.assert_allclose(out.color.numpy(), np.asarray(ref.color), atol=1e-5)
    test_view = trender.render(port, tcam, torch.zeros(3), testing=True)
    np.testing.assert_array_equal(out.color.numpy(), test_view.color.detach().numpy())
    train_view = trender.render(port, tcam, torch.zeros(3))
    assert float((train_view.color.detach() - out.color).abs().max()) > 0
