"""Port parity: core math, cameras, 3-NN, Gaussian state and config.

Each case feeds the same numpy inputs to the JAX package and to its
PyTorch port (skyfall_gs_tpu_torch) and compares on the CPU.  Tolerance:
1e-6 absolute for the float32 math (both sides round the same formulas in
float32; only summation order differs).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu import config as jconfig
from skyfall_gs_tpu.core import camera as jcam
from skyfall_gs_tpu.core import sh as jsh
from skyfall_gs_tpu.core import transforms as jtf
from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.ops.knn import mean_sq_dist_3nn_host as jknn
from skyfall_gs_tpu_torch import config as tconfig
from skyfall_gs_tpu_torch.core import camera as tcam
from skyfall_gs_tpu_torch.core import sh as tsh
from skyfall_gs_tpu_torch.core import transforms as ttf
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.ops.knn import mean_sq_dist_3nn_host as tknn

torch.set_num_threads(1)
ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=ATOL, rtol=0.0):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def jax_state_to_numpy(state) -> dict:
    """A JAX GaussianModelState as the port's state_from_numpy input."""
    d = {}
    for part in (state.params, state.aux):
        for f in dataclasses.fields(part):
            v = getattr(part, f.name)
            d[f.name] = None if v is None else jax.tree.map(np.asarray, v)
    d.update(active_sh_degree=state.active_sh_degree,
             max_sh_degree=state.max_sh_degree,
             spatial_lr_scale=state.spatial_lr_scale,
             appearance=tuple(state.appearance))
    return d


class TestTransforms:
    def test_rotation_and_covariance(self, rng):
        q = rng.normal(0, 1, (64, 4)).astype(np.float32) * 3.0   # unnormalized
        s = np.exp(rng.normal(-1.0, 0.5, (64, 3))).astype(np.float32)
        _close(ttf.quat_to_rotmat(_t(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
        _close(ttf.build_scaling_rotation(_t(s), _t(q)),
               jtf.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
        _close(ttf.covariance_from_scaling_rotation(_t(s), _t(q), 0.7),
               jtf.covariance_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q), 0.7))

    def test_view_and_projection_matrices(self, rng):
        R = jtf.quat_to_rotmat(jnp.asarray(rng.normal(0, 1, 4), jnp.float32))
        R = np.asarray(R, np.float64)
        t = rng.normal(0, 2, 3)
        _close(ttf.world_to_view(R, t), jtf.world_to_view(R, t))
        _close(ttf.world_to_view(R, t, translate=np.array([0.3, -1.0, 2.0]), scale=1.7),
               jtf.world_to_view(R, t, translate=np.array([0.3, -1.0, 2.0]), scale=1.7))
        _close(ttf.projection_matrix(0.01, 100.0, 1.1, 0.8, cx=0.12, cy=-0.3),
               jtf.projection_matrix(0.01, 100.0, 1.1, 0.8, cx=0.12, cy=-0.3))
        assert ttf.fov_to_focal(1.1, 640) == jtf.fov_to_focal(1.1, 640)
        assert ttf.focal_to_fov(500.0, 480) == jtf.focal_to_fov(500.0, 480)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches(rng, deg):
    dirs = rng.normal(0, 1, (50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    sh = (0.5 * rng.normal(0, 1, (50, 3, 16))).astype(np.float32)
    _close(tsh.sh_basis(deg, _t(dirs)), jsh.sh_basis(deg, jnp.asarray(dirs)))
    _close(tsh.eval_sh(deg, _t(sh), _t(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(_t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))


def _camera_close(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, (int, float)):
            assert a == b, f.name
        else:
            _close(a, b)


class TestCameras:
    def test_make_camera_with_principal_point(self, rng):
        c2w = jcam.look_at_c2w((3.0, -2.0, 1.5), (0.2, 0.1, 0.0))
        np.testing.assert_array_equal(tcam.look_at_c2w((3.0, -2.0, 1.5), (0.2, 0.1, 0.0)),
                                      c2w)
        kw = dict(cx=0.1, cy=-0.05, uid=7, znear=0.05, zfar=50.0)
        _camera_close(tcam.camera_from_c2w(c2w, 0.9, 0.7, 64, 48, **kw),
                      jcam.camera_from_c2w(c2w, 0.9, 0.7, 64, 48, **kw))

    def test_orbit_cameras(self):
        kw = dict(num_cams=3, num_samples=2, width=40, height=24, fov_deg=50.0)
        port = tcam.orbit_cameras([1.0, 0.5, 0.0], 35.0, 6.0, **kw)
        ref = jcam.orbit_cameras([1.0, 0.5, 0.0], 35.0, 6.0, **kw)
        assert len(port) == len(ref) == 6
        for p, r in zip(port, ref):
            _camera_close(p, r)


class TestGaussianState:
    def test_knn_matches(self, rng):
        pts = rng.normal(0, 1, (300, 3)).astype(np.float32)
        np.testing.assert_allclose(tknn(pts), jknn(pts), rtol=1e-5)

    def test_create_from_points_and_exchange(self, rng):
        pts = rng.normal(0, 1, (100, 3)).astype(np.float32)
        cols = rng.uniform(0, 1, (100, 3)).astype(np.float32)
        ref = jax_state_to_numpy(jg.create_from_points(pts, cols, capacity=160))
        port = tg.create_from_points(pts, cols, capacity=160)
        # Dead slots: opacity logit -10, identity quaternions, not alive.
        assert (port.params.opacity[100:] == -10.0).all()
        np.testing.assert_array_equal(port.params.rotation[100:].numpy(),
                                      np.tile([1.0, 0, 0, 0], (60, 1)))
        got = tg.state_to_numpy(port)
        for k, v in got.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == ref[k].dtype and v.shape == ref[k].shape, k
                _close(v, ref[k])
            else:
                assert v == ref[k], k
        # The exchange round-trips exactly.
        back = tg.state_to_numpy(tg.state_from_numpy(ref))
        for k, v in back.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, ref[k])

    def test_activations_and_bounded_filter_grads(self, rng):
        n = 40
        log_s = rng.normal(-3.0, 1.0, (n, 3)).astype(np.float32)
        log_s[:4] = np.float32([-10.0, -20.0, -30.0, -60.0])[:, None]  # underflow
        logit = rng.normal(0, 2, (n, 1)).astype(np.float32)
        filt = rng.uniform(0.0, 0.4, n).astype(np.float32)

        def params(mod, arr, s, o):
            return mod.GaussianParams(
                xyz=arr(np.zeros((n, 3), np.float32)),
                features_dc=arr(np.zeros((n, 1, 3), np.float32)),
                features_rest=arr(np.zeros((n, 0, 3), np.float32)),
                scaling=s, rotation=arr(np.tile(np.float32([1, 0, 0, 0]), (n, 1))),
                opacity=o)

        def jloss(s, o):
            return jnp.sum(jg.opacity_with_3d_filter(params(jg, jnp.asarray, s, o),
                                                     jnp.asarray(filt)))

        jp = params(jg, jnp.asarray, jnp.asarray(log_s), jnp.asarray(logit))
        ts, to = _t(log_s).requires_grad_(), _t(logit).requires_grad_()
        tp = params(tg, _t, ts, to)
        _close(tg.scaling_with_3d_filter(tp, _t(filt)),
               jg.scaling_with_3d_filter(jp, jnp.asarray(filt)), rtol=1e-6)
        op = tg.opacity_with_3d_filter(tp, _t(filt))
        _close(op, jg.opacity_with_3d_filter(jp, jnp.asarray(filt)), rtol=1e-6)
        op.sum().backward()
        gs, go = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(log_s), jnp.asarray(logit))
        assert torch.isfinite(ts.grad).all() and torch.isfinite(to.grad).all()
        _close(ts.grad, gs, atol=1e-6, rtol=1e-5)
        _close(to.grad, go, atol=1e-6, rtol=1e-5)

    def test_appearance_state_not_ported(self, rng):
        """Appearance states, once refused, now cross in both directions:
        the embeddings and the MLP tensors round-trip exactly, with the
        AppearanceConfig given or inferred from the array shapes."""
        from skyfall_gs_tpu.model.appearance import AppearanceConfig

        cfg = AppearanceConfig(True, 2, 8, 16)
        st = jg.create_from_points(rng.normal(0, 1, (8, 3)), rng.uniform(0, 1, (8, 3)),
                                   appearance=cfg, num_cameras=3, capacity=16)
        d = jax_state_to_numpy(st)
        port = tg.state_from_numpy(d)
        assert port.appearance == cfg
        assert port.params.appearance_mlp["l1"]["w"].shape == (16, 16)
        back = tg.state_to_numpy(port)
        for k in ("embeddings", "appearance_embeddings"):
            np.testing.assert_array_equal(back[k], d[k])
        jax.tree.map(np.testing.assert_array_equal, back["appearance_mlp"],
                     d["appearance_mlp"])
        del d["appearance"]
        assert tg.state_from_numpy(d).appearance == cfg


def test_config_is_a_copy():
    classes = [v for v in vars(jconfig).values()
               if dataclasses.is_dataclass(v) and v.__module__ == jconfig.__name__]
    assert classes
    for cls in classes:
        port_cls = getattr(tconfig, cls.__name__)
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(cls()), cls.__name__


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import skyfall_gs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'skyfall_gs_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
