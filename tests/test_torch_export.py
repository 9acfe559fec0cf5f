"""Port parity: the exports and the loaders the render tools use
(io/gaussian_ply.py save_fused_ply / save_splat / load_splat,
cli/render_video.py load_state_from_ply / load_state_from_checkpoint).

Tolerances, and why:
  * fused PLY: positions, rotations and SH coefficients are copied, so
    they compare EXACTLY; the baked opacity logit and log-scale go through
    float32 exp / log / sqrt, whose last ulp XLA and PyTorch may round
    differently: 1e-5 absolute (measured <= 2e-6); the appearance-toned
    colours (``color_mapped``) pass a small MLP: 1e-5;
  * ``.splat``: positions exact, linear scales 1e-6 relative, the uint8
    colour / alpha / quaternion bytes within 1 (a float32 ulp can cross a
    rounding boundary), the importance order identical;
  * loaders: they move arrays, so the loaded states compare EXACTLY.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.cli import render_video as jrv
from skyfall_gs_tpu.io import gaussian_ply as jply
from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.model.appearance import AppearanceConfig
from skyfall_gs_tpu.train import checkpoint as jckpt
from skyfall_gs_tpu.train.step import init_train_state as jinit
from skyfall_gs_tpu_torch.cli import render_video as trv
from skyfall_gs_tpu_torch.io import gaussian_ply as tply
from skyfall_gs_tpu_torch.io.ply import read_ply
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.train import checkpoint as tckpt
from skyfall_gs_tpu_torch.train.step import init_train_state as tinit
from tests.test_torch_core import jax_state_to_numpy

torch.set_num_threads(1)
APP = AppearanceConfig(True, 2, 8, 16)


def jax_state(appearance: bool, seed: int = 0):
    """A JAX model state with varied scales, opacities, SH, rotations and
    filters, and three dead slots."""
    rng = np.random.default_rng(seed)
    n = 60
    pts = rng.normal(0, 2, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = jg.create_from_points(pts, cols, max_sh_degree=2,
                               appearance=APP if appearance else AppearanceConfig(),
                               num_cameras=9, capacity=72)
    p = st.params
    cap = p.capacity

    def noise(x, s):
        return jnp.asarray(np.asarray(x) + rng.normal(0, s, x.shape).astype(np.float32))

    alive = np.asarray(st.aux.alive).copy()
    alive[[3, 17, 41]] = False
    params = p.replace(features_rest=noise(p.features_rest, 0.2),
                       features_dc=noise(p.features_dc, 0.3),
                       scaling=noise(p.scaling, 0.5), opacity=noise(p.opacity, 1.5),
                       rotation=noise(p.rotation, 0.4))
    if appearance:
        params = params.replace(appearance_embeddings=noise(p.appearance_embeddings, 0.5))
    aux = st.aux.replace(alive=jnp.asarray(alive),
                         filter_3d=jnp.asarray(rng.uniform(0.0, 0.3, cap).astype(np.float32)))
    return st.replace(params=params, aux=aux, active_sh_degree=2)


def _ply_arrays(path):
    return {k: np.asarray(v) for k, v in read_ply(path).items()}


@pytest.mark.parametrize("appearance, color_mapped",
                         [(False, False), (True, False), (True, True)])
def test_fused_ply_matches_jax(tmp_path, appearance, color_mapped):
    js = jax_state(appearance)
    ts = tg.state_from_numpy(jax_state_to_numpy(js))
    jply.save_fused_ply(js, str(tmp_path / "j.ply"), color_mapped=color_mapped)
    tply.save_fused_ply(ts, str(tmp_path / "t.ply"), color_mapped=color_mapped)
    got, ref = _ply_arrays(str(tmp_path / "t.ply")), _ply_arrays(str(tmp_path / "j.ply"))
    assert list(got) == list(ref) and "filter_3D" not in got
    assert len(got["x"]) == 57
    for k, v in ref.items():
        if k.startswith(("opacity", "scale_")):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
        elif k.startswith("f_") and color_mapped:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    if color_mapped:        # the MLP really toned the colours
        plain = _ply_arrays(str(tmp_path / "j.ply"))
        jply.save_fused_ply(js, str(tmp_path / "p.ply"))
        assert np.abs(_ply_arrays(str(tmp_path / "p.ply"))["f_dc_0"] - plain["f_dc_0"]).max() > 0


def test_splat_matches_jax_and_round_trips(tmp_path):
    js = jax_state(False, seed=1)
    ts = tg.state_from_numpy(jax_state_to_numpy(js))
    jply.save_splat(js, str(tmp_path / "j.splat"))
    tply.save_splat(ts, str(tmp_path / "t.splat"))
    assert (tmp_path / "t.splat").stat().st_size == 57 * 32
    got, ref = tply.load_splat(str(tmp_path / "t.splat")), \
        jply.load_splat(str(tmp_path / "j.splat"))
    np.testing.assert_array_equal(got["xyz"], ref["xyz"])     # same importance order
    np.testing.assert_allclose(got["scale"], ref["scale"], rtol=1e-6)
    for k in ("rgb", "opacity", "rotation"):
        assert np.abs(got[k] - ref[k]).max() <= 1.0 / 128 + 1e-7, k
    # round trip against the state itself
    keep = ts.aux.alive.numpy()
    xyz = ts.params.xyz.numpy()[keep]
    order = [int(np.flatnonzero((xyz == row).all(1))[0]) for row in got["xyz"]]
    assert sorted(order) == list(range(57))
    scale = tg.scaling_with_3d_filter(ts.params, ts.aux.filter_3d).numpy()[keep][order]
    np.testing.assert_array_equal(got["scale"], scale)
    opac = tg.opacity_with_3d_filter(ts.params, ts.aux.filter_3d).numpy()[keep][order]
    assert np.abs(got["opacity"] - opac).max() <= 1.0 / 255 + 1e-6
    assert np.all(np.diff(opac * scale.prod(1)) <= 0)        # importance-sorted
    q = ts.params.rotation.numpy()[keep][order]
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert np.abs(got["rotation"] - q).max() <= 1.0 / 128 + 1e-6
    (tmp_path / "bad.splat").write_bytes(b"\x00" * 33)
    with pytest.raises(ValueError, match="multiple of 32"):
        tply.load_splat(str(tmp_path / "bad.splat"))


@pytest.mark.parametrize("fused", [False, True])
def test_load_state_from_ply_matches_jax(tmp_path, fused):
    js = jax_state(False, seed=2)
    path = str(tmp_path / "s.ply")
    (jply.save_fused_ply if fused else jply.save_gaussian_ply)(js, path)
    ts, t_filter = trv.load_state_from_ply(path)
    jsl, j_filter = jrv.load_state_from_ply(path)
    assert t_filter == j_filter == (not fused)
    got, ref = tg.state_to_numpy(ts), jax_state_to_numpy(jsl)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert ts.active_sh_degree == ts.max_sh_degree == 2 and not ts.appearance.enabled


@pytest.mark.parametrize("appearance", [False, True])
def test_checkpoints_load_across_packages(tmp_path, appearance):
    js = jax_state(appearance, seed=3)
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jinit(js), 77)
    ts, it = trv.load_state_from_checkpoint(str(tmp_path / "j.npz"))
    assert it == 77 and ts.appearance == js.appearance
    assert ts.active_sh_degree == 2 and ts.params.capacity == 72
    got, ref = tg.state_to_numpy(ts), jax_state_to_numpy(js)
    for k, v in ref.items():
        if v is not None and not isinstance(v, (int, float, tuple)):
            import jax

            jax.tree.map(np.testing.assert_array_equal, got[k], v)

    # and the port's checkpoint loads in the JAX tool
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), tinit(ts), 78)
    back, it2 = jrv.load_state_from_checkpoint(str(tmp_path / "t.npz"))
    assert it2 == 78
    np.testing.assert_array_equal(np.asarray(back.params.xyz), got["xyz"])
    np.testing.assert_array_equal(np.asarray(back.aux.alive), got["alive"])
    meta = json.loads(str(np.load(str(tmp_path / "t.npz"))["__meta__"]))
    assert meta["appearance"] == list(js.appearance)
