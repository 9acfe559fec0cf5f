"""Port parity: densify/prune, capacity growth, the 3D filter, opacity reset,
radius prune and the xyz LR schedule.

A hand-built state (appearance on, random Adam moments) goes through the
JAX pass and the port's.  Everything decided by comparisons and integer
bookkeeping -- the statistics, the alive mask, every parameter and moment
field, filter_3d -- must be EQUAL.  The exceptions are the split
children's xyz, whose offsets come from each package's own RNG (the
port's are checked as parent + R (n s) with the n the port drew, 1e-6),
and their log-scales log(s / 1.6), which two float32 log implementations
round 1 ulp apart (1e-6 relative).  Filter, opacity reset and LR
schedule: 1e-6 relative (same float32 formulas).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import OptimizationConfig
from skyfall_gs_tpu.core.camera import orbit_cameras as jorbit
from skyfall_gs_tpu.model import densify as jdensify
from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.model import optim as joptim
from skyfall_gs_tpu.model.appearance import AppearanceConfig
from skyfall_gs_tpu.train import step as jstep
from skyfall_gs_tpu.utils.general import expon_lr_schedule as jsched
from skyfall_gs_tpu_torch.core.camera import orbit_cameras as torbit
from skyfall_gs_tpu_torch.core.transforms import quat_to_rotmat
from skyfall_gs_tpu_torch.model import densify as tdensify
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model import optim as toptim
from skyfall_gs_tpu_torch.train import step as tstep
from skyfall_gs_tpu_torch.utils.general import expon_lr_schedule as tsched
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
N, CAP = 40, 44
KW = dict(max_grad=2e-4, min_opacity=0.005, extent=1.0, max_screen_size=20.0,
          percent_dense=0.01)


def _t(x):
    return torch.from_numpy(np.array(x))


def hand_built(rng, with_stats=True):
    """40 live splats in a 44-slot state: small ones (clone), large ones
    (split), some transparent (prune), some huge (scale > 0.1 extent:
    pruned, and their children too), and more children than free slots."""
    pts = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    st = jg.create_from_points(pts, rng.uniform(0, 1, (N, 3)), capacity=CAP,
                               appearance=AppearanceConfig(True, 2, 8, 16),
                               num_cameras=3)
    log_s = np.full((CAP, 3), np.log(0.005), np.float32)        # clone size
    log_s[10:30] = np.log(rng.uniform(0.02, 0.08, (20, 3)))      # split size
    log_s[30:33] = np.log(0.3)                                   # huge: pruned
    log_s[33:36, 0] = np.log(0.12)                               # child 0.075: kept
    logit = rng.normal(0, 1, (CAP, 1)).astype(np.float32)
    logit[[2, 12, 25]] = -7.0                                    # transparent
    logit[N:] = -10.0
    quat = rng.normal(0, 1, (CAP, 4)).astype(np.float32)
    quat[N:] = [1, 0, 0, 0]
    dc = rng.normal(0, 1, (CAP, 1, 3)).astype(np.float32)        # unique rows
    params = st.params.replace(scaling=jnp.asarray(log_s), opacity=jnp.asarray(logit),
                               rotation=jnp.asarray(quat), features_dc=jnp.asarray(dc))
    alive = np.asarray(st.aux.alive)
    denom = np.where(alive, rng.integers(1, 6, CAP), 0).astype(np.float32)
    acc = np.where(alive, rng.exponential(4e-4, CAP), 0).astype(np.float32) * denom
    acc_abs = acc + np.where(alive, rng.exponential(1e-4, CAP), 0).astype(np.float32) * denom
    if not with_stats:
        denom[:] = acc[:] = acc_abs[:] = 0.0
    aux = st.aux.replace(grad_accum=jnp.asarray(acc), grad_accum_abs=jnp.asarray(acc_abs),
                         grad_accum_abs_max=jnp.asarray(acc_abs), denom=jnp.asarray(denom),
                         max_radii2d=jnp.asarray(rng.integers(0, 30, CAP).astype(np.float32)),
                         filter_3d=jnp.asarray(rng.uniform(0.01, 0.1, CAP).astype(np.float32)))
    opt = joptim.adam_init(params)
    opt = opt.replace(
        mu=jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 1, x.shape), x.dtype), opt.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(rng.uniform(0, 1, x.shape), x.dtype), opt.nu),
        count=jnp.int32(7))
    return st.replace(params=params, aux=aux), opt


def port_of(st, opt):
    model = tg.state_from_numpy(jax_state_to_numpy(st))
    mu = tg.GaussianParams(**{k: tg.map_leaf(lambda x: _t(np.asarray(x)), getattr(opt.mu, k))
                              for k in tg.field_names(tg.GaussianParams)})
    nu = tg.GaussianParams(**{k: tg.map_leaf(lambda x: _t(np.asarray(x)), getattr(opt.nu, k))
                              for k in tg.field_names(tg.GaussianParams)})
    return model, toptim.AdamState(mu=mu, nu=nu, count=int(opt.count))


def assert_tree_equal(port, ref, skip=()):
    ref = dict(tg.flat_fields(ref))
    for k, v in tg.flat_fields(port):
        if k not in skip:
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("with_stats", [True, False])
def test_densify_and_prune_matches_jax(rng, with_stats):
    st, opt = hand_built(rng, with_stats)
    model, topt = port_of(st, opt)
    xyz0 = model.params.xyz.clone()
    scale0 = torch.exp(model.params.scaling.clone())
    rot0 = quat_to_rotmat(model.params.rotation.clone())
    dc0 = model.params.features_dc.clone()
    p_j, aux_j, opt_j, stats_j = jax.jit(jdensify.densify_and_prune, static_argnames=tuple(KW))(
        st.params, st.aux, opt, jax.random.PRNGKey(3), **KW)
    stats = tdensify.densify_and_prune(model.params, model.aux, topt,
                                       torch.Generator().manual_seed(11), **KW)

    for k in stats._fields:
        assert int(getattr(stats, k)) == int(getattr(stats_j, k)), k
    if with_stats:
        assert int(stats.n_cloned) > 0 and int(stats.n_split) > 0
        assert int(stats.n_pruned) > 0 and int(stats.n_dropped) > 0
    else:   # no statistics: only the prune fires
        assert int(stats.n_cloned) == int(stats.n_split) == int(stats.n_dropped) == 0
    assert_tree_equal(model.aux, aux_j)
    assert_tree_equal(model.params, p_j, skip=("xyz", "scaling"))
    assert_tree_equal(topt.mu, opt_j.mu)
    assert_tree_equal(topt.nu, opt_j.nu)
    for k in ("grad_accum", "grad_accum_abs", "grad_accum_abs_max", "denom", "max_radii2d"):
        assert float(getattr(model.aux, k).abs().max()) == 0.0

    # xyz: equal except at the written split children (the clones come
    # first, so the dropped children are split children), which are
    # parent + R (n s) for one of the port's two draws.
    xyz = model.params.xyz
    slots = np.flatnonzero((xyz.numpy() != np.asarray(p_j.xyz)).any(1))
    assert len(slots) == 2 * int(stats.n_split) - int(stats.n_dropped)
    assert model.aux.alive[torch.from_numpy(slots)].all()
    gen = torch.Generator().manual_seed(11)
    noise = [torch.randn((CAP, 3), generator=gen) for _ in range(2)]
    offsets = [torch.einsum("nij,nj->ni", rot0, n * scale0) for n in noise]
    scaling, scaling_j = model.params.scaling.numpy(), np.asarray(p_j.scaling)
    outside = np.ones(CAP, bool)
    outside[slots] = False
    np.testing.assert_array_equal(scaling[outside], scaling_j[outside])
    np.testing.assert_allclose(scaling[slots], scaling_j[slots], rtol=1e-6)
    for j in slots:
        parent = int(torch.nonzero((dc0 == model.params.features_dc[j]).all(-1).all(-1))[0, 0])
        cands = torch.stack([xyz0[parent] + o[parent] for o in offsets])
        assert float((cands - xyz[j]).abs().max(1).values.min()) <= 1e-6, j


def test_grow_capacity_then_step(rng):
    st, opt = hand_built(rng)
    model, topt = port_of(st, opt)
    grown_j, gopt_j = jdensify.grow_capacity(st, opt, 96)
    grown, gopt = tdensify.grow_capacity(model, topt, 96)
    assert grown.params.capacity == 96 and gopt.count == 7
    assert_tree_equal(grown.params, grown_j.params)
    assert_tree_equal(grown.aux, grown_j.aux)
    assert_tree_equal(gopt.mu, gopt_j.mu)
    assert_tree_equal(gopt.nu, gopt_j.nu)
    for moments in (gopt.mu, gopt.nu):
        for k, v in tg.flat_fields(moments):
            if v.shape[0] == 96:
                assert float(v[CAP:].abs().max()) == 0.0, k
    assert (grown.params.opacity[CAP:] == -10.0).all()
    assert tdensify.grow_capacity(grown, gopt, 64) == (grown, gopt)

    # A step straight after growth uses the new tensors and stays finite;
    # the padding neither moves nor gets moments.
    cfg = OptimizationConfig()
    jcam, tcam = cameras(32, 32)
    r = np.random.default_rng(1)
    view = (r.uniform(0, 1, (32, 32, 3)), np.ones((32, 32)), r.uniform(1, 5, (32, 32)))
    ts = tstep.TrainState(model=grown, opt=gopt)
    ts, m = tstep.make_train_step(cfg)(ts, tcam, *[_t(v.astype(np.float32)) for v in view],
                                       torch.zeros(3), 1e-4, 0.01)
    ts_j, m_j = jstep.make_train_step(cfg)(
        jstep.TrainState(model=grown_j, opt=gopt_j, step=jnp.int32(0)), jcam,
        *[jnp.asarray(v, jnp.float32) for v in view], jnp.zeros(3), jax.random.PRNGKey(0),
        1e-4, 0.01)
    np.testing.assert_allclose(float(m.loss), float(m_j.loss), rtol=1e-5)
    for k, v in tg.flat_fields(ts.model.params):
        assert torch.isfinite(v).all(), k
    for k, v in tg.flat_fields(ts.opt.nu):
        assert torch.isfinite(v).all(), k
        if v.shape[0] == 96:
            assert float(v[CAP:].abs().max()) == 0.0, k
    np.testing.assert_array_equal(ts.model.params.xyz[CAP:].numpy(),
                                  grown.params.xyz[CAP:].numpy())


def test_compute_3d_filter_reset_opacity_and_radius_prune(rng):
    n = 200
    xyz = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    alive = rng.uniform(size=n) < 0.8
    jc = jorbit([0, 0, 0], 35.0, 5.0, num_cams=3, width=48, height=32)
    jc += jorbit([0.5, 0, 0], 60.0, 4.0, num_cams=2, width=64, height=64)
    tc = torbit([0, 0, 0], 35.0, 5.0, num_cams=3, width=48, height=32)
    tc += torbit([0.5, 0, 0], 60.0, 4.0, num_cams=2, width=64, height=64)
    ref = jg.compute_3d_filter(jnp.asarray(xyz), jnp.asarray(alive),
                               *jg.camera_filter_arrays(jc))
    got = tg.compute_3d_filter(_t(xyz), _t(alive), *tg.camera_filter_arrays(tc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    far = np.full((4, 3), 500.0, np.float32)        # seen by no camera: fallback 1.0
    ref = jg.compute_3d_filter(jnp.asarray(far), jnp.ones(4, bool), *jg.camera_filter_arrays(jc))
    got = tg.compute_3d_filter(_t(far), torch.ones(4, dtype=torch.bool),
                               *tg.camera_filter_arrays(tc))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)

    st, _ = hand_built(rng)
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    np.testing.assert_allclose(
        tg.reset_opacity(port.params, port.aux.filter_3d).numpy(),
        np.asarray(jg.reset_opacity(st.params, st.aux.filter_3d)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tg.prune_by_radius(port.params, 0.6).numpy(),
                                  np.asarray(jg.prune_by_radius(st.params, 0.6)))
    assert port.active_sh_degree == 0
    for _ in range(5):
        port.one_up_sh_degree()
    assert port.active_sh_degree == 3


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 4.4, lr_final=1.6e-6 * 4.4, lr_delay_mult=0.01, max_steps=2000),
    dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=500),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_schedule(kw):
    j, t = jsched(**kw), tsched(**kw)
    for step in (-1, 0, 1, 7, 50, 99, 100, 101, 499, 500, 1234, 2000, 5000):
        v = t(step)
        assert isinstance(v, float)
        np.testing.assert_allclose(v, float(j(step)), rtol=1e-6)


def test_dataclass_tree_helpers_round_trip(rng):
    st, _ = hand_built(rng)
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    pairs = tg.flat_fields(port.params)
    assert [k for k, _ in pairs][-6:] == [
        "appearance_mlp/l0/b", "appearance_mlp/l0/w", "appearance_mlp/l1/b",
        "appearance_mlp/l1/w", "appearance_mlp/l2/b", "appearance_mlp/l2/w"]
    back = tg.from_flat(tg.GaussianParams, pairs)
    assert dataclasses.fields(back) == dataclasses.fields(port.params)
    assert all(a is b for (_, a), (_, b) in zip(tg.flat_fields(back), pairs))
