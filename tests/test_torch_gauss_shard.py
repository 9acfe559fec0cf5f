"""Port parity: gaussian-sharded training (parallel/gauss_shard.py, the
sharded densify of model/densify.py, the gauss axis and the grid of
parallel/mesh.py) on gloo ranks spawned on the CPU, against the JAX package
on G of the 8 virtual CPU devices that tests/conftest.py makes.

The ranks run tests/torch_gauss_ranks.py (no JAX in a rank) while the JAX
side runs in the test process.  The inputs are those of JAX's own
TestGaussianSharded (tests/test_train.py:345-400): 48 splats in capacity 64,
SH degree 1, filter_3d 0.05, one 32x32 view, depth on, here with appearance
on (2 frequencies, dim 8, hidden 16, 4 cameras) so the replicated leaves'
all-reduce is in the step.

The port computes the true gradient; JAX's ``shard_map`` step gives G times
it (the transpose of its image all-gather sums G identical cotangents;
ROADMAP, Queue 3).  Adam's step does not see the scale, so the parameters
agree; the moments and the densification statistics carry it.

Tolerances, and why:
  * against JAX's sharded step (G = 2, 4; the same depth bins, so the same
    per-bin early stops): loss and metrics 1e-5 relative; parameters after
    Adam within 2e-6 where JAX's first moment exceeds 1e-3 of its field's
    largest (Adam's first step is lr * sign(g)); ``grad_accum``,
    ``grad_accum_abs``, ``grad_accum_abs_max`` and Adam's first moment
    equal to JAX's / G, its second to JAX's / G^2, 1e-3 norm-relative (two
    rasterizers' gradients, as tests/test_torch_parallel.py holds them);
    visibility counts and radii exact;
  * against the single-device step (each bin stops at its own T = 1e-4,
    so only up to that boundary): the ``grad_accum`` sum within 1% of the
    single-device one, where JAX's is G times it (pinned here too), and
    Adam's first moment of ``xyz`` 1e-2 norm-relative (1.0007 and 8.4e-4
    measured at G = 2 and 4);
  * one shard: bit-equal to the single-device step;
  * the sharded render of fixed colors within 1e-4 of JAX's, and within
    JAX's own 5e-3 of the single-device render;
  * the sharded densify pass: the statistics, the alive mask, the moments
    and the filter exactly JAX's, every other non-position field within
    float32 rounding (1e-6: a split child's log scale is one exp and one
    log of its parent's); split children's positions differ (their noise),
    and only theirs;
  * capacity growth: every gathered tensor exactly JAX's (pads spread
    evenly, one block per shard);
  * the (2, 2) grid against JAX's grid: as the sharded step; against the
    2-view step on the same ranks: loss within JAX's own 2e-3, visibility
    counts exact, ``grad_accum`` sum within 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import Mesh

from skyfall_gs_tpu.config import OptimizationConfig
from skyfall_gs_tpu.model.appearance import AppearanceConfig
from skyfall_gs_tpu.model.gaussians import create_from_points, get_opacity, get_scaling
from skyfall_gs_tpu.parallel import gauss_shard as jgs
from skyfall_gs_tpu.train.step import init_train_state as jinit
from skyfall_gs_tpu.train.step import make_train_step as jstep
from skyfall_gs_tpu_torch.config import OptimizationConfig as TOptimizationConfig
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.render import render
from skyfall_gs_tpu_torch.parallel import gauss_shard as gs
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.parallel.sharding import state_digest
from skyfall_gs_tpu_torch.train import step as tstep
from tests import torch_gauss_ranks
from tests.conftest import make_test_camera
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_parallel import camera_arrays, in_background, rel
from tests.torch_ranks import camera_from_arrays

torch.set_num_threads(1)
XYZ_LR, LAMBDA_OPACITY = 1e-3, 0.1
JOIN_S = 150.0
APPEARANCE = AppearanceConfig(enabled=True, n_fourier_freqs=2, embedding_dim=8, hidden=16)
STAT_KEYS = ("grad_accum", "grad_accum_abs", "grad_accum_abs_max")
DENSIFY = dict(max_grad=2e-4, min_opacity=0.005, max_screen_size=20.0, percent_dense=0.01)


def _inputs():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.8, (48, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    st = create_from_points(pts, cols, capacity=64, appearance=APPEARANCE, num_cameras=4)
    st = st.replace(active_sh_degree=1, aux=st.aux.replace(filter_3d=jnp.full(64, 0.05)))
    cams = [make_test_camera(32, 32), make_test_camera(32, 32, eye=(-2.0, 2.0, 1.5))]
    view = dict(images=rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
                masks=np.ones((2, 32, 32), np.float32),
                depths=rng.uniform(1, 5, (2, 32, 32)).astype(np.float32))
    return st, cams, view


def _densify_state():
    """The step's splats in capacity 128 with their rows permuted (live rows
    on every shard) and accumulated statistics; returns it and the extent
    that splits half the live splats by size."""
    rng = np.random.default_rng(1)
    pts = np.random.default_rng(0).normal(0, 0.8, (48, 3)).astype(np.float32)
    st = create_from_points(pts, rng.uniform(0, 1, (48, 3)).astype(np.float32), capacity=128,
                            appearance=APPEARANCE, num_cameras=4)
    perm = rng.permutation(128)
    st = jax.tree.map(lambda x: x[perm] if getattr(x, "shape", ())[:1] == (128,) else x, st)
    alive = np.asarray(st.aux.alive)
    denom = np.where(alive, rng.integers(1, 4, 128), 0).astype(np.float32)
    st = st.replace(aux=st.aux.replace(
        filter_3d=jnp.asarray(rng.uniform(0.01, 0.1, 128).astype(np.float32)),
        grad_accum=jnp.asarray(denom * rng.uniform(0, 4e-4, 128).astype(np.float32)),
        grad_accum_abs=jnp.asarray(denom * rng.uniform(0, 1e-3, 128).astype(np.float32)),
        denom=jnp.asarray(denom)))
    scale_max = np.exp(np.asarray(st.params.scaling)).max(1)[alive]
    return st, float(np.median(scale_max) / DENSIFY["percent_dense"])


def _jax_mesh(g):
    return Mesh(np.array(jax.devices("cpu")[:g]), ("gauss",))


def _jax_step(mesh, ts, cam, view):
    step = jgs.make_gauss_sharded_train_step(mesh, OptimizationConfig(), ts, use_depth=True)
    return step(jgs.shard_train_state(ts, mesh, "gauss"), cam[0], *(jnp.asarray(view[k][0]) for k in
                                                                ("images", "masks", "depths")),
                jnp.zeros(3), jax.random.PRNGKey(0), jnp.float32(XYZ_LR),
                jnp.float32(LAMBDA_OPACITY))


def _host(ts) -> dict:
    return {"params": {k: np.asarray(v) for k, v in tg.flat_fields(ts.model.params)},
            "mu": {k: np.asarray(v) for k, v in tg.flat_fields(ts.opt.mu)},
            "nu": {k: np.asarray(v) for k, v in tg.flat_fields(ts.opt.nu)},
            "aux": {k: np.asarray(v) for k, v in tg.flat_fields(ts.model.aux)}}


@pytest.fixture(scope="module")
def runs():
    """G = 2 and G = 4 (with the grid) on gloo ranks at once, JAX beside
    them."""
    st, cams, view = _inputs()
    ts = jinit(st)
    dst, extent = _densify_state()
    rcam = make_test_camera(32, 32)
    rpts = np.random.default_rng(0).normal(0, 0.8, (48, 3)).astype(np.float32)
    rst = create_from_points(rpts, np.full((48, 3), 0.5, np.float32), capacity=64)
    payload = dict(state=jax_state_to_numpy(st), cameras=[camera_arrays(c) for c in cams],
                   xyz_lr=XYZ_LR, lambda_opacity=LAMBDA_OPACITY, grow_to=128,
                   render=dict(state=jax_state_to_numpy(rst), camera=camera_arrays(rcam)),
                   densify=dict(state=jax_state_to_numpy(dst), mu_offset=0.25,
                                kwargs=dict(DENSIFY, extent=extent)), **view)
    out = {"inputs": (st, cams, view), "extent": extent}
    join2 = in_background(tmesh.launch, torch_gauss_ranks.step_render_densify_grow, 2,
                          (payload,), device="cpu", join_timeout_s=JOIN_S)
    join4 = in_background(tmesh.launch, torch_gauss_ranks.step_and_grid, 4, (payload,),
                          device="cpu", join_timeout_s=JOIN_S)
    out["single"] = jstep(OptimizationConfig(), use_depth=True)(
        jax.tree.map(jnp.copy, ts), cams[0], *(jnp.asarray(view[k][0]) for k in
                                               ("images", "masks", "depths")),
        jnp.zeros(3), jax.random.PRNGKey(0), jnp.float32(XYZ_LR), jnp.float32(LAMBDA_OPACITY))
    m2 = _jax_mesh(2)
    out["jax2"] = _jax_step(m2, ts, cams, view)

    def local_render(xyz, scales, quats, opac, colors, alive):
        return jgs.sharded_render_merge(xyz, scales, quats, opac, colors, alive, rcam,
                                        jnp.zeros(3), 0.1, "gauss", 2)[0]

    p0 = rst.params
    spec = jax.sharding.PartitionSpec("gauss")
    out["jax_render"] = np.asarray(shard_map(
        local_render, mesh=m2, in_specs=(spec,) * 6, out_specs=jax.sharding.PartitionSpec(),
        check_vma=False)(p0.xyz, get_scaling(p0), p0.rotation, get_opacity(p0),
                         jnp.full((64, 3), 0.5), rst.aux.alive))
    dts = jinit(dst)
    dts = dts.replace(opt=dts.opt.replace(mu=jax.tree.map(lambda x: x + 0.25, dts.opt.mu)))
    out["jax_densify"] = jgs.make_sharded_densify(m2, dts, axis="gauss",
                                                  **dict(DENSIFY, extent=extent))(
        jgs.shard_train_state(dts, m2, "gauss"), jax.random.PRNGKey(1))
    out["jax_grow"] = jgs.sharded_grow_capacity(jgs.shard_train_state(ts, m2, "gauss"), m2, 128)
    out["jax4"] = _jax_step(_jax_mesh(4), ts, cams, view)
    grid_mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("data", "gauss"))
    cam_b = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    out["jax_grid"] = jgs.make_grid_train_step(grid_mesh, OptimizationConfig(), ts,
                                               use_depth=True)(
        jgs.shard_train_state(ts, grid_mesh, "gauss"), cam_b,
        *(jnp.asarray(view[k]) for k in ("images", "masks", "depths")), jnp.zeros(3),
        jax.random.PRNGKey(0), jnp.float32(XYZ_LR), jnp.float32(LAMBDA_OPACITY))
    out[2], out[4] = join2(), join4()
    return out


def _hold_against_jax(port: dict, metrics: dict, jts, jm, g: int):
    for k in ("loss", "l1", "depth_loss", "opacity_loss", "psnr"):
        np.testing.assert_allclose(metrics[k], float(getattr(jm, k)), rtol=1e-5, err_msg=k)
    assert metrics["n_alive"] == int(jm.n_alive) == 48
    assert metrics["overflow"] == int(jm.overflow) == 0
    ref = _host(jts)
    assert port["params"].keys() == ref["params"].keys()
    for k, v in port["params"].items():
        big = np.abs(ref["mu"][k])
        sel = big > 1e-3 * big.max()
        np.testing.assert_allclose(v[sel], ref["params"][k][sel], atol=2e-6, err_msg=k)
        assert rel(port["mu"][k], ref["mu"][k] / g) <= 1e-3, k
        assert rel(port["nu"][k], ref["nu"][k] / g ** 2) <= 1e-3, k
    for k in ("denom", "max_radii2d", "alive"):
        np.testing.assert_array_equal(port["aux"][k], ref["aux"][k], k)
    for k in STAT_KEYS:
        assert rel(port["aux"][k], ref["aux"][k] / g) <= 1e-3, k


@pytest.mark.parametrize("g", [2, 4])
def test_sharded_step_matches_jax_divided_by_g(runs, g):
    ranks = runs[g]
    jts, jm = runs[f"jax{g}"]
    r0 = ranks[0]["step"]
    _hold_against_jax(r0["state"], r0["metrics"], jts, jm, g)
    assert r0["local_rows"] == 64 // g
    assert {r["step"]["state"]["digest"] for r in ranks} == {r0["state"]["digest"]}
    assert all(r["step"]["metrics"] == r0["metrics"] for r in ranks)
    # Forward: 3 gathers and 2 all-reduces; backward: 1 reduce-scatter; the
    # appearance gradients' all-reduce and n_alive's.
    assert r0["traffic"]["collectives"] == 8


@pytest.mark.parametrize("g", [2, 4])
def test_sharded_gradient_is_the_single_device_one_not_g_times(runs, g):
    """The G factor, on each side of the fix: JAX's sharded statistics are G
    times the single-device step's, the port's are the single-device ones."""
    single = np.asarray(runs["single"][0].model.aux.grad_accum).sum()
    port = runs[g][0]["step"]["state"]["aux"]["grad_accum"].sum()
    jax_sharded = np.asarray(runs[f"jax{g}"][0].model.aux.grad_accum).sum()
    assert abs(port / single - 1.0) <= 0.01, port / single
    assert abs(jax_sharded / single / g - 1.0) <= 0.01, jax_sharded / single
    s_mu = np.asarray(runs["single"][0].opt.mu.xyz)
    assert rel(runs[g][0]["step"]["state"]["mu"]["xyz"], s_mu) <= 1e-2


def test_one_shard_equals_the_single_device_step(tmp_path):
    """A 1-rank gauss mesh in this process: two steps with ray jitter,
    resampled GT and appearance bit-equal to the single-device step's."""
    st, cams, view = _inputs()
    host = jax_state_to_numpy(st)
    cam = camera_from_arrays(camera_arrays(cams[0]))
    args = [torch.from_numpy(view[k][0]) for k in ("images", "masks", "depths")]
    kw = dict(use_depth=True, ray_jitter=True, resample_gt=True)
    mesh = tmesh.make_mesh(1, axis="gauss", backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        states, metrics = [], []
        for sharded in (False, True):
            ts = tstep.init_train_state(tg.state_from_numpy(host))
            if sharded:
                ts = gs.shard_train_state(ts, mesh)
                step = gs.make_gauss_sharded_train_step(mesh, TOptimizationConfig(), **kw)
            else:
                step = tstep.make_train_step(TOptimizationConfig(), **kw)
            gen = torch.Generator().manual_seed(5)
            for _ in range(2):
                ts, m = step(ts, cam, *args, torch.zeros(3), XYZ_LR, LAMBDA_OPACITY,
                             generator=gen)
            states.append(ts)
            metrics.append(m)
        assert mesh.traffic["collectives"] == 2 * 8
    finally:
        dist.destroy_process_group()
    assert state_digest(states[0]) == state_digest(states[1])
    for k in metrics[0]._fields:
        assert torch.equal(getattr(metrics[0], k), getattr(metrics[1], k)), k


def test_sharded_render_matches_jax_and_the_single_device_render(runs):
    ranks = runs[2]
    color = ranks[0]["render"]["color"]
    np.testing.assert_array_equal(ranks[1]["render"]["color"], color)
    assert ranks[0]["render"]["overflow"] == 0
    assert float(np.abs(color - runs["jax_render"]).max()) <= 1e-4
    rpts = np.random.default_rng(0).normal(0, 0.8, (48, 3)).astype(np.float32)
    model = tg.create_from_points(rpts, np.full((48, 3), 0.5, np.float32), capacity=64)
    cam = camera_from_arrays(camera_arrays(make_test_camera(32, 32)))
    single = render(model, cam, torch.zeros(3), with_3d_filter=False,
                    override_color=torch.full((64, 3), 0.5), with_normals=False)
    assert float(np.abs(color - single.color.detach().numpy()).max()) < 5e-3


def test_shard_layout(runs):
    """tests/test_train.py:515-535 on the port: each rank holds its block
    of rows of every per-splat leaf, Adam moments included; the camera
    table replicates."""
    for k, r in enumerate(runs[2]):
        lay = r["layout"]
        assert lay["rows"] == 32 and lay["xyz"] and lay["mu"] and lay["alive"], (k, lay)
        assert lay["camera_table"] == (4, 8)


def test_sharded_densify_matches_jax(runs):
    jstate, jstats = runs["jax_densify"]
    ranks = runs[2]
    d = ranks[0]["densify"]
    assert d["state"]["digest"] == ranks[1]["densify"]["state"]["digest"]
    assert d["stats"] == {k: int(getattr(jstats, k)) for k in jstats._fields}
    assert d["stats"]["n_cloned"] > 0 and d["stats"]["n_split"] > 0, d["stats"]
    ref = _host(jstate)
    port = d["state"]
    np.testing.assert_array_equal(port["aux"]["alive"], ref["aux"]["alive"])
    for k, v in port["params"].items():
        if k != "xyz":   # a split child's log scale is one exp and one log away
            np.testing.assert_allclose(v, ref["params"][k], rtol=1e-6, atol=1e-7, err_msg=k)
    for part in ("mu", "nu"):
        for k, v in port[part].items():
            np.testing.assert_array_equal(v, ref[part][k], f"{part}/{k}")
    for k in ("filter_3d", "grad_accum", "denom"):
        np.testing.assert_array_equal(port["aux"][k], ref["aux"][k], k)
    # Only split children (written into free slots, their parents' among
    # them) moved; children lost to a full shard are in n_dropped.
    moved = np.any(port["params"]["xyz"] != ref["params"]["xyz"], axis=1)
    assert 0 < int(moved.sum()) <= 2 * d["stats"]["n_split"]
    assert not (moved & ~port["aux"]["alive"]).any()


def test_sharded_grow_capacity_spreads_the_pads(runs):
    ref = _host(runs["jax_grow"])
    for r in runs[2]:
        grow = r["grow"]
        assert grow["rows"] == 64 and "not divisible" in grow["indivisible"]
        for part in ("params", "mu", "nu", "aux"):
            for k, v in grow["state"][part].items():
                np.testing.assert_array_equal(v, ref[part][k], f"{part}/{k}")
    alive = runs[2][0]["grow"]["state"]["aux"]["alive"]
    # Shard k's 32 rows come first in its block of 64, then its 32 pads.
    np.testing.assert_array_equal(alive[:32], np.arange(32) < 48)
    assert not alive[32:64].any() and alive[64:80].all() and not alive[80:].any()


def test_grid_matches_jax_and_the_two_view_step(runs):
    ranks = runs[4]
    jts, jm = runs["jax_grid"]
    g0 = ranks[0]["grid"]
    assert [(r["grid"]["data_rank"], r["grid"]["gauss_rank"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r["grid"]["state"]["digest"] for r in ranks}) == 1
    _hold_against_jax(g0["state"], g0["metrics"], jts, jm, 2)
    view = ranks[0]["view"]
    assert abs(g0["metrics"]["loss"] - view["metrics"]["loss"]) < 2e-3
    np.testing.assert_array_equal(g0["state"]["aux"]["denom"], view["state"]["aux"]["denom"])
    ratio = g0["state"]["aux"]["grad_accum"].sum() / view["state"]["aux"]["grad_accum"].sum()
    assert abs(ratio - 1.0) <= 0.01, ratio
