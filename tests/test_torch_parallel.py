"""Port parity: view-parallel training and rendering (parallel/mesh.py,
parallel/sharding.py, core/camera.band_camera) on gloo ranks spawned on
the CPU, against the JAX package on 2 of the 8 virtual CPU devices that
tests/conftest.py makes.

The ranks run the programs of tests/torch_ranks.py (no JAX in a rank); the
JAX side runs in the test process at the same time.

Tolerances, and why:
  * one 2-view step from the inputs of tests/test_train.py:147-183 (40
    points, capacity 64, two 32x32 orbit cameras, depth on), as
    tests/test_torch_step.py holds one view: loss and metrics 1e-5
    relative; parameters on the elements whose JAX gradient exceeds 1e-3 of
    its field's largest within 2e-6 (Adam's first step is lr * sign(g)); the
    moments 1e-3 norm-relative and the summed statistics 1e-3 relative, as
    tests/test_torch_step.py holds one view's (per-view gradients of two
    rasterizers; measured 9.6e-5 at worst); visibility counts and radii
    exact;
  * the ranks' states: bit-equal (one SHA-256 of every tensor);
  * world size 1: bit-equal to the single-device step (the mean over one
    rank is the identity);
  * band cameras 1e-6 against JAX's; a band render within JAX's own band
    bounds of the full render (6e-2 max, 5e-3 mean: splats far outside a
    band's view cone clamp differently); the tile-parallel frame within
    1e-4 of JAX's tile-parallel frame; the parallel render exactly equal to
    each camera rendered alone.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from skyfall_gs_tpu.config import OptimizationConfig
from skyfall_gs_tpu.core.camera import band_camera as jband_camera
from skyfall_gs_tpu.core.camera import orbit_cameras as jorbit
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.model.render import render as jrender
from skyfall_gs_tpu.parallel.mesh import make_mesh as jmake_mesh
from skyfall_gs_tpu.parallel.sharding import make_parallel_train_step as jparallel_step
from skyfall_gs_tpu.parallel.sharding import make_tile_parallel_render as jtile_render
from skyfall_gs_tpu.train.step import init_train_state as jinit
from skyfall_gs_tpu_torch.core.camera import band_camera
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.parallel.sharding import make_parallel_train_step, state_digest
from skyfall_gs_tpu_torch.train import step as tstep
from tests import torch_ranks
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
XYZ_LR, LAMBDA_OPACITY = 1e-3, 0.1
JOIN_S = 120.0


def camera_arrays(cam) -> dict:
    """A JAX camera's fields as numpy, for a rank (torch_ranks.camera_from_arrays)."""
    d = {k: np.asarray(getattr(cam, k)) for k in torch_ranks._CAMERA_TENSORS + ("uid",)}
    d.update(znear=cam.znear, zfar=cam.zfar, width=cam.width, height=cam.height)
    return d


def in_background(fn, *args, **kwargs):
    """Run ``fn`` in a thread (the ranks work while JAX runs here); the
    returned function joins it and gives its result or raises its error."""
    box = {}

    def body():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:   # handed to the joining test
            box["err"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()

    def join():
        th.join(JOIN_S + 30.0)
        assert not th.is_alive(), "ranks did not finish"
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------------------
# One 2-view step and the renders, against JAX
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 0.8, (40, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    st = create_from_points(pts, cols, capacity=64)
    st = st.replace(aux=st.aux.replace(filter_3d=jnp.full(64, 0.05)))
    cams = jorbit([0, 0, 0], 40.0, 3.0, num_cams=2, width=32, height=32)
    imgs = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    masks = np.ones((2, 32, 32), np.float32)
    depths = rng.uniform(1, 5, (2, 32, 32)).astype(np.float32)
    # the render case: tests/test_train.py:313's splats and camera, 2 bands
    rrng = np.random.default_rng(0)
    rpts = rrng.normal(0, 0.8, (50, 3)).astype(np.float32)
    rst = create_from_points(rpts, rrng.uniform(0, 1, (50, 3)).astype(np.float32),
                             capacity=64)
    rst = rst.replace(aux=rst.aux.replace(filter_3d=jnp.full(64, 0.05)))
    rcam, _ = cameras(32, 64)
    payload = dict(state=jax_state_to_numpy(st), cameras=[camera_arrays(c) for c in cams],
                   images=imgs, masks=masks, depths=depths, xyz_lr=XYZ_LR,
                   lambda_opacity=LAMBDA_OPACITY, render_state=jax_state_to_numpy(rst),
                   render_camera=camera_arrays(rcam))
    join = in_background(tmesh.launch, torch_ranks.step_and_renders, 2, (payload,),
                         device="cpu", join_timeout_s=JOIN_S)

    mesh = jmake_mesh(2)
    cam_b = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    ts_j, m_j = jparallel_step(mesh, OptimizationConfig(), use_depth=True)(
        jinit(jax.tree.map(jnp.copy, st)), cam_b, jnp.asarray(imgs), jnp.asarray(masks),
        jnp.asarray(depths), jnp.zeros(3), jnp.float32(XYZ_LR), jnp.float32(LAMBDA_OPACITY))
    bands = jax.tree.map(lambda *xs: jnp.stack(xs), *[jband_camera(rcam, k, 2) for k in range(2)])
    frames_j = {"tile": np.asarray(jtile_render(jmake_mesh(2))(rst, bands, jnp.zeros(3))),
                "full": np.asarray(jrender(rst, rcam, jnp.zeros(3), testing=True,
                                           inference=True).color)}
    return ts_j, m_j, frames_j, join()


def test_parallel_step_loss_and_metrics_match_jax(two_ranks):
    _, m_j, _, ranks = two_ranks
    m = ranks[0]["metrics"]
    for k in ("loss", "l1", "depth_loss", "opacity_loss", "psnr"):
        np.testing.assert_allclose(m[k], float(getattr(m_j, k)), rtol=1e-5)
    assert m["overflow"] == int(m_j.overflow) == 0
    assert m["n_alive"] == int(m_j.n_alive) == 40
    assert ranks[1]["metrics"] == m


def test_parallel_step_parameters_and_moments_match_jax(two_ranks):
    ts_j, _, _, ranks = two_ranks
    st = ranks[0]["state"]
    assert st["step"] == st["count"] == int(ts_j.step) == 1
    ref = {k: np.asarray(v) for k, v in tg.flat_fields(ts_j.model.params)}
    mu = {k: np.asarray(v) for k, v in tg.flat_fields(ts_j.opt.mu)}
    nu = {k: np.asarray(v) for k, v in tg.flat_fields(ts_j.opt.nu)}
    assert st["params"].keys() == ref.keys()
    for k, v in st["params"].items():
        # Adam's first moment is (1 - b1) g: it carries the mean gradient.
        g = np.abs(mu[k])
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(v[sel], ref[k][sel], atol=2e-6, err_msg=k)
        assert rel(st["mu"][k], mu[k]) <= 1e-3, k
        assert rel(st["nu"][k], nu[k]) <= 1e-3, k


def test_parallel_step_statistics_match_jax(two_ranks):
    ts_j, _, _, ranks = two_ranks
    aux = ranks[0]["state"]["aux"]
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(aux[k], np.asarray(getattr(ts_j.model.aux, k)), k)
    # Visible on both views counts 2: the sum over ranks, not one view's.
    assert aux["denom"].max() == 2.0
    for k in ("grad_accum", "grad_accum_abs", "grad_accum_abs_max"):
        np.testing.assert_allclose(aux[k], np.asarray(getattr(ts_j.model.aux, k)),
                                   rtol=1e-3, atol=1e-9, err_msg=k)


def test_parallel_step_ranks_are_bit_equal(two_ranks):
    _, _, _, ranks = two_ranks
    assert ranks[0]["state"]["digest"] == ranks[1]["state"]["digest"]
    for part in ("params", "mu", "nu", "aux"):
        for k, v in ranks[0]["state"][part].items():
            np.testing.assert_array_equal(ranks[1]["state"][part][k], v)


def test_tile_parallel_render_matches_jax_and_the_full_frame(two_ranks):
    """The port's bands keep the full frame's clamp window, so its
    tile-parallel frame is the full frame: within 1e-4 of JAX's full frame
    and 1e-5 of its own; JAX's tile-parallel frame (bands clamped to their
    own FoV) within JAX's band bounds of it."""
    _, _, frames_j, ranks = two_ranks
    tile, full = ranks[0]["tile"], ranks[0]["full"]
    assert tile.shape == (64, 32, 3)
    np.testing.assert_array_equal(ranks[1]["tile"], tile)
    assert float(np.abs(tile - frames_j["full"]).max()) <= 1e-4
    assert float(np.abs(tile - full).max()) <= 1e-5
    diff = np.abs(tile - frames_j["tile"])
    assert diff.max() < 6e-2 and diff.mean() < 5e-3, (diff.max(), diff.mean())


def test_parallel_render_equals_each_camera_alone(two_ranks):
    _, _, _, ranks = two_ranks
    for r in ranks:
        (colors, depths), (c1, d1) = r["parallel"], r["alone"]
        assert colors.shape == (2, 32, 32, 3) and depths.shape == (2, 32, 32)
        np.testing.assert_array_equal(colors, c1)
        np.testing.assert_array_equal(depths, d1)


def test_band_camera_matches_jax(rng):
    jcam, tcam = cameras(48, 64)
    for k in range(4):
        jb, tb = jband_camera(jcam, k, 4), band_camera(tcam, k, 4)
        assert (tb.width, tb.height) == (jb.width, jb.height) == (48, 16)
        for f in torch_ranks._CAMERA_TENSORS:
            np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                       atol=1e-6, err_msg=f)
    with pytest.raises(ValueError, match="not divisible"):
        band_camera(tcam, 0, 3)


def test_band_renders_are_rows_of_the_full_render(rng):
    """tests/test_train.py:290-311 on the port: each band of 4 within JAX's
    bounds of the full frame (and within 1e-5: the port's bands keep the
    full frame's clamp window), and the full frame within 1e-4 of JAX's."""
    from skyfall_gs_tpu.ops.rasterize import rasterize as jrasterize
    from skyfall_gs_tpu_torch.ops.rasterize import rasterize
    from tests.conftest import make_random_splats, make_test_camera

    d = make_random_splats(rng, 60)
    keys = ("means3d", "scales", "quats", "opacities", "colors")
    jcam, (_, tcam) = make_test_camera(32, 64), cameras(32, 64)
    args = [torch.from_numpy(np.array(d[k])) for k in keys]
    full = rasterize(*args, tcam, bg=torch.zeros(3), backend="reference").color
    ref = jrasterize(*(d[k] for k in keys), jcam, bg=jnp.zeros(3), backend="reference").color
    assert float(np.abs(full.numpy() - np.asarray(ref)).max()) <= 1e-4
    for k in range(4):
        band = rasterize(*args, band_camera(tcam, k, 4), bg=torch.zeros(3),
                         backend="reference").color
        diff = np.abs(band.numpy() - full.numpy()[k * 16:(k + 1) * 16])
        assert diff.max() < 6e-2 and diff.mean() < 5e-3, (k, diff.max(), diff.mean())
        assert diff.max() <= 1e-5, (k, diff.max())


def test_band_keeps_the_full_frame_clamp_window():
    """A wide splat centered in the lower band reaches far into the upper
    one.  Clamped to the upper band's own FoV (the JAX package's band, and
    the port's before it kept the window) its conic changes and the band
    misses the full frame's rows by more than JAX's 6e-2 bound; with the
    full frame's window the band is the full frame's rows."""
    from skyfall_gs_tpu_torch.core.camera import clamp_window
    from skyfall_gs_tpu_torch.ops.rasterize import rasterize

    _, tcam = cameras(32, 64)
    # the splat's center on the ray through pixel row 56 of 64 (3/4 of the
    # lower band), 4 units in front of the camera; a long axis in depth
    # tilted toward y makes the Jacobian's y/z term matter
    wv = tcam.world_view.numpy().astype(np.float64)
    ty = (2.0 * 56.5 / 64 - 1.0) * float(tcam.tan_fovy)
    p_cam = np.array([0.0, ty, 1.0]) * 4.0
    mean = np.linalg.solve(wv[:3, :3], p_cam - wv[:3, 3])
    rot = wv[:3, :3].T @ np.array([[1, 0, 0], [0, np.cos(0.6), -np.sin(0.6)],
                                   [0, np.sin(0.6), np.cos(0.6)]])
    w = np.sqrt(0.5 * (1.0 + np.trace(rot)))
    quat = np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w), (rot[0, 2] - rot[2, 0]) / (4 * w),
                     (rot[1, 0] - rot[0, 1]) / (4 * w)])
    args = [torch.tensor(np.asarray(a, np.float32)[None]) for a in
            (mean, [0.3, 0.4, 3.0], quat, 0.9, [1.0, 0.2, 0.1])]
    args[3] = args[3].reshape(1)
    full = rasterize(*args, tcam, bg=torch.zeros(3), backend="reference").color.numpy()
    band = band_camera(tcam, 0, 2)
    assert band.clamp_window == tuple(float(v) for v in clamp_window(tcam))
    kept = rasterize(*args, band, bg=torch.zeros(3), backend="reference").color.numpy()
    own = rasterize(*args, dataclasses.replace(band, clamp_window=None), bg=torch.zeros(3),
                    backend="reference").color.numpy()
    assert float(np.abs(full[:32]).max()) > 0.1            # the splat reaches the upper band
    assert float(np.abs(own - full[:32]).max()) > 6e-2
    assert float(np.abs(kept - full[:32]).max()) <= 1e-5


# ----------------------------------------------------------------------------
# World size 1, and no fallback
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ray_jitter", [False, True], ids=["plain", "jitter"])
def test_world_size_one_equals_the_single_device_step(tmp_path, ray_jitter):
    """A 1-rank gloo mesh in this process: two steps bit-equal to the
    single-device step's, with ray jitter drawn from equal generators."""
    rng = np.random.default_rng(3)
    st = create_from_points(rng.normal(0, 0.8, (40, 3)).astype(np.float32),
                            rng.uniform(0, 1, (40, 3)).astype(np.float32), capacity=64)
    host = jax_state_to_numpy(st.replace(aux=st.aux.replace(filter_3d=jnp.full(64, 0.05))))
    _, cam = cameras(32, 32)
    view = [torch.from_numpy(a) for a in (rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                                          np.ones((32, 32), np.float32),
                                          rng.uniform(1, 5, (32, 32)).astype(np.float32))]
    kw = dict(use_depth=True, ray_jitter=ray_jitter, resample_gt=ray_jitter)
    mesh = tmesh.make_mesh(1, backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        states, metrics = [], []
        for step in (tstep.make_train_step(OptimizationConfig(), **kw),
                     make_parallel_train_step(mesh, OptimizationConfig(), **kw)):
            ts = tstep.init_train_state(tg.state_from_numpy(host))
            gen = torch.Generator().manual_seed(5)
            for _ in range(2):
                ts, m = step(ts, cam, *view, torch.zeros(3), XYZ_LR, LAMBDA_OPACITY,
                             generator=gen)
            states.append(ts)
            metrics.append(m)
        assert mesh.traffic == {"collectives": 4, "bytes": 2 * 4 * (64 * 59 + 64 * 5 + 5)}
    finally:
        dist.destroy_process_group()
    assert state_digest(states[0]) == state_digest(states[1])
    for k in metrics[0]._fields:
        assert torch.equal(getattr(metrics[0], k), getattr(metrics[1], k)), k


def test_a_failing_rank_fails_the_launch():
    """The failing rank's error ends the launch, and the rank still busy is
    ended with it rather than waited for."""
    import time

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="rank failed on purpose"):
        tmesh.launch(torch_ranks.fail_on_last_rank, 2, (60.0,), device="cpu",
                     timeout_s=30.0, join_timeout_s=JOIN_S)
    assert time.monotonic() - t0 < 45.0


def test_a_join_past_its_timeout_fails_the_launch():
    with pytest.raises(TimeoutError, match="did not finish within"):
        tmesh.launch(torch_ranks.sleep_past_the_join, 2, (60.0,), device="cpu",
                     join_timeout_s=8.0)


def test_nccl_needs_a_visible_gpu_per_rank(tmp_path, monkeypatch):
    """Raised before any rank starts: more NCCL ranks than visible GPUs, two
    NCCL ranks on one GPU, NCCL on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tmesh.launch(torch_ranks.fail_on_last_rank, 2, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="one device per rank"):
        tmesh.launch(torch_ranks.fail_on_last_rank, 2, device="cuda:0")
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        tmesh.make_mesh(1, backend="nccl", device="cpu", rank=0,
                        init_method=f"file://{tmp_path / 'rendezvous'}")
    assert not dist.is_initialized()


# ----------------------------------------------------------------------------
# The multi-host bootstrap (tests/test_infra.py:178-264 on the port)
# ----------------------------------------------------------------------------

def _clear_pod_env(monkeypatch):
    for v in (tmesh.ENV_COORDINATOR, tmesh.ENV_NUM_PROCESSES, tmesh.ENV_PROCESS_ID):
        monkeypatch.delenv(v, raising=False)


def test_slot_envs():
    envs = tmesh.multihost_slot_envs(["host-a", "host-b", "host-c"], 9000)
    assert len(envs) == 3
    for i, e in enumerate(envs):
        assert e[tmesh.ENV_COORDINATOR] == "host-a:9000"
        assert e[tmesh.ENV_NUM_PROCESSES] == "3"
        assert e[tmesh.ENV_PROCESS_ID] == str(i)


def test_single_process_noop(monkeypatch):
    _clear_pod_env(monkeypatch)
    assert tmesh.initialize_distributed(device="cpu") is False
    monkeypatch.setenv(tmesh.ENV_COORDINATOR, "localhost:1")
    monkeypatch.setenv(tmesh.ENV_NUM_PROCESSES, "1")
    assert tmesh.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_partial_config_fails_loudly(monkeypatch):
    _clear_pod_env(monkeypatch)
    monkeypatch.setenv(tmesh.ENV_COORDINATOR, "host-a:9000")
    monkeypatch.setenv(tmesh.ENV_PROCESS_ID, "1")
    with pytest.raises(RuntimeError, match="partial multi-host"):
        tmesh.initialize_distributed(device="cpu")


def test_two_process_pod(tmp_path):
    """Two processes join one pod through the SKYFALL_* environment (a TCP
    rendezvous on a free local port) and all-reduce over it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from skyfall_gs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh\n"
        "assert initialize_distributed(device='cpu', timeout_s=60)\n"
        "mesh = make_mesh(2, device='cpu')\n"
        "t = torch.tensor([float(mesh.rank + 1)])\n"
        "mesh.all_reduce_(t)\n"
        "assert float(t) == 3.0, t\n"
        "assert mesh.max_int(10 * mesh.rank) == 10\n"
        "mesh.barrier()\n"
        "print(f'rank {mesh.rank} of {mesh.size} OK', flush=True)\n"
        # As tests/test_infra.py's pod: the bootstrap is under test, not the
        # teardown, which aborted once in ~10 runs beside other ranks' load.
        "os._exit(0)\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("SKYFALL_")}
        env.update(tmesh.multihost_slot_envs(["127.0.0.1", "127.0.0.1"], port)[i])
        procs.append(subprocess.Popen([sys.executable, str(worker)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode())
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {i} of 2 OK" in out, out


def test_point_ply_writes_are_atomic_under_concurrent_loads(tmp_path):
    """Every rank's load_scene rewrites the satellite scene's points3D.ply
    while the other ranks read it: a reader sees the whole file, never a
    truncated one (a 1.5 s stress of one writer and one reader thread)."""
    import time

    from skyfall_gs_tpu_torch.io.ply import read_ply
    from skyfall_gs_tpu_torch.io.readers import store_point_ply

    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(20000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (20000, 3)).astype(np.uint8)
    path = str(tmp_path / "points3D.ply")
    store_point_ply(path, xyz, rgb)
    stop, errors, reads = time.monotonic() + 1.5, [], []

    def writer():
        while time.monotonic() < stop:
            store_point_ply(path, xyz, rgb)

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    while time.monotonic() < stop:
        try:
            reads.append(len(read_ply(path)["x"]))
        except ValueError as e:
            errors.append(str(e))
    th.join(10.0)
    assert not th.is_alive() and not errors, errors[:3]
    assert len(reads) > 10 and set(reads) == {20000}
    assert sorted(os.listdir(tmp_path)) == ["points3D.ply"]

