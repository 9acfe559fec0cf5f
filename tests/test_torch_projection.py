"""Port parity: EWA projection values and gradients (torch autograd against
jax.grad), including the culled-input sanitizing and the bounded sqrt of
thin splats.

Tolerances: values 1e-5 relative, gradients 1e-4 relative (both to the
JAX value, with a floor of 1e-6 of the field's largest magnitude for
entries that cancel to ~0), and finite everywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.core.camera import camera_from_c2w as jcamera_from_c2w
from skyfall_gs_tpu.core.camera import look_at_c2w
from skyfall_gs_tpu.ops import projection as jproj
from skyfall_gs_tpu_torch.core.camera import camera_from_c2w as tcamera_from_c2w
from skyfall_gs_tpu_torch.core.transforms import covariance_from_scaling_rotation
from skyfall_gs_tpu_torch.ops import projection as tproj
from skyfall_gs_tpu_torch.ops.rasterize import rasterize
from skyfall_gs_tpu_torch.utils import trace

torch.set_num_threads(1)
FIELDS = ("mean2d", "conic", "depth", "opacity", "compensation")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def cameras(width=32, height=32, eye=(2.5, 1.5, 1.2), fov_deg=60.0):
    c2w = look_at_c2w(eye, [0.0, 0.0, 0.0])
    fov = np.deg2rad(fov_deg)
    return (jcamera_from_c2w(c2w, fov, fov, width, height),
            tcamera_from_c2w(c2w, fov, fov, width, height))


def _rel_close(port, ref, rtol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert np.isfinite(port).all()
    floor = 1e-6 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=floor)


def random_splats(rng, n, spread=0.8, scale_mu=-2.2):
    return dict(
        means=rng.normal(0, spread, (n, 3)).astype(np.float32),
        scales=np.exp(rng.normal(scale_mu, 0.4, (n, 3))).astype(np.float32),
        quats=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opac=(1.0 / (1.0 + np.exp(-rng.normal(0, 1, n)))).astype(np.float32),
    )


def check_projection(rng, splats, jcam, tcam, mask=None, cov3d=None):
    """Values and the gradient of a random linear readout of every output."""
    n = splats["means"].shape[0]
    weights = {k: rng.normal(0, 1, (n, 3) if k == "conic" else
                             (n, 2) if k == "mean2d" else (n,)).astype(np.float32)
               for k in FIELDS}
    names = ("means", "scales", "quats", "opac")
    kw = dict(kernel_size=0.1)

    def jloss(*xs):
        p = jproj.project_gaussians(*xs, jcam, mask=None if mask is None else
                                    jnp.asarray(mask), **kw)
        return sum(jnp.sum(getattr(p, k) * weights[k]) for k in FIELDS), p

    (_, jp), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                                 has_aux=True))(
        *[jnp.asarray(splats[k]) for k in names])
    xs = [_t(splats[k]).requires_grad_() for k in names]
    tp = tproj.project_gaussians(*xs, tcam, mask=None if mask is None else
                                 torch.from_numpy(mask), **kw)
    sum(torch.sum(getattr(tp, k) * _t(weights[k])) for k in FIELDS).backward()

    for k in FIELDS:
        _rel_close(getattr(tp, k), getattr(jp, k), 1e-5)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    np.testing.assert_array_equal(tp.radius_xy.numpy(), np.asarray(jp.radius_xy))
    for x, g in zip(xs, jgrads):
        _rel_close(x.grad, g, 1e-4)
    return tp


def test_random_splats(rng):
    jcam, tcam = cameras(48, 32)
    tp = check_projection(rng, random_splats(rng, 80), jcam, tcam)
    assert int((tp.radius > 0).sum()) > 40


def test_projection_cases_and_mask(rng):
    jcam, tcam = cameras(64, 64, eye=(0.0, -5.0, 0.0))
    splats = dict(
        means=np.float32([[0, 0, 0], [0, -10.0, 0], [0.3, 0.2, -0.1], [0, 0, 0]]),
        scales=np.float32([[0.05] * 3, [0.05] * 3, [0.5] * 3, [1e-4] * 3]),
        quats=np.float32([[1, 0, 0, 0]] * 4),
        opac=np.float32([1.0, 1.0, 0.7, 1.0]))
    tp = check_projection(rng, splats, jcam, tcam)
    np.testing.assert_allclose(tp.mean2d[0].detach().numpy(), [31.5, 31.5], atol=1e-3)
    assert int(tp.radius[1]) == 0                      # behind the camera
    assert float(tp.compensation[3].detach()) < 0.1    # mip compensation
    check_projection(rng, splats, jcam, tcam, mask=np.array([True, True, False, True]))


def test_nan_guards_degenerate_dead_splats(rng):
    """Splats at z = 0, an epsilon in front of the camera, behind it with a
    huge scale, and a dead slot: finite values and gradients equal JAX's."""
    jcam, tcam = cameras(32, 32, eye=(0.0, -3.0, 0.0))
    s = random_splats(rng, 16)
    s["means"][0] = [0.0, -3.0, 0.0]
    s["means"][1] = [0.0, -3.0 + 1e-7, 0.0]
    s["means"][2] = [0.0, -10.0, 0.0]
    s["scales"][2] = 1e9
    mask = np.ones(16, bool)
    mask[3] = False
    check_projection(rng, s, jcam, tcam, mask=mask)


def test_thin_splat_compensation_grads_bounded():
    jcam, tcam = cameras(64, 64, eye=(0.0, -5.0, 0.0))
    quat = np.float32([[0.9238795, 0.0, 0.3826834, 0.0]])
    log_thin = np.float32([-2.0, -6.0, -10.0, -14.0, -20.0, -27.6, -40.0])
    n = len(log_thin)

    def jcomp(lt):
        scales = jnp.stack([jnp.full_like(lt, 0.5), jnp.full_like(lt, 0.5),
                            jnp.exp(lt)], axis=-1)
        p = jproj.project_gaussians(jnp.zeros((n, 3)), scales, jnp.tile(quat, (n, 1)),
                                    jnp.ones(n), jcam, kernel_size=0.1)
        return jnp.sum(p.compensation), p.compensation

    # Eager on purpose: det0 of a thin splat is f32 cancellation noise whose
    # value depends on how XLA fuses the products; op by op, JAX rounds the
    # same operations in the same order as the port.
    (_, jc), jg = jax.value_and_grad(jcomp, has_aux=True)(jnp.asarray(log_thin))
    lt = torch.from_numpy(log_thin).requires_grad_()
    scales = torch.stack([torch.full_like(lt, 0.5), torch.full_like(lt, 0.5),
                          torch.exp(lt)], dim=-1)
    tc = tproj.project_gaussians(torch.zeros((n, 3)), scales,
                                 torch.from_numpy(quat).repeat(n, 1), torch.ones(n),
                                 tcam, kernel_size=0.1).compensation
    tc.sum().backward()
    _rel_close(tc, jc, 1e-5)
    assert torch.isfinite(lt.grad).all() and float(lt.grad.abs().max()) < 1e4
    _rel_close(lt.grad, jg, 1e-4)


def test_exact_singular_cov2d_grad_finite():
    """A view-aligned rank-deficient covariance makes det0 cancel to exactly
    0 — the old sqrt clamp boundary, where the gradient was NaN."""
    jcam, tcam = cameras(64, 64, eye=(0.0, -5.0, 0.0))
    r = np.asarray(jcam.world_view)[:3, :3]
    v_view = np.float32([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1e-4]])
    cov = (r.T @ v_view @ r).astype(np.float32)
    args = (np.zeros((1, 3), np.float32), np.full((1, 3), 0.1, np.float32),
            np.float32([[1, 0, 0, 0]]), np.ones(1, np.float32))

    jg = jax.grad(lambda c: jnp.sum(jproj.project_gaussians(
        *map(jnp.asarray, args), jcam, kernel_size=0.1, cov3d=c[None]).compensation))(
        jnp.asarray(cov))                                   # eager, as above
    c = torch.from_numpy(cov).requires_grad_()
    tproj.project_gaussians(*map(torch.from_numpy, args), tcam, kernel_size=0.1,
                            cov3d=c[None]).compensation.sum().backward()
    assert torch.isfinite(c.grad).all()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_cpu_tensors_and_a_given_cov3d_take_the_plain_version(rng, monkeypatch):
    """The routing of ``project_gaussians``: CPU tensors, and a given
    ``cov3d`` (which only these tests pass), run ``project_gaussians_torch``,
    the version the parity tests above hold against JAX; no kernel runs."""
    def no_kernel(*args):
        raise AssertionError("the kernels ran")

    monkeypatch.setattr(tproj._Projection, "apply", no_kernel)
    _, tcam = cameras(48, 32)
    s = random_splats(rng, 60)
    xs = [_t(s[k]) for k in ("means", "scales", "quats", "opac")]
    mask = torch.from_numpy(np.arange(60) % 7 != 3)
    cov3d = covariance_from_scaling_rotation(xs[1], xs[2])
    launches = (tproj.project_gaussians.launches, tproj.project_gaussians.backward_launches)
    for kw in ({}, {"mask": mask}, {"cov3d": cov3d, "mask": mask}):
        got = tproj.project_gaussians(*xs, tcam, kernel_size=0.1, **kw)
        want = tproj.project_gaussians_torch(*xs, tcam, kernel_size=0.1, **kw)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert (tproj.project_gaussians.launches,
            tproj.project_gaussians.backward_launches) == launches


def test_profiled_render_counts_the_projection_kernel_inside_its_span(rng):
    """``rasterize`` records span ``render.project`` and counter
    ``render.project.kernel`` (0 on CPU tensors) once per call; a projection
    outside the span (as ``measure_bin_capacity`` makes) adds nothing."""
    _, tcam = cameras(32, 32)
    s = random_splats(rng, 40)
    xs = [_t(s[k]) for k in ("means", "scales", "quats", "opac")]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            rasterize(*xs, torch.rand((40, 3)), tcam, torch.zeros(3))
        tproj.project_gaussians(*xs, tcam)
    rep = trace.report()
    assert rep["spans"]["render.project"]["count"] == 3
    assert rep["counters"]["render.project.kernel"] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_axis_normals(seed):
    rng = np.random.default_rng(seed)
    s = random_splats(rng, 50)
    center = np.float32([2.0, -1.0, 0.5])
    ref = jproj.smallest_axis_normals(jnp.asarray(s["scales"]), jnp.asarray(s["quats"]),
                                      jnp.asarray(s["means"]), jnp.asarray(center))
    port = tproj.smallest_axis_normals(_t(s["scales"]), _t(s["quats"]), _t(s["means"]),
                                       _t(center))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)
