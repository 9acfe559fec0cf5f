"""The projection kernels themselves (``csrc/projection.cu`` through
``ops/projection.py`` ``project_gaussians``).

The CUDA tests need a card and skip without one; run them on a GPU machine
with

    python -m pytest --noconftest -m cuda tests/test_torch_projection_kernel.py

(this file imports neither JAX nor the JAX package).  Each case runs the
kernels and the plain float32 version against the plain version in float64
(``chip_smoke.projection_check``), every float output and the gradients of
all four inputs (``chip_smoke.projection_failures``): per field, the mean
and the 99th and 99.99th percentiles of the splats' errors (sets of 10,000
splats or more) at most twice the plain version's plus 1e-6 of the field's
largest magnitude, the largest error at most twice the plain version's
plus 0.1 of it (the worst-conditioned splat of a set sets it); finite
wherever the plain version is; no gradient on a culled splat's mean;
radius and radius_xy equal except within float32 rounding of an edge, on
at most 2e-4 of the splats.
"""

import os
import sys

import numpy as np
import pytest
import torch

from skyfall_gs_tpu_torch.core.camera import camera_from_c2w, look_at_c2w
from skyfall_gs_tpu_torch.ops import projection as P

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (phase 15's inputs, float64 check and bounds)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _camera(size, eye, dev):
    fov = np.deg2rad(60.0)
    return camera_from_c2w(look_at_c2w(eye, [0.0, 0.0, 0.0]), fov, fov, size, size, device=dev)


def _splats(dev, means, scales, quats, opacities, alive=None) -> dict:
    n = len(means)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return {"means": f32(means), "scales": f32(scales), "quats": f32(quats),
            "opacities": f32(opacities),
            "alive": torch.tensor(np.ones(n, bool) if alive is None else alive, device=dev)}


def _random(rng, n, spread=0.8, scale_mu=-2.2):
    return [rng.normal(0, spread, (n, 3)), np.exp(rng.normal(scale_mu, 0.4, (n, 3))),
            rng.normal(0, 1, (n, 4)), 1.0 / (1.0 + np.exp(-rng.normal(0, 1, n)))]


def _quat(m):
    """wxyz of a proper rotation matrix."""
    w = np.sqrt(max(0.0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1 + m[0, 0] - m[1, 1] - m[2, 2])) / 2, m[2, 1] - m[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1 - m[0, 0] + m[1, 1] - m[2, 2])) / 2, m[0, 2] - m[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1 - m[0, 0] - m[1, 1] + m[2, 2])) / 2, m[1, 0] - m[0, 1])
    return [w, x, y, z]


def edge_case(name: str, dev):
    """(camera, splats) of the plain version's CPU tests, built from scales and
    quaternions: the cases and the mask, culled and degenerate splats, thin
    splats, a view-aligned singular covariance, scales past 1e4."""
    rng = np.random.default_rng(5)
    if name == "cases_and_mask":
        means = [[0, 0, 0], [0, -10.0, 0], [0.3, 0.2, -0.1], [0, 0, 0]]
        return _camera(64, (0.0, -5.0, 0.0), dev), _splats(
            dev, means, [[0.05] * 3, [0.05] * 3, [0.5] * 3, [1e-4] * 3], [[1, 0, 0, 0]] * 4,
            [1.0, 1.0, 0.7, 1.0], alive=[True, True, False, True])
    if name == "dead_behind_near_plane":
        means, scales, quats, opac = _random(rng, 16)
        means[0] = [0.0, -3.0, 0.0]                # at the camera centre: z = 0
        means[1] = [0.0, -3.0 + 1e-7, 0.0]         # an epsilon in front of it
        means[2] = [0.0, -10.0, 0.0]               # behind it, with a huge scale
        scales[2] = 1e9
        means[4] = [0.0, -2.8, 0.0]                # at the near plane (z = 0.2)
        alive = np.ones(16, bool)
        alive[3] = False
        return _camera(32, (0.0, -3.0, 0.0), dev), _splats(dev, means, scales, quats, opac, alive)
    if name == "thin":
        thin = np.exp(np.float32([-2.0, -6.0, -10.0, -14.0, -20.0, -27.6, -40.0]))
        n = len(thin)
        scales = np.stack([np.full(n, 0.5), np.full(n, 0.5), thin], 1)
        return _camera(64, (0.0, -5.0, 0.0), dev), _splats(
            dev, np.zeros((n, 3)), scales, [[0.9238795, 0.0, 0.3826834, 0.0]] * n, np.ones(n))
    if name == "singular":
        # Sigma's view-space form [[1, 1, 0], [1, 1, 0], [0, 0, 1e-4]] (and a
        # near-singular twin): det0 cancels to ~0 at the view's centre.
        cam = _camera(64, (0.0, -5.0, 0.0), dev)
        r_view = cam.world_view[:3, :3].cpu().numpy().astype(np.float64)
        axes = np.array([[1, 1, 0], [-1, 1, 0], [0, 0, np.sqrt(2)]]).T / np.sqrt(2)
        q = _quat(r_view.T @ axes)
        return cam, _splats(dev, np.zeros((2, 3)), [[np.sqrt(2), 0.0, 0.01],
                                                    [np.sqrt(2), 1e-20, 0.01]], [q, q], [1.0, 1.0])
    if name == "huge_scales":
        means, scales, quats, opac = _random(rng, 8)
        scales[0] = [1e5, 0.05, 0.05]
        scales[1] = [1e4, 1e4, 1e-3]               # exactly at the clamp: the gradient passes
        scales[2] = [2e4, 2e4, 2e4]
        scales[3] = [1e4, 3e4, 0.1]
        quats[4] = 0.0                             # a zero quaternion
        return _camera(64, (0.0, -5.0, 0.0), dev), _splats(dev, means, scales, quats, opac)
    raise ValueError(name)


@pytest.mark.cuda
def test_a_million_random_splats_against_float64_on_the_card():
    dev = _card()
    s = cs.projection_splats(torch, 1_000_000, seed=7, device=dev)
    for i, cam in enumerate(cs.projection_cameras(dev)):
        res = cs.projection_check(torch, cam, s, seed=i)
        assert not cs.projection_failures(res), res


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cases_and_mask", "dead_behind_near_plane", "thin",
                                  "singular", "huge_scales"])
def test_edge_cases_against_float64_on_the_card(name):
    cam, s = edge_case(name, _card())
    res = cs.projection_check(torch, cam, s, seed=0)
    assert not cs.projection_failures(res), res


@pytest.mark.cuda
def test_isotropic_splats_get_no_quaternion_gradient_on_the_card():
    """Identity quaternions and equal scales (``create_from_points``'s
    initial splats): the exact gradient of the quaternions is 0, and both
    versions give exactly 0 (the kernel's R^T (G + G^T) R is symmetric bit
    for bit), as the card-against-CPU step of ``chip_smoke.py`` needs."""
    dev = _card()
    rng = np.random.default_rng(11)
    n = 4096
    cam = _camera(64, (0.0, -5.0, 0.0), dev)
    scales = np.repeat(np.exp(rng.normal(-2.0, 0.5, (n, 1))), 3, axis=1)
    s = _splats(dev, rng.normal(0, 0.8, (n, 3)), scales, [[1, 0, 0, 0]] * n,
                rng.uniform(0.1, 1.0, n))
    weights = {k: torch.from_numpy(rng.normal(0, 1, (n, 2) if k == "mean2d" else (n, 3)
                                              if k == "conic" else (n,))).to(dev)
               for k in cs.PROJ_FIELDS}
    for fn in (P.project_gaussians, P.project_gaussians_torch):
        _, grads = cs.projection_run(torch, fn, cam, s, torch.float32, weights)
        assert bool((grads[2] == 0).all()), float(grads[2].abs().max())
        assert float(grads[1].abs().max()) > 0


@pytest.mark.cuda
def test_routing_launch_counts_and_input_checks_on_the_card():
    dev = _card()
    cam, s = edge_case("dead_behind_near_plane", dev)
    xs = [s[k] for k in cs.PROJ_INPUTS]
    fwd, bwd = P.project_gaussians.launches, P.project_gaussians.backward_launches
    with torch.no_grad():
        got = P.project_gaussians(*xs, cam)            # no mask: every splat alive
    want = P.project_gaussians_torch(*xs, cam)
    assert (P.project_gaussians.launches, P.project_gaussians.backward_launches) == (fwd + 1, bwd)
    for f in ("mean2d", "conic", "depth", "opacity", "compensation"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-5)
    assert torch.equal(got.radius, want.radius) and torch.equal(got.radius_xy, want.radius_xy)
    assert got.radius.dtype == got.radius_xy.dtype == torch.int32
    leaf = xs[0].detach().requires_grad_()
    P.project_gaussians(leaf, *xs[1:], cam, mask=s["alive"]).mean2d.sum().backward()
    assert (P.project_gaussians.launches, P.project_gaussians.backward_launches) == (
        fwd + 2, bwd + 1)
    assert bool(torch.isfinite(leaf.grad).all())
    cov3d = torch.eye(3, device=dev).expand(len(xs[0]), 3, 3) * 0.01
    P.project_gaussians(*xs, cam, cov3d=cov3d)         # a given cov3d: the plain version
    assert P.project_gaussians.launches == fwd + 2
    with pytest.raises(ValueError, match="float32"):
        P.project_gaussians(xs[0].double(), *xs[1:], cam)
    with pytest.raises(ValueError, match="bool"):
        P.project_gaussians(*xs, cam, mask=s["alive"].int())
    with pytest.raises(ValueError, match="camera.world_view"):
        P.project_gaussians(*xs, cam.to("cpu"))
    assert P.project_gaussians.launches == fwd + 2
    torch.cuda.synchronize()
