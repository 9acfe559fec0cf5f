"""Port parity: compositing.

The port's plain versions of the two kernels (composite_fwd_torch and
composite_bwd_torch, which the CPU path of composite_tiled runs) are held
against the JAX package's Pallas composite (interpret mode, as
tests/conftest.py forces) and its O(HWN) oracle, on the cases of
tests/test_rasterizer.py::TestTiledParity.

Tolerances:
  * forward: 1e-5 absolute, except at pixels where a threshold decision
    (alpha >= 1/255, T >= 1e-4) flips between two float32 roundings of the
    same product — the JAX kernel forms T as exp(cumsum(log)) — where the
    repo's 1e-2 applies; such pixels must stay rare (<= 1%);
  * per-gaussian gradients, AbsGS included: 1e-3 norm-relative per field;
  * composite_bwd_torch (the per-gaussian gradient of the table) against
    torch autograd through composite_fwd_torch: 1e-4 norm-relative per
    column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.ops.projection import project_gaussians
from skyfall_gs_tpu.ops.rasterize_ref import composite_reference as jref
from skyfall_gs_tpu.ops.rasterize_tiled import composite_tiled as jtiled
from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt
from skyfall_gs_tpu_torch.ops.rasterize import rasterize as trasterize
from skyfall_gs_tpu_torch.ops.rasterize_ref import composite_reference as tref
from tests.conftest import make_random_splats, make_test_camera
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
DIFF = ("mean2d", "conic", "opacity", "channels", "abs")


def screen_splats(rng, n=80, width=32, height=32, spread=0.8):
    """Projected splats as numpy, with 7 random blend channels."""
    d = make_random_splats(rng, n, spread=spread)
    p = project_gaussians(d["means3d"], d["scales"], d["quats"], d["opacities"],
                          make_test_camera(width, height))
    s = {k: np.array(getattr(p, k)) for k in
         ("mean2d", "conic", "depth", "radius", "opacity", "radius_xy")}
    s["channels"] = rng.uniform(-1, 1, (n, 7)).astype(np.float32)
    s["abs"] = np.zeros((n, 2), np.float32)
    return s


def jax_composite(fn, s, h, w, wout, wt, offset=None, tiled=True):
    """JAX forward and gradients of sum(out * wout) + sum(T_final * wt)."""
    def loss(mean2d, conic, opacity, channels, abs_dummy):
        kw = dict(mean2d_abs_dummy=abs_dummy, radius_xy=jnp.asarray(s["radius_xy"])) \
            if tiled else {}
        out, tfin, *_ = fn(mean2d, conic, jnp.asarray(s["depth"]), jnp.asarray(s["radius"]),
                           opacity, channels, h, w, offset, **kw)
        return jnp.sum(out * wout) + jnp.sum(tfin * wt), (out, tfin)

    (_, (out, tfin)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*[jnp.asarray(s[k]) for k in DIFF])
    return np.asarray(out), np.asarray(tfin), dict(zip(DIFF, map(np.asarray, grads)))


def port_composite(s, h, w, wout, wt, offset=None, tiled=True):
    xs = {k: torch.from_numpy(s[k]).requires_grad_() for k in DIFF}
    off = None if offset is None else torch.from_numpy(offset)
    if tiled:
        out, tfin, overflow = rt.composite_tiled(
            xs["mean2d"], xs["conic"], torch.from_numpy(s["depth"]),
            torch.from_numpy(s["radius"]), xs["opacity"], xs["channels"], h, w,
            subpixel_offset=off, mean2d_abs_dummy=xs["abs"], cap=8192,
            radius_xy=torch.from_numpy(s["radius_xy"]))
        assert int(overflow) == 0
    else:
        out, tfin = tref(xs["mean2d"], xs["conic"], torch.from_numpy(s["depth"]),
                         torch.from_numpy(s["radius"]), xs["opacity"], xs["channels"],
                         h, w, off)
    (torch.sum(out * torch.from_numpy(wout)) + torch.sum(tfin * torch.from_numpy(wt))
     ).backward()
    grads = {k: (np.zeros_like(s[k]) if x.grad is None else x.grad.numpy())
             for k, x in xs.items()}
    return out.detach().numpy(), tfin.detach().numpy(), grads


def assert_forward_close(port, ref):
    diff = np.abs(port - ref)
    assert diff.max() <= 1e-2, diff.max()
    assert (diff > 1e-5).mean() <= 0.01, (diff > 1e-5).mean()


def assert_grads_close(port, ref, tol, keys=DIFF):
    for k in keys:
        assert np.isfinite(port[k]).all(), k
        den = max(np.linalg.norm(ref[k]), 1e-30)
        assert np.linalg.norm(port[k] - ref[k]) / den <= tol, (k, np.linalg.norm(
            port[k] - ref[k]) / den)


def readout_weights(rng, h, w):
    return (rng.normal(0, 1, (h, w, 7)).astype(np.float32),
            rng.normal(0, 1, (h, w)).astype(np.float32))


@pytest.fixture(scope="module")
def tiled_case():
    """One 32x32 scene with subpixel offsets through the JAX Pallas
    composite (interpret mode) — shared, it is the slow reference."""
    rng = np.random.default_rng(3)
    s = screen_splats(rng)
    wout, wt = readout_weights(rng, 32, 32)
    offset = rng.uniform(-0.5, 0.5, (32, 32, 2)).astype(np.float32)
    ref = jax_composite(jtiled, s, 32, 32, wout, wt, jnp.asarray(offset))
    return s, wout, wt, offset, ref


def test_forward_matches_jax_tiled_with_subpixel_offsets(tiled_case):
    s, wout, wt, offset, (out_j, tf_j, _) = tiled_case
    out, tfin, _ = port_composite(s, 32, 32, wout, wt, offset)
    assert_forward_close(out, out_j)
    assert_forward_close(tfin, tf_j)
    assert np.abs(out).max() > 0.1


def test_gradients_match_jax_tiled_including_absgs(tiled_case):
    s, wout, wt, offset, (_, _, g_j) = tiled_case
    _, _, g = port_composite(s, 32, 32, wout, wt, offset)
    assert np.abs(g_j["abs"]).max() > 0
    assert_grads_close(g, g_j, 1e-3)


@pytest.mark.parametrize("w,h", [(32, 32), (40, 24)])   # and a ragged tile edge
def test_matches_jax_reference_forward_and_gradients(rng, w, h):
    s = screen_splats(rng, 60, w, h)
    wout, wt = readout_weights(rng, h, w)
    out_j, tf_j, g_j = jax_composite(jref, s, h, w, wout, wt, tiled=False)
    out, tfin, g = port_composite(s, h, w, wout, wt)
    assert out.shape == (h, w, 7) and tfin.shape == (h, w)
    assert_forward_close(out, out_j)
    assert_forward_close(tfin, tf_j)
    assert_grads_close(g, g_j, 1e-3, keys=DIFF[:4])
    # The port's oracle is the same algorithm as JAX's: tighter.
    out_r, tf_r, g_r = port_composite(s, h, w, wout, wt, tiled=False)
    np.testing.assert_allclose(out_r, out_j, atol=1e-5)
    np.testing.assert_allclose(tf_r, tf_j, atol=1e-5)
    assert_grads_close(g_r, g_j, 1e-4, keys=DIFF[:4])


def test_backward_rows_equal_autograd_through_plain_forward(rng):
    s = screen_splats(rng, 80)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    table, binned, offx, offy = rt.composite_inputs(
        t["mean2d"], t["conic"], t["depth"], t["radius"], t["opacity"], t["channels"],
        32, 32, cap=4096, radius_xy=t["radius_xy"])
    table = table.detach().requires_grad_()
    args = (binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy)
    out, tfin = rt.composite_fwd_torch(table, *args, 2)
    dout = torch.from_numpy(rng.normal(0, 1, tuple(out.shape)).astype(np.float32))
    dtfin = torch.from_numpy(rng.normal(0, 1, tuple(tfin.shape)).astype(np.float32))
    (torch.sum(out * dout) + torch.sum(tfin * dtfin)).backward()
    grad = rt.composite_bwd_torch(table.detach(), *args, out.detach(), tfin.detach(),
                                  dout, dtfin, 2)
    assert grad.shape == table.shape
    for c in list(range(7)) + list(range(8, 14)):          # every real attribute
        ref = table.grad[:, c]
        assert float((grad[:, c] - ref).norm() / ref.norm()) <= 1e-4, c
    assert (grad[:, 7] == 0).all() and (grad[:, 14:] >= 0).all()
    assert (grad[-1] == 0).all()                              # the dummy row


def test_multichunk_mixed_sign_gradients():
    """384 low-opacity entries in one tile with a mixed-sign cotangent: the
    running Q is not monotone and must be carried exactly."""
    rng = np.random.default_rng(5)
    s = screen_splats(rng, 384, 16, 16, spread=0.35)
    s["opacity"] = rng.uniform(0.02, 0.08, 384).astype(np.float32)
    wout = np.where(rng.uniform(size=(16, 16, 7)) < 0.5, -1.0, 1.0).astype(np.float32)
    wt = rng.normal(0, 1, (16, 16)).astype(np.float32)
    _, _, g_j = jax_composite(jref, s, 16, 16, wout, wt, tiled=False)
    out, _, g = port_composite(s, 16, 16, wout, wt)
    assert int((s["radius"] > 0).sum()) > 256
    assert_grads_close(g, g_j, 1e-3, keys=DIFF[:4])


def test_no_resume_after_termination():
    """127 fillers bring T to ~0.0099, an ALPHA_MAX blocker terminates, and
    bright entries behind it must not be composited."""
    n_fill, n_ghost = 127, 128
    n = n_fill + 1 + n_ghost
    alpha_fill = 1.0 - np.exp(np.log(0.0099) / n_fill)
    s = dict(mean2d=np.tile(np.float32([[8.0, 8.0]]), (n, 1)),
             conic=np.tile(np.float32([[0.002, 0.0, 0.002]]), (n, 1)),
             depth=np.arange(1, n + 1, dtype=np.float32),
             radius=np.full(n, 20, np.int32),
             opacity=np.concatenate([np.full(n_fill, alpha_fill), [0.99],
                                     np.full(n_ghost, 0.5)]).astype(np.float32),
             abs=np.zeros((n, 2), np.float32))
    s["radius_xy"] = np.full((n, 2), 20, np.int32)
    s["channels"] = np.zeros((n, 7), np.float32)
    s["channels"][:n_fill + 1, :3] = 0.1
    s["channels"][n_fill + 1:, :3] = 1.0
    wout, wt = np.ones((16, 16, 7), np.float32), np.ones((16, 16), np.float32)
    out_j, tf_j, _ = jax_composite(jref, s, 16, 16, wout, wt, tiled=False)
    out, tfin, g = port_composite(s, 16, 16, wout, wt)
    np.testing.assert_allclose(out, out_j, atol=1e-5)
    np.testing.assert_allclose(tfin, tf_j, atol=1e-5)
    assert 0.009 < tfin[8, 8] < 0.011


def test_saturated_tile_early_exit_zero_gradients():
    """An opaque wall saturates every pixel of the tile after ~15 entries:
    output equals the oracle, and every entry past termination gets exactly
    zero gradient in every row."""
    n_wall, n_tail = 64, 768
    n = n_wall + n_tail
    s = dict(mean2d=np.tile(np.float32([[8.0, 8.0]]), (n, 1)),
             conic=np.tile(np.float32([[1e-4, 0.0, 1e-4]]), (n, 1)),
             depth=np.arange(1, n + 1, dtype=np.float32),
             radius=np.full(n, 30, np.int32), radius_xy=np.full((n, 2), 30, np.int32),
             opacity=np.full(n, 0.5, np.float32), abs=np.zeros((n, 2), np.float32),
             channels=np.tile(np.float32([[0.3, 0.6, 0.9, 1.0, 0.1, 0.2, 0.3]]), (n, 1)))
    wout, wt = np.ones((16, 16, 7), np.float32), np.ones((16, 16), np.float32)
    out_j, tf_j, _ = jax_composite(jref, s, 16, 16, wout, wt, tiled=False)
    out, tfin, g = port_composite(s, 16, 16, wout, wt)
    np.testing.assert_allclose(out, out_j, atol=1e-4)
    np.testing.assert_allclose(tfin, tf_j, atol=1e-6)
    for k in DIFF:
        assert np.isfinite(g[k]).all()
        assert (g[k][n_wall:] == 0).all(), k
    assert np.abs(g["opacity"][:16]).max() > 0


def _rasterize_grads(rng, mask=None):
    jcam, tcam = cameras(32, 32)
    d = make_random_splats(rng, 60)
    args = [torch.from_numpy(np.array(d[k])).requires_grad_() for k in
            ("means3d", "scales", "quats", "opacities", "colors")]
    dummies = [torch.zeros((60, 2), requires_grad=True) for _ in range(2)]
    out = trasterize(*args, tcam, bg=torch.zeros(3), mask=mask,
                     mean2d_dummy=dummies[0], mean2d_abs_dummy=dummies[1])
    (torch.sum(out.color ** 2) + torch.sum(out.depth ** 2) * 1e-3).backward()
    return out, args, dummies


def test_absgs_gradients_nonnegative_and_bound_signed(rng):
    _, _, (signed, absd) = _rasterize_grads(rng)
    signed, absd = signed.grad.numpy(), absd.grad.numpy()
    assert (absd >= 0).all() and absd.sum() > 0
    assert (np.abs(signed) <= absd + 1e-6).all()


def test_dead_slots_get_exactly_zero_gradients(rng):
    mask = torch.ones(60, dtype=torch.bool)
    mask[::4] = False
    out, args, dummies = _rasterize_grads(rng, mask)
    assert int(out.radii[~mask].abs().sum()) == 0
    for x in args + dummies:
        assert torch.isfinite(x.grad).all()
        assert (x.grad[~mask] == 0).all()
    assert float(args[0].grad[mask].abs().max()) > 0


def test_wrappers_take_the_plain_version_on_cpu_tensors(rng):
    s = screen_splats(rng, 40)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    table, binned, offx, offy = rt.composite_inputs(
        t["mean2d"], t["conic"], t["depth"], t["radius"], t["opacity"], t["channels"],
        32, 32, cap=4096, radius_xy=t["radius_xy"])
    args = (table, binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy)
    before = (rt.composite_fwd.launches, rt.composite_bwd.launches)
    out, tfin = rt.composite_fwd(*args, 2)
    ref = rt.composite_fwd_torch(*args, 2)
    assert torch.equal(out, ref[0]) and torch.equal(tfin, ref[1])
    dout, dtfin = torch.ones_like(out), torch.ones_like(tfin)
    assert torch.equal(rt.composite_bwd(*args, out, tfin, dout, dtfin, 2),
                       rt.composite_bwd_torch(*args, out, tfin, dout, dtfin, 2))
    # Only a kernel launch counts, and none happened.
    assert (rt.composite_fwd.launches, rt.composite_bwd.launches) == before
