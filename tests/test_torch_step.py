"""Port parity: losses, SSIM, Adam, densification statistics and the
Stage-1 training step.

One step runs from an identical state (create_from_points in JAX, carried
across with state_from_numpy) at 32x32, SH degree 3, depth loss on:
  * loss and metrics: 1e-5 relative;
  * per-field gradients and the screen-space (AbsGS) gradients: 1e-3
    norm-relative;
  * densification accumulators: 1e-3 relative (visibility counts exact);
  * post-step parameters on the elements whose JAX gradient exceeds 1e-3 of
    its field's largest: Adam's first step is lr * sign(g), so a gradient
    near 0 may flip sign between two float32 roundings.
A two-step run with ray jitter and offset-resampled GT takes its offsets
from the JAX step's own key stream, handed to the port as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import OptimizationConfig
from skyfall_gs_tpu.model import densify as jdensify
from skyfall_gs_tpu.model import optim as joptim
from skyfall_gs_tpu.model import gaussians as jg
from skyfall_gs_tpu.model.gaussians import create_from_points
from skyfall_gs_tpu.ops import losses as jlosses
from skyfall_gs_tpu.ops.ssim import ssim as jssim
from skyfall_gs_tpu.train import step as jstep
from skyfall_gs_tpu_torch.model import densify as tdensify
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model import optim as toptim
from skyfall_gs_tpu_torch.model.render import render as trender
from skyfall_gs_tpu_torch.ops import losses as tlosses
from skyfall_gs_tpu_torch.ops.ssim import ssim as tssim
from skyfall_gs_tpu_torch.train import step as tstep
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_projection import cameras

torch.set_num_threads(1)
H = W = 32
XYZ_LR, LAMBDA_OPACITY = 1.6e-4, 0.01
AUX = ("grad_accum", "grad_accum_abs", "grad_accum_abs_max", "denom", "max_radii2d")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_rel(a, b, tol):
    assert np.isfinite(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)).all()
    assert rel(a, b) <= tol, rel(a, b)


# ----------------------------------------------------------------------------
# Losses, SSIM, Adam and densification statistics
# ----------------------------------------------------------------------------

def test_losses_values_and_gradients(rng):
    img = rng.uniform(0, 1, (3, 24, 20)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 24, 20)).astype(np.float32)
    d_gt = rng.uniform(1, 5, (24, 20)).astype(np.float32)
    d = rng.uniform(1, 5, (24, 20)).astype(np.float32)
    d_gt[0, :3] = [np.nan, np.inf, -np.inf]
    opac = rng.uniform(0, 1, 50).astype(np.float32)
    alive = rng.uniform(size=50) < 0.7

    def jall(img, d, opac):
        photo, l1 = jlosses.photometric_loss(img, jnp.asarray(gt), 0.2)
        return (photo, l1, jssim(img, jnp.asarray(gt)), jlosses.psnr(img, jnp.asarray(gt)),
                jlosses.depth_pearson_loss(jnp.asarray(d_gt), d),
                jlosses.opacity_entropy_loss(opac, jnp.asarray(alive)),
                jlosses.opacity_entropy_loss(opac))

    ref = jall(jnp.asarray(img), jnp.asarray(d), jnp.asarray(opac))
    jgrads = jax.grad(lambda *xs: sum(jall(*xs)), argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(d), jnp.asarray(opac))
    xs = [_t(v).requires_grad_() for v in (img, d, opac)]
    photo, l1 = tlosses.photometric_loss(xs[0], _t(gt), 0.2)
    port = (photo, l1, tssim(xs[0], _t(gt)), tlosses.psnr(xs[0], _t(gt)),
            tlosses.depth_pearson_loss(_t(d_gt), xs[1]),
            tlosses.opacity_entropy_loss(xs[2], torch.from_numpy(alive)),
            tlosses.opacity_entropy_loss(xs[2]))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(float(p.detach()), float(r), rtol=1e-5)
    sum(port).backward()
    for x, g in zip(xs, jgrads):
        assert_rel(x.grad, g, 1e-4)


def test_resample_with_offset_matches(rng):
    img = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    off = rng.uniform(-0.5, 0.5, (20, 24, 2)).astype(np.float32)
    ref = jstep.resample_with_offset(jnp.asarray(img), jnp.asarray(off))
    np.testing.assert_allclose(tstep.resample_with_offset(_t(img), _t(off)).numpy(),
                               np.asarray(ref), atol=1e-5)


def _params(mod, arrays):
    return (jg if mod is joptim else tg).GaussianParams(**arrays)


def test_adam_three_steps_in_place(rng):
    shapes = dict(xyz=(30, 3), features_dc=(30, 1, 3), features_rest=(30, 15, 3),
                  scaling=(30, 3), rotation=(30, 4), opacity=(30, 1))
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    cfg = OptimizationConfig()
    jp = _params(joptim, {k: jnp.asarray(v) for k, v in p0.items()})
    jst = joptim.adam_init(jp)
    tp = _params(toptim, {k: _t(v) for k, v in p0.items()})
    tst = toptim.adam_init(tp)
    for i in range(3):
        g = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
        jp, jst = joptim.adam_update(_params(joptim, {k: jnp.asarray(v) for k, v in g.items()}),
                                     jst, jp, joptim.make_lr_tree(jp, cfg, 1e-3),
                                     weight_decay_tree=joptim.make_weight_decay_tree(jp, cfg))
        toptim.adam_update(_params(toptim, {k: _t(v) for k, v in g.items()}), tst, tp,
                           toptim.make_lr_tree(tp, cfg, 1e-3),
                           weight_decay_tree=toptim.make_weight_decay_tree(tp, cfg))
    for k in shapes:
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   atol=1e-6)
        assert_rel(getattr(tst.mu, k), getattr(jst.mu, k), 1e-5)
        assert_rel(getattr(tst.nu, k), getattr(jst.nu, k), 1e-5)
    assert tst.count == int(jst.count) == 3


def test_densification_stats_in_place(rng):
    st = create_from_points(rng.normal(0, 1, (40, 3)), rng.uniform(0, 1, (40, 3)),
                            capacity=64)
    aux_j = st.aux
    port = tg.state_from_numpy(jax_state_to_numpy(st))
    for _ in range(2):
        g = rng.normal(0, 1e-3, (64, 2)).astype(np.float32)
        ga = np.abs(g) + rng.uniform(0, 1e-3, (64, 2)).astype(np.float32)
        radii = rng.integers(0, 5, 64).astype(np.int32)
        aux_j = jdensify.add_densification_stats(aux_j, jnp.asarray(g), jnp.asarray(ga),
                                                 jnp.asarray(radii), 48, 32)
        tdensify.add_densification_stats(port.aux, _t(g), _t(ga), torch.from_numpy(radii),
                                         48, 32)
    for k in AUX:
        np.testing.assert_allclose(getattr(port.aux, k).numpy(), np.asarray(getattr(aux_j, k)),
                                   rtol=1e-6)


# ----------------------------------------------------------------------------
# The training step
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    n, cap = 80, 96
    st = create_from_points(rng.normal(0, 0.8, (n, 3)).astype(np.float32),
                            rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)
    rest = np.zeros((cap, 15, 3), np.float32)
    rest[:n] = rng.normal(0, 0.1, (n, 15, 3))
    st = st.replace(active_sh_degree=3,
                    params=st.params.replace(features_rest=jnp.asarray(rest)),
                    aux=st.aux.replace(filter_3d=jnp.full(cap, 0.05)))
    mask = np.ones((H, W), np.float32)
    mask[:4] = 0.0
    view = (rng.uniform(0, 1, (H, W, 3)).astype(np.float32), mask,
            rng.uniform(1, 5, (H, W)).astype(np.float32))
    jcam, tcam = cameras(W, H)
    return st, jcam, tcam, view


def port_state(st):
    return tg.state_from_numpy(jax_state_to_numpy(st))


def test_step_gradients_match(scene):
    st, jcam, tcam, view = scene
    cfg = OptimizationConfig()
    loss_j, aux_j, g_j, (gd_j, ga_j) = jax.jit(jstep._build_grads_fn(cfg, use_depth=True))(
        st, jcam, *map(jnp.asarray, view), jnp.zeros(3), jax.random.PRNGKey(0),
        LAMBDA_OPACITY)
    loss, aux, g, (gd, ga) = tstep._build_grads_fn(cfg, use_depth=True)(
        port_state(st), tcam, *map(_t, view), torch.zeros(3), LAMBDA_OPACITY)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in ("l1", "depth_loss", "opacity_loss", "psnr"):
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]), rtol=1e-5)
    assert float(aux_j["depth_loss"]) > 0
    np.testing.assert_array_equal(aux["radii"].numpy(), np.asarray(aux_j["radii"]))
    for k, v in tg.flat_fields(g):
        assert_rel(v, getattr(g_j, k), 1e-3)
        assert float(v[80:].abs().max()) == 0.0, k   # dead slots
    assert_rel(gd, gd_j, 1e-3)
    assert_rel(ga, ga_j, 1e-3)


def _masked_params_close(port, ref, grads, atol=None):
    for k, _ in tg.flat_fields(port):
        g = np.abs(np.asarray(getattr(grads, k)))
        sel = g > 1e-3 * g.max()
        np.testing.assert_allclose(getattr(port, k).numpy()[sel],
                                   np.asarray(getattr(ref, k))[sel],
                                   atol=2e-6 if atol is None else getattr(atol, k))


def test_one_step_matches(scene):
    st, jcam, tcam, view = scene
    cfg = OptimizationConfig()
    ts_j = jstep.init_train_state(jax.tree.map(jnp.copy, st))
    ts_j, m_j = jstep.make_train_step(cfg, use_depth=True)(
        ts_j, jcam, *map(jnp.asarray, view), jnp.zeros(3), jax.random.PRNGKey(0),
        XYZ_LR, LAMBDA_OPACITY)
    ts = tstep.init_train_state(port_state(st))
    ts, m = tstep.make_train_step(cfg, use_depth=True)(
        ts, tcam, *map(_t, view), torch.zeros(3), XYZ_LR, LAMBDA_OPACITY)
    for k in ("loss", "l1", "depth_loss", "opacity_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(m, k)), float(getattr(m_j, k)), rtol=1e-5)
    assert int(m.n_alive) == int(m_j.n_alive) == 80 and int(m.overflow) == 0
    assert ts.step == int(ts_j.step) == 1 and ts.opt.count == 1
    for k in AUX:
        np.testing.assert_allclose(getattr(ts.model.aux, k).numpy(),
                                   np.asarray(getattr(ts_j.model.aux, k)),
                                   rtol=1e-3, atol=1e-9)
    # Adam's first moment is (1 - b1) g: it carries the JAX gradient.
    mu_j = jax.tree.map(lambda x: x / 0.1, ts_j.opt.mu)
    _masked_params_close(ts.model.params, ts_j.model.params, mu_j)


def test_two_steps_with_ray_jitter_and_resampled_gt(scene):
    st, jcam, tcam, view = scene
    cfg = OptimizationConfig()
    kw = dict(use_depth=True, ray_jitter=True, resample_gt=True)
    step_j = jstep.make_train_step(cfg, **kw)
    step = tstep.make_train_step(cfg, **kw)
    ts_j = jstep.init_train_state(jax.tree.map(jnp.copy, st))
    ts = tstep.init_train_state(port_state(st))
    for i in range(2):
        key = jax.random.PRNGKey(11 + i)
        # The JAX step's own draw (train/step.py: split, then uniform - 0.5).
        _, krj = jax.random.split(key)
        offset = np.asarray(jax.random.uniform(krj, (H, W, 2), jnp.float32) - 0.5)
        ts_j, m_j = step_j(ts_j, jcam, *map(jnp.asarray, view), jnp.zeros(3), key,
                           XYZ_LR, LAMBDA_OPACITY)
        ts, m = step(ts, tcam, *map(_t, view), torch.zeros(3), XYZ_LR, LAMBDA_OPACITY,
                     subpixel_offset=_t(offset))
        np.testing.assert_allclose(float(m.loss), float(m_j.loss), rtol=1e-5 if i == 0
                                   else 1e-4)
    np.testing.assert_array_equal(ts.model.aux.denom.numpy(),
                                  np.asarray(ts_j.model.aux.denom))
    assert_rel(ts.model.aux.grad_accum, ts_j.model.aux.grad_accum, 1e-2)
    for _, v in tg.flat_fields(ts.model.params):
        assert torch.isfinite(v).all()
    # The second Adam step is m / sqrt(v) of two gradients that differ by
    # float32 rounding: hold the two-step displacement to 1% of 2 lr.
    lr = toptim.make_lr_tree(ts.model.params, cfg, XYZ_LR)
    _masked_params_close(ts.model.params, ts_j.model.params, ts_j.opt.mu,
                         atol=tg.map_fields(lambda v: 0.02 * v, lr))


def test_eval_render_is_the_forward_kernel_alone(scene):
    st, _, tcam, _ = scene
    state = port_state(st)
    out = tstep.make_eval_render()(state, tcam, torch.zeros(3))
    ref = trender(state, tcam, torch.zeros(3))
    assert not out.color.requires_grad
    np.testing.assert_array_equal(out.color.numpy(), ref.color.detach().numpy())
    np.testing.assert_array_equal(out.depth.numpy(), ref.depth.detach().numpy())


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_step_matches_jax(net):
    """The LPIPS-swapped photometric loss, (1 - l) L1 + l LPIPS, at 64 px
    with random LPIPS weights at the published widths: the JAX step with
    ``LPIPS._jitted`` against the port's with ``LPIPS.score``; loss 1e-4
    relative, gradients 1e-3 norm-relative."""
    from skyfall_gs_tpu.eval.lpips import LPIPS as JLPIPS
    from skyfall_gs_tpu_torch.eval.lpips import LPIPS as TLPIPS
    from tests.test_torch_eval import lpips_state

    size = 64
    rng = np.random.default_rng(8)
    n, cap = 300, 384
    st = create_from_points(rng.normal(0, 0.8, (n, 3)).astype(np.float32),
                            rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap)
    st = st.replace(aux=st.aux.replace(filter_3d=jnp.full(cap, 0.05)))
    view = (rng.uniform(0, 1, (size, size, 3)).astype(np.float32),
            np.ones((size, size), np.float32),
            rng.uniform(1, 5, (size, size)).astype(np.float32))
    jcam, tcam = cameras(size, size)
    backbone, lin = lpips_state(net)
    cfg = OptimizationConfig(lambda_dssim=0.4)
    loss_j, aux_j, g_j, (gd_j, _) = jax.jit(jstep._build_grads_fn(
        cfg, use_depth=True, lpips_fn=JLPIPS(net, backbone, lin)._jitted))(
        st, jcam, *map(jnp.asarray, view), jnp.zeros(3), jax.random.PRNGKey(0),
        LAMBDA_OPACITY)
    loss, aux, g, (gd, _) = tstep._build_grads_fn(
        cfg, use_depth=True, lpips_fn=TLPIPS(net, backbone, lin, device="cpu").score)(
        port_state(st), tcam, *map(_t, view), torch.zeros(3), LAMBDA_OPACITY)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(float(aux["l1"]), float(aux_j["l1"]), rtol=1e-5)
    # without the scorer the step is the L1 + SSIM one: a different loss
    plain = tstep._build_grads_fn(cfg, use_depth=True)(
        port_state(st), tcam, *map(_t, view), torch.zeros(3), LAMBDA_OPACITY)[0]
    assert abs(float(plain) - float(loss)) > 1e-2 * float(loss)
    for k, v in tg.flat_fields(g):
        assert_rel(v, getattr(g_j, k), 1e-3)
    assert_rel(gd, gd_j, 1e-3)
