"""Port parity: the Stage-2 priors (priors/interface.py, flux.py,
flux_vae.py, flowedit.py, flux_refiner.py, moge.py) against the JAX
package, at tiny widths on the CPU in float32.

Weights reach the port two ways, and both are held: the JAX parameter
pytree through each module's ``state_from_numpy``, and one random state
dict under diffusers' / MoGe's key names fed to the JAX package's
``convert_torch_state_dict`` and to the port's
``load_state_dict(strict=True)``.

Tolerances, and why:
  * FLUX velocity, VAE encode / decode, MoGe points / mask / depth: 1e-4
    norm-relative (float32, different summation orders; measured ~1e-6);
  * token packing, RoPE ids and the shifted sigmas: 1e-6 (the same float32
    formulas; the packing is a permutation, exact);
  * FlowEdit: the port's noise comes from a torch.Generator and the JAX
    package's from PRNGKey splits.  With an affine velocity
    v(z, t, c) = (z A)(1 + t) + c b the noise cancels from v_tar - v_src,
    so the edit is a function of the inputs alone: each test first asserts
    that JAX gives the same output for two seeds (1e-6), then holds the
    port to it at 1e-5;
  * the cubic positional-embedding resize: 1e-5 against jax.image.resize;
    the area and bilinear resizes: 1e-5 against OpenCV.
"""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.priors import flowedit as jfe
from skyfall_gs_tpu.priors import flux as jf
from skyfall_gs_tpu.priors import flux_vae as jv
from skyfall_gs_tpu.priors import interface as jint
from skyfall_gs_tpu.priors import moge as jm
from skyfall_gs_tpu.priors.flux_refiner import build_flux_refiner as jbuild
from skyfall_gs_tpu_torch.priors import flowedit as tfe
from skyfall_gs_tpu_torch.priors import flux as tf
from skyfall_gs_tpu_torch.priors import flux_vae as tv
from skyfall_gs_tpu_torch.priors import interface as tint
from skyfall_gs_tpu_torch.priors import moge as tm

torch.set_num_threads(1)
MOGE_CFG = dict(patch_size=14, width=32, depth=4, heads=2, img_size=56,
                out_layers=(0, 1, 2, 3), head_width=16)


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def module(cls, cfg, sd):
    m = tf.build_module(cls, cfg, device="cpu", seed=None)
    m.load_state_dict(sd, strict=True)
    return m


# ----------------------------------------------------------------------------
# Registries
# ----------------------------------------------------------------------------

def test_registries_and_backends_without_weights(rng):
    img = rng.uniform(size=(8, 6, 3)).astype(np.float32)
    assert tint.get_refiner("identity").run([img])[0] is img
    np.testing.assert_array_equal(tint.get_depth_predictor("render")(img),
                                  jint.get_depth_predictor("render")(img))
    assert list(tint.REFINER_REGISTRY) == list(jint.REFINER_REGISTRY)
    assert list(tint.DEPTH_REGISTRY) == list(jint.DEPTH_REGISTRY)
    for getter, name in ((tint.get_refiner, "diffusion"), (tint.get_depth_predictor, "midas")):
        with pytest.raises(KeyError, match="unknown"):
            getter(name)
    with pytest.raises(RuntimeError, match="velocity_fn"):
        tint.get_refiner("flowedit")
    with pytest.raises(RuntimeError, match="checkpoint_path"):
        tint.get_refiner("flowedit", checkpoint_path=None, transformer={})
    with pytest.raises(RuntimeError, match="weights"):
        tint.get_depth_predictor("moge")


# ----------------------------------------------------------------------------
# FLUX transformer
# ----------------------------------------------------------------------------

def _flux_random_sd(cfg, seed=0):
    """Random diffusers-named FluxTransformer2DModel state dict at cfg
    (tests/test_torch_oracles.py's, copied)."""
    g = torch.Generator().manual_seed(seed)
    d, hd = cfg.hidden, cfg.head_dim
    mlp = int(cfg.hidden * cfg.mlp_ratio)
    sd = {}

    def lin(p, o, i, s=None):
        s = s if s is not None else 0.4 / math.sqrt(i)
        sd[p + ".weight"] = torch.randn(o, i, generator=g) * s
        sd[p + ".bias"] = torch.randn(o, generator=g) * 0.02

    def rmsw(p):
        sd[p + ".weight"] = 1.0 + torch.randn(hd, generator=g) * 0.05

    lin("x_embedder", d, cfg.in_channels)
    lin("context_embedder", d, cfg.joint_dim)
    lin("time_text_embed.timestep_embedder.linear_1", d, cfg.time_freq_dim)
    lin("time_text_embed.timestep_embedder.linear_2", d, d)
    lin("time_text_embed.text_embedder.linear_1", d, cfg.pooled_dim)
    lin("time_text_embed.text_embedder.linear_2", d, d)
    if cfg.guidance:
        lin("time_text_embed.guidance_embedder.linear_1", d, cfg.time_freq_dim)
        lin("time_text_embed.guidance_embedder.linear_2", d, d)
    lin("norm_out.linear", 2 * d, d, s=0.02)
    lin("proj_out", cfg.in_channels, d)
    for i in range(cfg.depth_double):
        p = f"transformer_blocks.{i}"
        lin(f"{p}.norm1.linear", 6 * d, d, s=0.02)
        lin(f"{p}.norm1_context.linear", 6 * d, d, s=0.02)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                   "add_v_proj", "to_out.0"):
            lin(f"{p}.attn.{nm}", d, d)
        lin(f"{p}.attn.to_add_out", d, d)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            rmsw(f"{p}.attn.{nm}")
        lin(f"{p}.ff.net.0.proj", mlp, d)
        lin(f"{p}.ff.net.2", d, mlp)
        lin(f"{p}.ff_context.net.0.proj", mlp, d)
        lin(f"{p}.ff_context.net.2", d, mlp)
    for i in range(cfg.depth_single):
        p = f"single_transformer_blocks.{i}"
        lin(f"{p}.norm.linear", 3 * d, d, s=0.02)
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{nm}", d, d)
        rmsw(f"{p}.attn.norm_q")
        rmsw(f"{p}.attn.norm_k")
        lin(f"{p}.proj_mlp", mlp, d)
        lin(f"{p}.proj_out", d, d + mlp)
    return sd


def _flux_pair(route, guidance):
    cfg = jf.FluxConfig.tiny()._replace(guidance=guidance)
    tcfg = tf.FluxConfig(**cfg._asdict())
    if route == "carrier":
        params = jf.init_flux_params(jax.random.PRNGKey(0), cfg)
        return cfg, params, module(tf.FluxTransformer, tcfg,
                                   tf.state_from_numpy(np_tree(params), tcfg))
    sd = _flux_random_sd(cfg)
    params = jf.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    return cfg, params, module(tf.FluxTransformer, tcfg, sd)


@pytest.mark.parametrize("route", ["carrier", "state_dict"])
@pytest.mark.parametrize("guidance", [True, False], ids=["dev", "schnell"])
def test_flux_velocity_matches_jax(rng, route, guidance):
    cfg, params, model = _flux_pair(route, guidance)
    tok = rng.normal(size=(2, 12, cfg.in_channels)).astype(np.float32)
    ids = np.array(jf.pack_latents(jnp.zeros((1, 6, 8, 4)))[1])
    txt = rng.normal(size=(1, 5, cfg.joint_dim)).astype(np.float32) * 0.5
    pooled = rng.normal(size=(1, cfg.pooled_dim)).astype(np.float32) * 0.5
    t = np.asarray([0.7, 0.3], np.float32)
    want = jf.flux_velocity(params, cfg, jnp.asarray(tok), jnp.asarray(ids),
                            jf.FluxCond(jnp.asarray(txt), jnp.asarray(pooled), 3.5),
                            jnp.asarray(t))
    got = tf.flux_velocity(model, torch.from_numpy(tok), torch.from_numpy(ids),
                           tf.FluxCond(torch.from_numpy(txt), torch.from_numpy(pooled), 3.5),
                           torch.from_numpy(t))
    assert got.dtype == torch.float32 and rel(got, want) <= 1e-4, rel(got, want)


def test_flux_bf16_route_matches_jax_production_dtype():
    """The card's dtype policy against the JAX package's production one at
    full width (FluxConfig(), depth cut to 1 double + 1 single block, random
    N(0, 0.02^2) weights, an 8x8-token latent and 16 text tokens): the port
    runs bf16 activations with float32 norm statistics, RoPE, scores and
    softmax; JAX runs bf16 parameters with float32 activations.  Both hold
    the same bf16 weights; bound 3e-2 norm-relative on the velocity, the
    card's bf16-vs-fp32 bound."""
    cfg = tf.FluxConfig()._replace(depth_double=1, depth_single=1)
    m16 = tf.build_module(tf.FluxTransformer, cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    params = jf.convert_torch_state_dict(
        {k: v.float().numpy() for k, v in m16.state_dict().items()},
        jf.FluxConfig(**cfg._asdict()))
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    rng = np.random.default_rng(4)
    ids = np.array(jf.pack_latents(jnp.zeros((1, 16, 16, 4)))[1])
    tok = rng.normal(size=(1, len(ids), cfg.in_channels)).astype(np.float32)
    txt = rng.normal(size=(1, 16, cfg.joint_dim)).astype(np.float32)
    pooled = rng.normal(size=(1, cfg.pooled_dim)).astype(np.float32)
    want = jf.flux_velocity(params, jf.FluxConfig(**cfg._asdict()), jnp.asarray(tok),
                            jnp.asarray(ids), jf.FluxCond(jnp.asarray(txt),
                                                          jnp.asarray(pooled), 3.5),
                            jnp.asarray([0.6], jnp.float32))
    assert want.dtype == jnp.float32
    got = tf.flux_velocity(m16, torch.from_numpy(tok), torch.from_numpy(ids),
                           tf.FluxCond(torch.from_numpy(txt), torch.from_numpy(pooled), 3.5),
                           torch.tensor([0.6]))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert rel(got, want) <= 3e-2, rel(got, want)


def test_packing_rope_ids_and_sigmas_exact(rng):
    z = rng.normal(size=(2, 6, 10, 4)).astype(np.float32)
    tok_j, ids_j = jf.pack_latents(jnp.asarray(z))
    tok, ids = tf.pack_latents(torch.from_numpy(z))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(tf.unpack_latents(tok, 6, 10).numpy(), z)
    np.testing.assert_array_equal(tf.latent_ids(6, 10).numpy(), np.asarray(ids_j))
    cfg = jf.FluxConfig()
    all_ids = jnp.concatenate([jnp.zeros((3, 3), jnp.int32), ids_j], 0)
    for a, b in zip(tf.rope_freqs(torch.from_numpy(np.asarray(all_ids)), tf.FluxConfig()),
                    jf.rope_freqs(all_ids, cfg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for steps, seq in ((28, 4096), (28, 1024), (4, 16)):
        np.testing.assert_allclose(tf.shifted_sigmas(steps, seq).numpy(),
                                   np.asarray(jf.shifted_sigmas(steps, seq)), atol=1e-6)


def test_flux_flops_count():
    """The FLOP model holds the tiny model's linear weights exactly: every
    weight but the modulation ones (applied once per image) and the
    embedders of time, guidance and pooled text is used twice per token of
    its stream."""
    cfg = tf.FluxConfig.tiny()
    model = tf.build_module(tf.FluxTransformer, cfg, device="cpu")
    n_img, n_txt = 12, 5
    flops = 0
    for name, p in model.named_parameters():
        if p.ndim != 2 or "norm" in name or "time_text_embed" in name:
            continue
        if name.startswith("x_embedder") or name.startswith("proj_out"):
            flops += 2 * p.numel() * n_img
        elif name.startswith("context_embedder"):
            flops += 2 * p.numel() * n_txt
        elif ".ff_context." in name or ".add_" in name or "to_add_out" in name:
            flops += 2 * p.numel() * n_txt
        elif name.startswith("transformer_blocks"):
            flops += 2 * p.numel() * n_img
        else:
            flops += 2 * p.numel() * (n_img + n_txt)
    got = tf.flux_flops(cfg, n_img, n_txt)
    assert got["gemm"] == flops
    assert got["attention"] == (cfg.depth_double + cfg.depth_single) * 4 * 17 ** 2 * cfg.hidden


# ----------------------------------------------------------------------------
# FLUX VAE
# ----------------------------------------------------------------------------

def _vae_pair(route):
    cfg = jv.VAEConfig.tiny()
    tcfg = tv.VAEConfig(**cfg._asdict())
    if route == "carrier":
        params = jv.init_vae_params(jax.random.PRNGKey(1), cfg)
        return cfg, params, module(tv.VAE, tcfg, tv.state_from_numpy(np_tree(params), tcfg))
    g = torch.Generator().manual_seed(4)
    with torch.device("meta"):
        keys = tv.VAE(tcfg).state_dict()
    sd = {k: (torch.randn(v.shape, generator=g) * (0.3 if v.ndim > 1 else 0.1)
              + (1.0 if k.endswith("norm1.weight") or k.endswith("norm2.weight") else 0.0))
          for k, v in keys.items()}
    params = jv.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    return cfg, params, module(tv.VAE, tcfg, sd)


@pytest.mark.parametrize("route", ["carrier", "state_dict"])
def test_vae_encode_decode_match_jax(rng, route):
    cfg, params, vae = _vae_pair(route)
    img = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    z_j = jv.vae_encode(params, cfg, jnp.asarray(img))
    z = vae.encode(torch.from_numpy(img))
    assert tuple(z.shape) == (2, 8, 12, 4) and rel(z, z_j) <= 1e-4, rel(z, z_j)
    lat = np.array(z_j)
    x_j = jv.vae_decode(params, cfg, jnp.asarray(lat))
    x = vae.decode(torch.from_numpy(lat))
    assert tuple(x.shape) == img.shape and rel(x, x_j) <= 1e-4, rel(x, x_j)


# ----------------------------------------------------------------------------
# FlowEdit, against JAX through an affine velocity
# ----------------------------------------------------------------------------

_A = np.random.default_rng(9).normal(0, 0.3, (6, 6)).astype(np.float32)
_B = np.random.default_rng(10).normal(0, 1, 6).astype(np.float32)


def jvel(z, t, c):
    return (z @ _A) * (1.0 + t) + c * _B


def tvel(z, t, c):
    return (z @ torch.from_numpy(_A)) * (1.0 + t) + c * torch.from_numpy(_B)


def _jax_twice(fn):
    a, b = fn(jax.random.PRNGKey(0)), fn(jax.random.PRNGKey(7))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    return np.asarray(a)


@pytest.mark.parametrize("n_avg", [1, 3])
def test_flow_edit_ode_matches_jax(rng, n_avg):
    x = rng.normal(size=(5, 6)).astype(np.float32)
    sig = np.asarray(jf.shifted_sigmas(10, 300))
    for sigmas in (None, sig):
        kw = dict(num_steps=10, n_min=2, n_max=8, n_avg=n_avg, sigmas=sigmas)
        want = _jax_twice(lambda k: jfe.flow_edit_ode(jvel, jnp.asarray(x), 0.5, 2.0, k, **kw))
        got = tfe.flow_edit_ode(tvel, torch.from_numpy(x), 0.5, 2.0,
                                torch.Generator().manual_seed(0), **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert np.abs(want - x).max() > 0.1


def test_flow_edit_ode_batch_annealed_matches_jax(rng):
    x = rng.normal(size=(4, 5, 6)).astype(np.float32)
    nm = np.asarray([8, 5, 2, 0], np.int32)
    kw = dict(num_steps=10, n_min=1, n_max=8, n_avg=2)
    want = _jax_twice(lambda k: jfe.flow_edit_ode_batch(
        jvel, jnp.asarray(x), -1.0, 1.5, k, jnp.asarray(nm), **kw))
    got = tfe.flow_edit_ode_batch(tvel, torch.from_numpy(x), -1.0, 1.5,
                                  torch.Generator().manual_seed(3), nm, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), x[3])     # a zero window is a no-op


def test_identical_conditions_noop(rng):
    """tests/test_priors.py's no-op on the port: equal conditions leave
    the latent where it was, exactly (both branches see bit-identical
    inputs while the edit is zero)."""
    x = torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32))
    out = tfe.flow_edit_ode(lambda z, t, c: torch.sin(z) + c, x, 0.5, 0.5,
                            torch.Generator().manual_seed(1), num_steps=8, n_min=0,
                            n_max=8, n_avg=2)
    np.testing.assert_array_equal(out.numpy(), x.numpy())


def test_refiner_groups_mixed_shapes_and_anneals_as_jax(rng):
    shapes = [(4, 6, 6), (3, 6, 6), (4, 6, 6), (3, 6, 6), (4, 6, 6)]
    imgs = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    kw = dict(n_min=0, n_max=6, n_max_end=9, n_avg=1)
    want, other = (jfe.FlowEditRefiner(velocity_fn=jvel, src_cond=0.0, tar_cond=1.0,
                                       num_steps=10, batch_size=2, seed=s).run(imgs, **kw)
                   for s in (0, 7))
    ref = tfe.FlowEditRefiner(velocity_fn=tvel, src_cond=0.0, tar_cond=1.0, num_steps=10,
                              batch_size=2, device="cpu")
    got = ref.run(imgs, **kw)
    assert [o.shape for o in got] == shapes
    for g, w, o in zip(got, want, other):
        np.testing.assert_allclose(w, o, atol=1e-6)
        np.testing.assert_allclose(g, w, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds num_steps"):
        ref.run(imgs[:1], n_max=12)


def test_flux_refiner_matches_jax_with_equal_conditions(rng):
    """The whole refiner at tiny widths (VAE encode, packing, the
    per-shape RoPE grids and sigmas, FLUX, FlowEdit, decode): with
    src_cond == tar_cond the edit keeps the latent (up to rounding), so
    both packages return decode(encode(x)), to 1e-4; two aspect ratios of
    one token count keep their own grids."""
    cfg, vcfg = jf.FluxConfig.tiny(), jv.VAEConfig.tiny()
    params = jf.init_flux_params(jax.random.PRNGKey(0), cfg)
    vparams = jv.init_vae_params(jax.random.PRNGKey(1), vcfg)
    txt = rng.normal(0, 0.02, (1, 8, cfg.joint_dim)).astype(np.float32)
    pooled = rng.normal(0, 0.02, (1, cfg.pooled_dim)).astype(np.float32)
    jcond = jf.FluxCond(jnp.asarray(txt), jnp.asarray(pooled), 3.5)
    tcond = tf.FluxCond(torch.from_numpy(txt), torch.from_numpy(pooled), 3.5)
    jref = jbuild(transformer_params=params, vae_params=vparams, cfg=cfg, vae_cfg=vcfg,
                  num_steps=6, batch_size=2, src_cond=jcond, tar_cond=jcond)
    tref = tint.get_refiner(
        "flowedit", transformer=tf.state_from_numpy(np_tree(params), cfg),
        vae=tv.state_from_numpy(np_tree(vparams), vcfg), cfg=tf.FluxConfig(**cfg._asdict()),
        vae_cfg=tv.VAEConfig(**vcfg._asdict()), num_steps=6, batch_size=2, src_cond=tcond,
        tar_cond=tcond, device="cpu")
    assert next(tref.transformer.parameters()).dtype == torch.float32
    imgs = [rng.uniform(size=s).astype(np.float32) for s in ((8, 32, 3), (16, 16, 3),
                                                             (8, 32, 3))]
    got, want = tref.run(imgs, n_max=4), jref.run(imgs, n_max=4)
    for g, w, im in zip(got, want, imgs):
        assert g.shape == im.shape and rel(g, w) <= 1e-4, rel(g, w)
    for hw in ((8, 32), (16, 16)):
        np.testing.assert_allclose(tref.sigmas_fn(*hw).numpy(),
                                   np.asarray(jref.sigmas_fn(*hw)), atol=1e-6)


# ----------------------------------------------------------------------------
# MoGe
# ----------------------------------------------------------------------------

def _moge_pair(route):
    cfg = jm.ViTConfig(**MOGE_CFG)
    tcfg = tm.ViTConfig(**MOGE_CFG)
    if route == "carrier":
        params = jm.init_vit_params(jax.random.PRNGKey(2), cfg)
        return cfg, params, module(tm.MoGe, tcfg, tm.state_from_numpy(np_tree(params), tcfg))
    # A MoGe checkpoint under a "model." wrapper, head convolutions as
    # Sequential index 0 and the output block at indices 0 and 3.
    g = torch.Generator().manual_seed(5)
    with torch.device("meta"):
        keys = tm.MoGe(tcfg).state_dict()
    sd = {}
    for k, v in keys.items():
        val = torch.randn(v.shape, generator=g) * 0.1
        if k.endswith("norm1.weight") or k.endswith("norm2.weight") or k.endswith("gamma"):
            val = val + 1.0
        k = k.replace("output_block.2", "output_block.3")
        for part in ("projects", "upsample_blocks"):
            if f"head.{part}." in k:
                k = k[:-len(k.split(".")[-1])] + "0." + k.split(".")[-1]
        sd["model." + k] = val
    params = jm.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    return cfg, params, module(tm.MoGe, tcfg, tm.canonical_state_dict(sd, tcfg))


@pytest.mark.parametrize("route", ["carrier", "state_dict"])
def test_moge_points_and_depth_match_jax(rng, route):
    cfg, params, model = _moge_pair(route)
    img = rng.uniform(0, 1, (2, 70, 42, 3)).astype(np.float32)     # grid 5x3 from 4x4
    pts_j, mask_j = jm.moge_points(params, jnp.asarray(img), cfg)
    pts, mask = tm.moge_points(model, torch.from_numpy(img))
    assert rel(pts, pts_j) <= 1e-4 and rel(mask, mask_j) <= 1e-4, (rel(pts, pts_j),
                                                                   rel(mask, mask_j))
    depth = tm.moge_depth(model, torch.from_numpy(img))
    assert rel(depth, jm.moge_depth(params, jnp.asarray(img), cfg)) <= 1e-4
    assert bool((depth > 0).all())


def test_canonical_state_dict_rejects_a_bare_encoder():
    tcfg = tm.ViTConfig(**MOGE_CFG)
    with torch.device("meta"):
        keys = tm.MoGe(tcfg).state_dict()
    sd = {k[len("backbone."):]: torch.zeros(v.shape) for k, v in keys.items()
          if k.startswith("backbone.")}
    with pytest.raises(KeyError, match="no head"):
        tm.canonical_state_dict(sd, tcfg)


@pytest.mark.parametrize("grid", [(5, 3), (2, 7), (9, 9)])
def test_resize_pos_embed_matches_jax(rng, grid):
    pos = rng.normal(size=(1, 1 + 6 * 6, 8)).astype(np.float32)
    want = jm._resize_pos_embed(jnp.asarray(pos), grid)
    got = tm.resize_pos_embed(torch.from_numpy(pos), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("src, dst", [((100, 80), (56, 42)), ((64, 64), (32, 32)),
                                      ((20, 30), (56, 70)), ((40, 40), (40, 40)),
                                      ((33, 50), (42, 28))])
def test_resizes_match_cv2(rng, src, dst):
    img = rng.uniform(size=src + (3,)).astype(np.float32)
    for name, flag in (("area", cv2.INTER_AREA), ("linear", cv2.INTER_LINEAR)):
        want = cv2.resize(img, dst[::-1], interpolation=flag)
        got = tm.cv2_resize(torch.from_numpy(img), dst, name)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(tm.cv2_resize(torch.from_numpy(img[..., 0]), dst,
                                                 name).numpy(), want[..., 0], atol=1e-5)


def test_predictor_keeps_aspect_and_matches_jax(rng):
    cfg = jm.ViTConfig(**MOGE_CFG)
    params = jm.init_vit_params(jax.random.PRNGKey(0), cfg)
    jpred = jm.MoGePredictor(cfg=cfg, params=params)
    tpred = tint.get_depth_predictor("moge", cfg=tm.ViTConfig(**MOGE_CFG),
                                     params=np_tree(params), device="cpu")
    frames = [rng.uniform(size=(100, 400, 3)).astype(np.float32),
              rng.uniform(size=(60, 60, 3)).astype(np.float32),
              rng.uniform(size=(30, 20, 3)).astype(np.float32)]
    assert tpred._target_hw(frames[0]) == jpred._target_hw(frames[0]) == (28, 112)
    for got, want, f in zip(tpred.run(frames), jpred.run(frames), frames):
        assert got.shape == f.shape[:2] and rel(got, want) <= 1e-4, rel(got, want)
