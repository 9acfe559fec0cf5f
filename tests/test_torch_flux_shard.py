"""Port parity: tensor-parallel FLUX (priors/flux_shard.py), the sharded
refiner (``build_flux_refiner(mesh=...)``) and IDU view generation with it,
on gloo ranks spawned on the CPU, against the JAX package on tp of the 8
virtual CPU devices that tests/conftest.py makes.

The ranks run tests/torch_flux_ranks.py (no JAX in a rank) while the JAX
side runs in the test process, at tests/test_flux_shard.py's
``tp_config()`` (8 heads, hidden 64, 2 double + 3 single blocks).

Tolerances, and why:
  * the fp32 velocity at tp = 2 and 4 against JAX's sharded and unsharded
    one: atol 2e-5, rtol 1e-4 (JAX's own bound, tests/test_flux_shard.py);
  * bf16 (the port's route: bf16 activations, float32 norm statistics,
    RoPE, scores and softmax) against JAX's bf16 ``shard_flux_params``
    (bf16 parameters, float32 activations): rel norm 3e-2, the bound of
    tests/test_torch_priors.py's production-dtype test;
  * each rank's shard equals JAX's ``addressable_shards[r]`` transposed,
    and ``build_sharded_flux(seed=0)`` the slices of ``build_module(seed=0)``,
    exactly;
  * every rank's velocity and refined frames bit-equal;
  * the sharded refiner against the port's whole one with the same seed:
    atol 5e-5 (tests/test_flux_shard.py's bound for JAX's); against JAX's
    sharded refiner under equal conditions (the noise streams differ, and
    cancel there): rel norm 1e-4, as tests/test_torch_priors.py;
  * an IDU episode on a 2-rank view mesh with the sharded refiner against
    the same episode with a whole one: the views within 5e-5, the written
    frames within one 8-bit step; the training after it within
    tests/test_torch_trainer_mesh.py's tolerances (``xyz`` 1e-3 of its
    range, Adam's opacity moment 1e-3 norm-relative).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

from skyfall_gs_tpu.priors import flux as jf
from skyfall_gs_tpu.priors import flux_shard as jfs
from skyfall_gs_tpu.priors import flux_vae as jv
from skyfall_gs_tpu.priors.flux_refiner import build_flux_refiner as jbuild
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.priors import flux as tf
from skyfall_gs_tpu_torch.priors import flux_shard as fs
from skyfall_gs_tpu_torch.priors import flux_vae as tv
from skyfall_gs_tpu_torch.priors.flux_refiner import build_flux_refiner
from skyfall_gs_tpu_torch.priors.interface import get_refiner
from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator
from tests import torch_flux_ranks
from tests.test_flux_shard import _inputs, tp_config
from tests.test_torch_parallel import in_background, rel
from tests.test_torch_trainer_mesh import IDU, OPT, scene_arrays
from tests.test_train import _synthetic_scene

torch.set_num_threads(1)
JOIN_S = 150.0
NUM_STEPS, N_MAX = 6, 4
FRAMES = 2
IDU_OPT = dict(IDU, idu_refine=True, idu_flow_edit_n_max=2)
# JAX's stacked parameter names against the port's diffusers layer names.
DOUBLE = {"img_mod": "norm1.linear", "txt_mod": "norm1_context.linear",
          "img_q": "attn.to_q", "img_k": "attn.to_k", "img_v": "attn.to_v",
          "txt_q": "attn.add_q_proj", "txt_k": "attn.add_k_proj", "txt_v": "attn.add_v_proj",
          "img_out": "attn.to_out.0", "txt_out": "attn.to_add_out",
          "img_mlp1": "ff.net.0.proj", "img_mlp2": "ff.net.2",
          "txt_mlp1": "ff_context.net.0.proj", "txt_mlp2": "ff_context.net.2"}
SINGLE = {"mod": "norm.linear", "q": "attn.to_q", "k": "attn.to_k", "v": "attn.to_v",
          "mlp_in": "proj_mlp"}


def _np_sd(params, cfg) -> dict:
    sd = tf.state_from_numpy(jax.tree.map(np.asarray, params), tf.FluxConfig(**cfg._asdict()))
    return {k: v.numpy() for k, v in sd.items()}


def _case(cfg, weights, rng, b, t):
    tok, ids, cond = _inputs(cfg, rng, b=b)
    return dict(cfg=cfg._asdict(), weights=weights, tok=np.asarray(tok), ids=np.asarray(ids),
                cond=dict(txt=np.asarray(cond.txt), pooled=np.asarray(cond.pooled)),
                t=np.asarray(t, np.float32))


def _jcond(c, guidance=3.5):
    return jf.FluxCond(jnp.asarray(c["txt"]), jnp.asarray(c["pooled"]), guidance)


def _jax_mesh(tp):
    return Mesh(np.array(jax.devices("cpu")[:tp]), ("tp",))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tp = 2 (velocities, shards, the refiner, the IDU episodes) and tp = 4
    (velocities, shards) on gloo ranks at once, JAX beside them."""
    root = tmp_path_factory.mktemp("flux_shard")
    rng = np.random.default_rng(0)
    cfgs = {g: tp_config(g) for g in (True, False)}
    params = {g: jf.init_flux_params(jax.random.PRNGKey(0), c) for g, c in cfgs.items()}
    vcfg = jv.VAEConfig.tiny()
    vparams = jv.init_vae_params(jax.random.PRNGKey(1), vcfg)
    cases = {"guided": _case(cfgs[True], "guided", rng, 2, 0.7),
             "unguided": _case(cfgs[False], "unguided", rng, 2, 0.7),
             "batched_t": _case(cfgs[True], "guided", rng, 3, [0.1, 0.5, 0.9])}
    conds = [dict(txt=rng.normal(0, 0.02, (1, 6, cfgs[True].joint_dim)).astype(np.float32),
                  pooled=rng.normal(0, 0.02, (1, cfgs[True].pooled_dim)).astype(np.float32))
             for _ in range(2)]
    scene = _synthetic_scene(np.random.default_rng(0))
    payload = dict(cases=cases, weights={"guided": _np_sd(params[True], cfgs[True]),
                                         "unguided": _np_sd(params[False], cfgs[False])},
                   vae={k: v.numpy() for k, v in tv.state_from_numpy(
                       jax.tree.map(np.asarray, vparams),
                       tv.VAEConfig(**vcfg._asdict())).items()},
                   vae_cfg=vcfg._asdict(), num_steps=NUM_STEPS, n_max=N_MAX,
                   frames=[rng.uniform(size=(16, 16, 3)).astype(np.float32)
                           for _ in range(FRAMES)],
                   refiner_conds=conds, scene=scene_arrays(scene), root=str(root), opt=OPT,
                   idu_opt=IDU_OPT)
    join2 = in_background(tmesh.launch, torch_flux_ranks.refiner_and_idu, 2, (payload,),
                          device="cpu", join_timeout_s=JOIN_S)
    join4 = in_background(tmesh.launch, torch_flux_ranks.velocity_and_shards, 4, (payload,),
                          device="cpu", join_timeout_s=JOIN_S)
    out = {"payload": payload, "params": params, "vparams": vparams, "root": root}
    for tp in (2, 4):
        mesh = _jax_mesh(tp)
        for dtype in (None, jnp.bfloat16):
            sharded = {g: jfs.shard_flux_params(params[g], mesh, cfgs[g], dtype=dtype)
                       for g in cfgs}
            for name, case in cases.items():
                g = case["weights"] == "guided"
                if dtype is not None and name != "guided":
                    continue
                out[(tp, name, dtype)] = np.asarray(jfs.make_sharded_flux_velocity(
                    mesh, cfgs[g])(sharded[g], jnp.asarray(case["tok"]),
                                   jnp.asarray(case["ids"]), _jcond(case["cond"]),
                                   jnp.asarray(case["t"])))
        out[(tp, "shards")] = jfs.shard_flux_params(params[True], mesh, cfgs[True], dtype=None)
    for name, case in cases.items():
        g = case["weights"] == "guided"
        out[("single", name)] = np.asarray(jf.flux_velocity(
            params[g], cfgs[g], jnp.asarray(case["tok"]), jnp.asarray(case["ids"]),
            _jcond(case["cond"]), jnp.asarray(case["t"])))
    out[2], out[4] = join2(), join4()
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", ["guided", "unguided", "batched_t"])
def test_fp32_velocity_matches_jax_sharded_and_unsharded(runs, tp, case):
    ranks = runs[tp]
    got = ranks[0]["fp32"][case]["v"]
    assert ranks[0]["fp32"][case]["dtype"] == "torch.float32"
    b = runs["payload"]["cases"][case]["tok"].shape[0]
    assert got.shape == (b, 16, 16)
    np.testing.assert_allclose(got, runs[(tp, case, None)], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, runs[("single", case)], atol=2e-5, rtol=1e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fp32"][case]["v"], got)


@pytest.mark.parametrize("tp", [2, 4])
def test_bf16_route_matches_jax_bf16_shards(runs, tp):
    ranks = runs[tp]
    got = ranks[0]["bf16"]["v"]
    assert ranks[0]["bf16"]["dtype"] == "torch.float32" and np.isfinite(got).all()
    assert rel(got, runs[(tp, "guided", jnp.bfloat16)]) <= 3e-2
    assert rel(got, runs[("single", "guided")]) <= 3e-2
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["bf16"]["v"], got)


def test_collectives_per_evaluation(runs):
    """6 per double block (2 modulation all-gathers, 4 all-reduces) and 2 per
    single block; the all-reduces move the (B, L, d) residual stream."""
    cfg = tp_config()
    case = runs["payload"]["cases"]["guided"]
    b, n_img = case["tok"].shape[:2]
    length = n_img + case["cond"]["txt"].shape[1]
    for tp in (2, 4):
        traffic = runs[tp][0]["fp32"]["guided"]["traffic"]
        assert traffic["collectives"] == 6 * cfg.depth_double + 2 * cfg.depth_single
        d = cfg.hidden
        reduce = (2 * cfg.depth_double + cfg.depth_single) * b * length * d * 4
        gather = (2 * 6 * cfg.depth_double + 3 * cfg.depth_single) * b * d // tp * 4
        assert traffic["bytes"] == reduce + gather


def _jax_shard(leaf, mesh, r):
    (shard,) = [s for s in leaf.addressable_shards if s.device == mesh.devices[r]]
    return np.asarray(shard.data)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_equal_jax_addressable_shards(runs, tp):
    """Each rank's shard is JAX's ``addressable_shards[r]`` in the torch
    layout, the fused single-block output its two halves' row shards."""
    mesh = _jax_mesh(tp)
    st = runs[(tp, "shards")]
    cfg = tp_config()
    for r, rank in enumerate(runs[tp]):
        local = rank["shard"]
        for i in range(cfg.depth_double):
            for jname, tname in DOUBLE.items():
                p = f"transformer_blocks.{i}.{tname}"
                np.testing.assert_array_equal(local[p + ".weight"],
                                              _jax_shard(st["double"][jname]["w"], mesh, r)[i].T)
                np.testing.assert_array_equal(local[p + ".bias"],
                                              _jax_shard(st["double"][jname]["b"], mesh, r)[i])
        for i in range(cfg.depth_single):
            p = f"single_transformer_blocks.{i}"
            for jname, tname in SINGLE.items():
                np.testing.assert_array_equal(local[f"{p}.{tname}.weight"],
                                              _jax_shard(st["single"][jname]["w"], mesh, r)[i].T)
            out = np.concatenate([_jax_shard(st["single"][h]["w"], mesh, r)[i].T
                                  for h in ("out_attn", "out_mlp")], 1)
            np.testing.assert_array_equal(local[f"{p}.proj_out.weight"], out)
            np.testing.assert_array_equal(local[f"{p}.proj_out.bias"],
                                          np.asarray(st["single"]["out_b"])[i])
        np.testing.assert_array_equal(local["proj_out.weight"],
                                      np.asarray(st["proj_out"]["w"]).T)
        assert local.keys() == runs["payload"]["weights"]["guided"].keys()


@pytest.mark.parametrize("tp", [2, 4])
def test_seeded_shards_are_slices_of_build_module(runs, tp):
    cfg = tf.FluxConfig(**tp_config()._asdict())
    whole = tf.build_module(tf.FluxTransformer, cfg, device="cpu", seed=0).state_dict()
    for r, rank in enumerate(runs[tp]):
        want = fs.shard_flux_state(whole, r, tp, cfg)
        assert rank["seeded"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(rank["seeded"][k], v.numpy(), err_msg=k)
        assert rank["seeded"]["transformer_blocks.0.attn.to_q.weight"].shape == (
            cfg.hidden // tp, cfg.hidden)


def test_count_flux_params_matches_jax():
    for cfg in (tp_config(), tp_config(False), jf.FluxConfig()):
        assert fs.count_flux_params(tf.FluxConfig(**cfg._asdict())) == \
            jfs.count_flux_params(cfg)
    total, sharded, rep = fs.count_flux_params(tf.FluxConfig())
    model = tf.build_module(tf.FluxTransformer, tf.FluxConfig.tiny(), device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) == \
        fs.count_flux_params(tf.FluxConfig.tiny())[0]
    assert 11.5e9 < total < 12.5e9 and sharded + rep == total


def test_tp_must_divide_heads_and_mlp():
    cfg = tf.FluxConfig(**tp_config()._replace(heads=6, hidden=48, head_dim=8)._asdict())
    sd = tf.build_module(tf.FluxTransformer, cfg, device="cpu", seed=0).state_dict()
    with pytest.raises(ValueError, match="tp=4 must divide heads=6"):
        fs.shard_flux_state(sd, 0, 4, cfg)
    with pytest.raises(ValueError, match="tp=4"):
        fs.make_sharded_flux_velocity(types.SimpleNamespace(size=4), cfg)
    fs.shard_flux_state(sd, 1, 2, cfg)


def _whole_refiner(runs, cond_pair):
    p = runs["payload"]
    return build_flux_refiner(
        transformer={k: torch.from_numpy(v) for k, v in p["weights"]["guided"].items()},
        vae={k: torch.from_numpy(v) for k, v in p["vae"].items()},
        cfg=tf.FluxConfig(**p["cases"]["guided"]["cfg"]),
        vae_cfg=tv.VAEConfig(**p["vae_cfg"]), num_steps=NUM_STEPS, batch_size=2, seed=7,
        src_cond=tf.FluxCond(torch.from_numpy(cond_pair[0]["txt"]),
                             torch.from_numpy(cond_pair[0]["pooled"]), 1.5),
        tar_cond=tf.FluxCond(torch.from_numpy(cond_pair[1]["txt"]),
                             torch.from_numpy(cond_pair[1]["pooled"]), 5.5),
        device="cpu", dtype=torch.float32)


def test_sharded_refiner_matches_the_whole_one(runs):
    ranks = runs[2]
    p = runs["payload"]
    assert ranks[0]["refiner_mesh"]
    want = _whole_refiner(runs, p["refiner_conds"]).run(p["frames"], n_max=N_MAX)
    for g, w, f in zip(ranks[0]["refined"], want, p["frames"]):
        assert g.shape == f.shape and np.abs(w - f).max() > 1e-3
        np.testing.assert_allclose(g, w, atol=5e-5)
    for a, b in zip(ranks[1]["refined"], ranks[0]["refined"]):
        np.testing.assert_array_equal(a, b)


def test_sharded_refiner_matches_jax_with_equal_conditions(runs):
    """Equal conditions, where the two packages' noise streams cancel: the
    port's sharded refiner on 2 ranks against JAX's ``build_flux_refiner(
    mesh=..., tp_dtype=None)`` on 2 devices."""
    p = runs["payload"]
    jcond = _jcond(p["refiner_conds"][1], 5.5)
    jref = jbuild(transformer_params=runs["params"][True], vae_params=runs["vparams"],
                  cfg=tp_config(), vae_cfg=jv.VAEConfig.tiny(), num_steps=NUM_STEPS,
                  batch_size=2, seed=7, src_cond=jcond, tar_cond=jcond, mesh=_jax_mesh(2),
                  tp_dtype=None)
    want = jref.run(p["frames"], n_max=N_MAX)
    for g, w in zip(runs[2][0]["refined_equal"], want):
        assert rel(g, w) <= 1e-4, rel(g, w)
    for a, b in zip(runs[2][1]["refined_equal"], runs[2][0]["refined_equal"]):
        np.testing.assert_array_equal(a, b)


def test_get_refiner_passes_the_mesh_through(tmp_path):
    """``get_refiner("flowedit", mesh=...)`` builds the sharded refiner in
    ``dtype`` (float32 by default on the CPU); a single-device Trainer takes
    it (at tp = 1 its client runs the refiner locally), and raises where
    that Trainer would sit off rank 0 of the refiner's mesh."""
    from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from skyfall_gs_tpu_torch.priors import RenderDepthPredictor
    from skyfall_gs_tpu_torch.train.loop import Trainer
    from tests.torch_ranks import scene_from_arrays

    cfg = tf.FluxConfig(**tp_config()._asdict())
    vcfg = tv.VAEConfig.tiny()
    mesh = tmesh.make_mesh(1, axis="tp", backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        whole = tf.build_module(tf.FluxTransformer, cfg, device="cpu", seed=0)
        vae = tf.build_module(tv.VAE, vcfg, device="cpu", seed=1)
        ref = get_refiner("flowedit", transformer=whole, vae=vae, cfg=cfg, vae_cfg=vcfg,
                          mesh=mesh)
        assert ref.mesh is mesh and isinstance(ref.transformer, fs.ShardedFluxTransformer)
        assert next(ref.transformer.parameters()).dtype == torch.float32
        bf16 = get_refiner("flowedit", transformer=whole, vae=vae, cfg=cfg, vae_cfg=vcfg,
                           mesh=mesh, dtype=torch.bfloat16)
        assert next(bf16.transformer.parameters()).dtype == torch.bfloat16
        scene = scene_from_arrays(scene_arrays(_synthetic_scene(np.random.default_rng(0))),
                                  "cpu")
        t = Trainer(ModelConfig(model_path=str(tmp_path / "m")),
                    OptimizationConfig(**IDU_OPT), PipelineConfig(), scene)
        orch = IDUOrchestrator(t, ref, RenderDepthPredictor())
        assert orch.client.refiner is ref and orch.client.mesh is None
        bf16.mesh = dataclasses.replace(mesh, rank=1, size=2)   # rank 1 of two: it serves
        with pytest.raises(ValueError, match="serve_refiner"):
            IDUOrchestrator(t, bf16, RenderDepthPredictor())
    finally:
        torch.distributed.destroy_process_group()


def test_idu_episode_with_a_sharded_refiner(runs):
    """A 2-rank view-mesh IDU episode whose refiner is sharded over the same
    ranks against the same episode with a whole refiner (rank 0 refines)."""
    whole, sharded = (runs[2][0][k] for k in ("whole", "sharded"))
    np.testing.assert_allclose(sharded["images"], whole["images"], atol=5e-5)
    np.testing.assert_allclose(sharded["depths"], whole["depths"], atol=5e-5)
    assert sharded["images"].shape == (2, 32, 32, 3)
    assert np.abs(sharded["pngs"].astype(int) - whole["pngs"].astype(int)).max() <= 1
    want = np.clip(sharded["images"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(sharded["pngs"], want)
    for k in ("whole", "sharded"):
        r0, r1 = runs[2][0][k], runs[2][1][k]
        assert r0["overflow"] == 0
        assert r1["state"]["digest"] == r0["state"]["digest"]
        np.testing.assert_array_equal(r1["images"], r0["images"])
    a, b = sharded["state"], whole["state"]
    assert a["step"] == b["step"] == IDU_OPT["idu_episode_iterations"]
    xyz = b["params"]["xyz"]
    span = float(xyz.max() - xyz.min())
    assert float(np.abs(a["params"]["xyz"] - xyz).max()) <= 1e-3 * span
    assert rel(a["mu"]["opacity"], b["mu"]["opacity"]) <= 1e-3


def _row_parallel(name: str) -> bool:
    """Whether the module ``name`` is a row-parallel layer of the shard plan."""
    m = fs._BLOCK_KEY.match(name + ".weight")
    return m is not None and (m.group(2) in fs.ROW_LAYERS
                              or (m.group(1) is not None and m.group(2) == "proj_out"))


def _block_outputs(model, tok, ids, cond, t) -> list:
    """Every block's output (the image and text streams of a double block)
    in order, then the velocity."""
    outs = []
    hooks = [blk.register_forward_hook(lambda mod, a, out: outs.append(
        tuple(out) if isinstance(out, tuple) else (out,)))
        for blk in [*model.transformer_blocks, *model.single_transformer_blocks]]
    try:
        outs.append((model(tok, ids, cond, t),))
    finally:
        for h in hooks:
            h.remove()
    return outs


def test_tp1_bf16_gap_is_the_matmul_then_bias_swap(tmp_path):
    """NCCL at tp = 1 comes out 1.56e-2-1.60e-2 from the whole bf16 model on
    the card.  Block by block in bf16 on the CPU, a tp = 1
    ``ShardedFluxTransformer`` on a 1-rank gloo mesh is bit-equal to a
    ``FluxTransformer`` whose row-parallel layers compute the matmul and then
    add the bias, in place of ``F.linear``'s fused ``addmm``: its gap to the
    whole model is that swap's alone.  The biases are drawn non-zero, so the
    swap changes bits."""
    cfg = tf.FluxConfig(**tp_config()._asdict())
    whole = tf.build_module(tf.FluxTransformer, cfg, dtype=torch.bfloat16, device="cpu",
                            seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    swapped = tf.build_module(tf.FluxTransformer, cfg, dtype=torch.bfloat16, device="cpu",
                              seed=None)
    swapped.load_state_dict(whole.state_dict())
    rows = [mod for name, mod in swapped.named_modules() if _row_parallel(name)]
    assert len(rows) == 4 * cfg.depth_double + cfg.depth_single
    for mod in rows:
        mod.forward = types.MethodType(lambda self, x: F.linear(x, self.weight) + self.bias,
                                       mod)
    tok, ids, cond = _inputs(tp_config(), np.random.default_rng(0), b=2)
    tok, ids = torch.from_numpy(np.array(tok)), torch.from_numpy(np.array(ids))
    cond = tf.FluxCond(torch.from_numpy(np.array(cond.txt)),
                       torch.from_numpy(np.array(cond.pooled)), cond.guidance)
    mesh = tmesh.make_mesh(1, axis="tp", backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        sharded = fs.shard_flux_params(whole, mesh, cfg, dtype=torch.bfloat16)
        got = _block_outputs(sharded, tok, ids, cond, 0.7)
    finally:
        torch.distributed.destroy_process_group()
    want = _block_outputs(swapped, tok, ids, cond, 0.7)
    fused = _block_outputs(whole, tok, ids, cond, 0.7)
    assert len(got) == len(want) == cfg.depth_double + cfg.depth_single + 1
    gaps = []
    for i, (g, w, f) in enumerate(zip(got, want, fused)):
        for a, b, c in zip(g, w, f):
            assert torch.equal(a, b), f"block {i}"
            gaps.append(rel(a.float(), c.float()))
    assert 0.0 < max(gaps) <= 3e-2, gaps
