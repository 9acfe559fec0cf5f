"""Rank programs for the tensor-parallel FLUX tests
(tests/test_torch_flux_shard.py).

As tests/torch_ranks.py: ``parallel.mesh.launch`` runs these module-level
functions in spawned ranks, which import this module, so it imports the port
and never JAX.  Weights arrive as numpy state dicts under diffusers' keys,
inputs as numpy arrays; every program returns host values.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from skyfall_gs_tpu_torch.io.png import read_png
from skyfall_gs_tpu_torch.priors import RenderDepthPredictor
from skyfall_gs_tpu_torch.priors import flux as tf
from skyfall_gs_tpu_torch.priors import flux_shard as fs
from skyfall_gs_tpu_torch.priors.flux_refiner import build_flux_refiner
from skyfall_gs_tpu_torch.priors.flux_vae import VAEConfig
from skyfall_gs_tpu_torch.train import idu as tidu
from tests.torch_ranks import _host_state, _small_pseudo_stack, _trainer


def _tp(mesh):
    return dataclasses.replace(mesh, axis="tp")


def _torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _cond(c: dict, guidance: float = 3.5) -> tf.FluxCond:
    return tf.FluxCond(torch.from_numpy(c["txt"]), torch.from_numpy(c["pooled"]), guidance)


def _local(module) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in module.state_dict().items()}


def _velocities(mesh, p: dict, dtype) -> dict:
    """The cases of ``p["cases"]`` through this rank's shard of each
    config's weights; the collectives of the first evaluation."""
    out = {}
    for name, case in p["cases"].items():
        cfg = tf.FluxConfig(**case["cfg"])
        module = fs.shard_flux_params(_torch_sd(p["weights"][case["weights"]]), mesh, cfg,
                                      dtype=dtype)
        vel = fs.make_sharded_flux_velocity(mesh, cfg)
        mesh.traffic.update(collectives=0, bytes=0)
        got = vel(module, torch.from_numpy(case["tok"]), torch.from_numpy(case["ids"]),
                  _cond(case["cond"]), torch.from_numpy(case["t"]))
        out[name] = {"v": got.numpy(), "traffic": dict(mesh.traffic), "dtype": str(got.dtype)}
    return out


def velocity_and_shards(mesh, p: dict) -> dict:
    """tp = mesh.size: the fp32 and bf16 velocities, this rank's shard of
    ``p["weights"]["guided"]`` and its shard drawn from a seed."""
    mesh = _tp(mesh)
    cfg = tf.FluxConfig(**p["cases"]["guided"]["cfg"])
    out = {"fp32": _velocities(mesh, p, None),
           "bf16": _velocities(mesh, p, torch.bfloat16)["guided"]}
    out["shard"] = _local(fs.shard_flux_params(_torch_sd(p["weights"]["guided"]), mesh, cfg,
                                               dtype=None))
    out["seeded"] = _local(fs.build_sharded_flux(cfg, mesh, dtype=torch.float32, seed=0))
    return out


def _refiner(p: dict, mesh=None):
    cfg = tf.FluxConfig(**p["cases"]["guided"]["cfg"])
    src, tar = (_cond(c, g) for c, g in zip(p["refiner_conds"], (1.5, 5.5)))
    return build_flux_refiner(transformer=_torch_sd(p["weights"]["guided"]),
                              vae=_torch_sd(p["vae"]), cfg=cfg,
                              vae_cfg=VAEConfig(**p["vae_cfg"]), num_steps=p["num_steps"],
                              batch_size=2, seed=7, src_cond=src, tar_cond=tar, device="cpu",
                              dtype=torch.float32, mesh=mesh)


def refiner_and_idu(mesh, p: dict) -> dict:
    """tp = 2: the sharded refiner's frames, then one IDU episode on the view
    mesh with a whole refiner (rank 0 refines) and with the sharded one
    (every rank refines)."""
    out = velocity_and_shards(mesh, p)
    tp = _tp(mesh)
    sharded = _refiner(p, tp)
    out["refiner_mesh"] = sharded.mesh is tp
    out["refined"] = sharded.run(p["frames"], n_max=p["n_max"])
    sharded.src_cond = sharded.tar_cond
    out["refined_equal"] = sharded.run(p["frames"], n_max=p["n_max"])

    # Fresh refiners: the noise stream starts from the seed in both episodes.
    for name, refiner in (("whole", _refiner(p)), ("sharded", _refiner(p, tp))):
        t = _trainer(mesh, p, name, **p["idu_opt"])
        t._gen_pseudo_stack_at = _small_pseudo_stack
        orch = tidu.IDUOrchestrator(trainer=t, refiner=refiner,
                                    depth_predictor=RenderDepthPredictor())
        views = []
        generate = orch.generate_idu_views

        def recorded(*a, _generate=generate, **k):
            got = _generate(*a, **k)
            views.extend(got)
            return got

        orch.generate_idu_views = recorded
        s = orch.train_episode(t.init_state(), 0, [[0.0, 0.0, 0.0]], 60.0, 3.0, 60.0)
        res = {"state": _host_state(s), "images": np.stack([v.image for v in views]),
               "depths": np.stack([v.depth for v in views]), "overflow": orch.max_overflow}
        if mesh.is_main:
            d = os.path.join(p["root"], name, "idu", orch.episodes[-1]["tag"], "render_refine")
            res["pngs"] = np.stack([read_png(os.path.join(d, f))
                                    for f in sorted(os.listdir(d))])
        out[name] = res
    return out
