"""Rank programs for the serving-rank tests (tests/test_torch_flux_serve.py).

As tests/torch_ranks.py: ``parallel.mesh.launch`` runs these module-level
functions in spawned ranks, which import this module, so it imports the port
and never JAX.  Rank 0 trains with a single-device Trainer and a FLUX refiner
sharded over both ranks; rank 1 serves that refiner.  Every program returns
host values.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from skyfall_gs_tpu_torch.config import (
    IDU_CURRICULA,
    IDUCurriculum,
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
)
from skyfall_gs_tpu_torch.io.png import read_png
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.parallel.mesh import grid_meshes
from skyfall_gs_tpu_torch.priors import RenderDepthPredictor
from skyfall_gs_tpu_torch.priors import flux as tf
from skyfall_gs_tpu_torch.priors import flux_serve
from skyfall_gs_tpu_torch.priors.flux_refiner import build_flux_refiner
from skyfall_gs_tpu_torch.priors.flux_serve import serve_or_run, serve_refiner, serving_client
from skyfall_gs_tpu_torch.priors.flux_vae import VAEConfig
from skyfall_gs_tpu_torch.train import loop as tloop
from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator
from skyfall_gs_tpu_torch.train.step import init_train_state
from tests.torch_ranks import _host_state, _small_pseudo_stack, _trainer, scene_from_arrays

# One ring at elevation 60 and radius 3 around the synthetic scene, for
# ``run``'s curriculum (the published ones orbit at 250-600 units).
RING = IDUCurriculum(elevation_list=(60.0,), radius_list=(3.0,), fov=60.0)


class InjectedFailure(Exception):
    """The failure a patched train step raises on rank 0."""


def add_ring() -> None:
    IDU_CURRICULA.setdefault("ring", RING)


def refiner(p: dict, mesh=None, equal: bool = False):
    """The FLUX FlowEdit refiner of ``p``'s weights, sharded over ``mesh``
    (whole without one); ``equal`` gives both branches the target's
    conditioning."""
    src, tar = (tf.FluxCond(torch.from_numpy(c["txt"]), torch.from_numpy(c["pooled"]), g)
                for c, g in zip(p["conds"], (1.5, 5.5)))
    return build_flux_refiner(
        transformer={k: torch.from_numpy(v) for k, v in p["weights"].items()},
        vae={k: torch.from_numpy(v) for k, v in p["vae"].items()},
        cfg=tf.FluxConfig(**p["cfg"]), vae_cfg=VAEConfig(**p["vae_cfg"]),
        num_steps=p["num_steps"], batch_size=2, seed=7, src_cond=tar if equal else src,
        tar_cond=tar, device="cpu", dtype=torch.float32, mesh=mesh)


def single_trainer(p: dict, name: str, opt: dict) -> tloop.Trainer:
    """A single-device Trainer on ``p``'s scene (no mesh)."""
    base = dict(p["opt"])
    base.update(opt)
    return tloop.Trainer(ModelConfig(model_path=os.path.join(p["root"], name)),
                         OptimizationConfig(**base), PipelineConfig(),
                         scene_from_arrays(p["scene"], "cpu"), rng_seed=p["seed"])


def record_episode(orch: IDUOrchestrator) -> dict:
    """Wrap ``orch`` to keep the renders and the views of its episodes."""
    rec = {"renders": [], "views": []}
    render, generate = orch._render, orch.generate_idu_views

    def rendered(*a, **k):
        imgs = render(*a, **k)
        rec["renders"].extend(imgs)
        return imgs

    def generated(*a, **k):
        views = generate(*a, **k)
        rec["views"].extend(views)
        return views

    orch._render, orch.generate_idu_views = rendered, generated
    return rec


def pngs(root: str, name: str, tag: str, kind: str) -> np.ndarray:
    d = os.path.join(root, name, "idu", tag, kind)
    return np.stack([read_png(os.path.join(d, f)) for f in sorted(os.listdir(d))])


def episode(p: dict, name: str, ref) -> dict:
    """One ``run(episodes=1)`` episode of a single-device Trainer on ``ring``
    with ``ref``: the views, renders, trained state and written frames."""
    add_ring()
    t = single_trainer(p, name, p["episode_opt"])
    t._gen_pseudo_stack_at = _small_pseudo_stack
    orch = IDUOrchestrator(t, ref, RenderDepthPredictor())
    rec = record_episode(orch)
    s = orch.run(t.init_state(), 0, episodes=1)
    tag = orch.episodes[-1]["tag"]
    return {"state": _host_state(s), "images": np.stack([v.image for v in rec["views"]]),
            "depths": np.stack([v.depth for v in rec["views"]]),
            "renders": np.stack(rec["renders"]), "overflow": orch.max_overflow,
            "client": dict(orch.client.record),
            "pngs": pngs(p["root"], name, tag, "render_refine")}


def views_vs_jax(p: dict, ref) -> dict:
    """Rank 0: ``generate_idu_views`` of a single-device Trainer from JAX's
    initial state with the sharded ``ref``, inside an explicit ``with`` of
    the client."""
    t = single_trainer(p, "views", p["views_opt"])
    ts = init_train_state(tg.state_from_numpy(p["init"]))
    t._refresh_filter(ts)
    orch = IDUOrchestrator(t, ref, RenderDepthPredictor())
    rec = record_episode(orch)
    with orch.client:
        views = orch.generate_idu_views(ts, p["targets"], *p["orbit"], p["tag"])
    return {"uids": [v.camera.uid for v in views],
            "full_proj": np.stack([v.camera.full_proj.numpy() for v in views]),
            "images": np.stack([v.image for v in views]),
            "depths": np.stack([v.depth for v in views]),
            "renders": np.stack(rec["renders"]), "names": [v.image_name for v in views],
            "py_rng": t.py_rng.getstate(), "overflow": orch.max_overflow,
            "client": dict(orch.client.record)}


def failing_episode(p: dict, ref) -> None:
    """An episode whose first train step raises ``InjectedFailure``."""
    add_ring()
    t = single_trainer(p, "failing", p["episode_opt"])
    orch = IDUOrchestrator(t, ref, RenderDepthPredictor())

    def raising(*a, **k):
        def step(*a, **k):
            raise InjectedFailure(time.time())
        return step

    t._get_step_fn = raising
    orch.run(t.init_state(), 0, episodes=1)


def value_errors(mesh, p: dict, tp) -> dict:
    """The routes that still raise: a single-device Trainer off rank 0, and a
    Trainer mesh of other ranks (each rank's own column of a (1, 2) grid)."""
    out = {}
    ref = refiner(p, tp)
    if not mesh.is_main:
        try:
            IDUOrchestrator(single_trainer(p, "off_main", p["views_opt"]), ref,
                            RenderDepthPredictor())
        except ValueError as e:
            out["single_off_main"] = str(e)
    column, _ = grid_meshes(mesh, (1, 2))
    try:
        IDUOrchestrator(_trainer(column, p, f"column{mesh.rank}", **p["views_opt"]), ref,
                        RenderDepthPredictor())
    except ValueError as e:
        out["other_ranks"] = str(e)
    return out


class Doubling:
    """A refiner on ``mesh`` that doubles its frames (every rank alike)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def run(self, images, scale: float = 2.0, **_):
        return [np.asarray(f) * scale for f in images]


def heartbeat_stress(p: dict, tp) -> dict:
    """Many small commands while the heartbeat fires every 0.5 ms and the
    interpreter switches threads every microsecond: a heartbeat read inside
    a command would derail the serving rank."""
    rng = np.random.default_rng(tp.rank)
    ref = Doubling(tp)

    def send():
        client = serving_client(ref)
        for i in range(p["stress_commands"]):
            client.run([rng.uniform(size=(4, 4, 3)).astype(np.float32)], scale=float(i))
            time.sleep(0.001 * (i % 3))
        return dict(client.record)

    beat, switch = flux_serve.HEARTBEAT_S, sys.getswitchinterval()
    flux_serve.HEARTBEAT_S = 5e-4
    sys.setswitchinterval(1e-6)
    try:
        return serve_or_run(ref, send)
    finally:
        flux_serve.HEARTBEAT_S = beat
        sys.setswitchinterval(switch)


def serving_runs(mesh, p: dict) -> dict:
    """tp = 2: (a) views against JAX, (b) an episode driven through
    ``serve_or_run``, (c) a failing episode, (d) the ValueErrors, (e) the
    heartbeat stress."""
    tp = dataclasses.replace(mesh, axis="tp")
    out = {}

    ref = refiner(p, tp, equal=True)
    out["views"] = views_vs_jax(p, ref) if mesh.is_main else serve_refiner(ref)

    ref = refiner(p, tp)      # a fresh noise stream, as the whole refiner's
    out["episode"] = serve_or_run(ref, episode, p, "sharded", ref)

    ref = refiner(p, tp)
    try:
        serve_or_run(ref, failing_episode, p, ref)
        out["failure"] = {"raised": None}
    except InjectedFailure as e:
        out["failure"] = {"raised": "InjectedFailure", "at": e.args[0]}
    except RuntimeError as e:
        out["failure"] = {"raised": "RuntimeError", "message": str(e), "at": time.time()}

    out["value_errors"] = value_errors(mesh, p, tp)
    out["stress"] = heartbeat_stress(p, tp)
    return out
