"""Rank programs for the gaussian-sharded tests
(tests/test_torch_gauss_shard.py, tests/test_torch_checkpoint_sharded.py,
tests/test_torch_trainer_gauss.py).

As tests/torch_ranks.py: ``parallel.mesh.launch`` runs these module-level
functions in spawned ranks, which import this module, so it imports the port
and never JAX.  Each program takes the full state as numpy arrays, works on
its rank's shard and returns host values, usually the state gathered from
every shard.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.densify import DensifyStats
from skyfall_gs_tpu_torch.parallel import gauss_shard as gs
from skyfall_gs_tpu_torch.parallel.mesh import grid_meshes
from skyfall_gs_tpu_torch.parallel.sharding import make_parallel_train_step, state_digest
from skyfall_gs_tpu_torch.train import checkpoint_sharded as cks
from skyfall_gs_tpu_torch.train.step import init_train_state
from tests.torch_ranks import _host_state, _small_pseudo_stack, camera_from_arrays

_VIEW = ("images", "masks", "depths")


def _gauss(mesh):
    return dataclasses.replace(mesh, axis="gauss")


def _train_state(p: dict, key: str = "state"):
    ts = init_train_state(tg.state_from_numpy(p[key]))
    for _, m in tg.flat_fields(ts.opt.mu):
        m.add_(p.get("mu_offset", 0.0))
    return ts


def _view(p: dict, v: int):
    return (camera_from_arrays(p["cameras"][v]),
            *(torch.from_numpy(p[k][v]) for k in _VIEW))


def _full(ts, mesh) -> dict:
    """The gathered state as host arrays, with its digest (the replicated
    leaves are this rank's own copies, so equal digests mean equal
    replicas)."""
    return _host_state(gs.gather_train_state(ts, mesh))


def _metrics(m) -> dict:
    return {k: float(getattr(m, k)) for k in m._fields}


def _sharded_step(mesh, p: dict) -> dict:
    """One gaussian-sharded step on view 0 and its collectives' count."""
    ts = gs.shard_train_state(_train_state(p), mesh)
    step = gs.make_gauss_sharded_train_step(mesh, OptimizationConfig(), use_depth=True)
    mesh.traffic.update(collectives=0, bytes=0)
    ts, m = step(ts, *_view(p, 0), torch.zeros(3), p["xyz_lr"], p["lambda_opacity"])
    return {"metrics": _metrics(m), "traffic": dict(mesh.traffic), "state": _full(ts, mesh),
            "local_rows": ts.model.params.capacity}


def step_render_densify_grow(mesh, p: dict) -> dict:
    """tests/test_torch_gauss_shard.py on G ranks: the sharded step, the
    sharded render of ``p["render"]`` with fixed colors, the layout of a
    shard, the sharded densify pass and capacity growth."""
    mesh = _gauss(mesh)
    k, g = mesh.rank, mesh.size
    out = {"step": _sharded_step(mesh, p)}

    ts = _train_state(p)
    local = gs.shard_train_state(ts, mesh)
    n = local.model.params.capacity
    rows = slice(k * n, (k + 1) * n)
    out["layout"] = {
        "rows": n,
        "xyz": bool(torch.equal(local.model.params.xyz, ts.model.params.xyz[rows])),
        "mu": bool(torch.equal(local.opt.mu.xyz, ts.opt.mu.xyz[rows])),
        "alive": bool(torch.equal(local.model.aux.alive, ts.model.aux.alive[rows])),
        "camera_table": (None if ts.model.params.appearance_embeddings is None else
                         tuple(local.model.params.appearance_embeddings.shape))}

    r = p["render"]
    model = gs.shard_train_state(init_train_state(tg.state_from_numpy(r["state"])), mesh).model
    prm = model.params
    with torch.no_grad():
        o = gs.sharded_render_merge(
            mesh, prm.xyz, tg.get_scaling(prm), prm.rotation, tg.get_opacity(prm),
            torch.full((prm.capacity, 3), 0.5), model.aux.alive,
            camera_from_arrays(r["camera"]), torch.zeros(3), 0.1)
    out["render"] = {"color": o.color.numpy(), "overflow": int(o.overflow)}

    d = p["densify"]
    dense = gs.shard_train_state(_train_state(d), mesh)
    gen = torch.Generator().manual_seed(100 + k)
    stats = gs.make_sharded_densify(mesh, **d["kwargs"])(dense, gen)
    out["densify"] = {"stats": {f: int(v) for f, v in zip(DensifyStats._fields, stats)},
                      "state": _full(dense, mesh)}

    grown = gs.sharded_grow_capacity(gs.shard_train_state(_train_state(p), mesh), mesh,
                                     p["grow_to"])
    out["grow"] = {"rows": grown.model.params.capacity, "state": _full(grown, mesh)}
    try:
        gs.sharded_grow_capacity(grown, mesh, p["grow_to"] + 1)
    except ValueError as e:
        out["grow"]["indivisible"] = str(e)
    return out


def step_and_grid(mesh, p: dict) -> dict:
    """On 4 ranks: the 4-shard step, then the (2, 2) grid step (rank d*2+g
    trains view d with shard g) beside the view-parallel step of the same
    two views on the grid's data column (the full state on each rank)."""
    out = {"step": _sharded_step(_gauss(mesh), p)}
    data, gauss = grid_meshes(mesh, (2, 2))
    d = data.rank
    local = gs.shard_train_state(_train_state(p), gauss)
    grid = gs.make_grid_train_step(data, gauss, OptimizationConfig(), use_depth=True)
    local, m = grid(local, *_view(p, d), torch.zeros(3), p["xyz_lr"], p["lambda_opacity"])
    out["grid"] = {"metrics": _metrics(m), "state": _full(local, gauss),
                   "data_rank": d, "gauss_rank": gauss.rank}
    view = make_parallel_train_step(data, OptimizationConfig(), use_depth=True)
    ts, m = view(_train_state(p), *_view(p, d), torch.zeros(3), p["xyz_lr"],
                 p["lambda_opacity"])
    out["view"] = {"metrics": _metrics(m), "state": _host_state(ts)}
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_checkpoint_sharded.py
# ----------------------------------------------------------------------------

def _zeroed(ts):
    """A template of the same shapes with every tensor zero (a restore must
    write all of it)."""
    for part in (ts.model.params, ts.model.aux, ts.opt.mu, ts.opt.nu):
        for _, t in tg.flat_fields(part):
            t.zero_()
    ts.step, ts.opt.count = 0, 0
    return ts


def checkpoint_roundtrip(mesh, p: dict) -> dict:
    """Save the shards of ``p``'s state (and of its grown copy) from every
    rank, then restore each into zeroed shards on this mesh."""
    mesh = _gauss(mesh)
    root = p["root"]
    ts = gs.shard_train_state(_train_state(p), mesh)
    ts.step, ts.opt.count = p["step"], p["count"]
    cks.save_checkpoint_sharded(os.path.join(root, "plain.orbax"), ts, p["iteration"], mesh)
    grown = gs.sharded_grow_capacity(ts, mesh, p["grow_to"])
    cks.save_checkpoint_sharded(os.path.join(root, "grown.orbax"), grown, p["iteration"], mesh)
    out = {"saved": _full(ts, mesh), "grown": _full(grown, mesh)}
    for name in ("plain", "grown"):
        tmpl = gs.shard_train_state(_zeroed(_train_state(p)), mesh)
        if name == "grown":
            tmpl = gs.sharded_grow_capacity(tmpl, mesh, p["grow_to"])
        tmpl, it = cks.load_checkpoint_sharded(os.path.join(root, f"{name}.orbax"), tmpl, mesh)
        out[f"restored_{name}"] = {"state": _full(tmpl, mesh), "iteration": it,
                                   "sh": tmpl.model.active_sh_degree}
    return out


# ----------------------------------------------------------------------------
# tests/test_torch_trainer_gauss.py
# ----------------------------------------------------------------------------

def _trainer(mesh, p: dict, name: str, pipe: dict = None, ray_jitter: bool = True, **opt):
    from skyfall_gs_tpu_torch.train import loop as tloop
    from tests.torch_ranks import scene_from_arrays

    base = dict(p["opt"])
    base.update(opt)
    return tloop.Trainer(ModelConfig(model_path=os.path.join(p["root"], name),
                                     ray_jitter=ray_jitter),
                         OptimizationConfig(**base), PipelineConfig(**(pipe or {})),
                         scene_from_arrays(p["scene"], mesh.device), mesh=mesh,
                         mesh_mode="gauss")


def trainer_runs(mesh, p: dict) -> dict:
    """A G-rank Trainer held against JAX's (no densify, no ray jitter);
    one with densify and growth; a checkpoint at a pinned capacity resumed
    into a fresh Trainer (growth into the shards); one IDU episode."""
    from skyfall_gs_tpu_torch.priors import IdentityRefiner, RenderDepthPredictor
    from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator

    mesh = _gauss(mesh)
    t = _trainer(mesh, p, "vs_jax", ray_jitter=False)
    s = t.train(t.init_state(), iterations=p["iters"])
    out = {"vs_jax": {"state": _full(s, mesh), "py_rng": t.py_rng.getstate()}}
    t = _trainer(mesh, p, "densify", **p["densify_opt"])
    s0 = t.init_state()
    cap0 = s0.model.params.capacity * mesh.size
    losses = []
    if t.logger:
        t.logger.log_step = lambda it, m, el: losses.append(float(m.loss))
    s = t.train(s0, iterations=p["densify_iters"])
    out["densify"] = {"state": _full(s, mesh), "cap0": cap0, "losses": losses,
                      "overflow": int(t.max_overflow)}

    t = _trainer(mesh, p, "resume", pipe={"gaussian_capacity": p["pinned_capacity"]})
    s = t.train(t.init_state(), iterations=p["resume_at"],
                checkpoint_iterations=(p["resume_at"],))
    ckpt = os.path.join(p["root"], "resume", f"chkpnt{p['resume_at']}.orbax")
    t2 = _trainer(mesh, p, "resumed")
    fresh = t2.init_state().model.params.capacity * mesh.size
    s2 = t2.init_state(start_checkpoint=ckpt)
    out["resume"] = {"saved": _full(s, mesh), "restored": _full(s2, mesh), "fresh": fresh,
                     "start": t2.start_iteration, "rows": s2.model.params.capacity}

    t = _trainer(mesh, p, "idu", **p["idu_opt"])
    t._gen_pseudo_stack_at = _small_pseudo_stack
    orch = IDUOrchestrator(trainer=t, refiner=IdentityRefiner(),
                           depth_predictor=RenderDepthPredictor())
    s = orch.train_episode(t.init_state(), 0, [[0.0, 0.0, 0.0]], 60.0, 3.0, 60.0)
    out["idu"] = {"state": _full(s, mesh), "max_overflow": orch.max_overflow,
                  "local_digest": state_digest(s)}
    return out
