"""Rank programs for the view-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_trainer_mesh.py).

``parallel.mesh.launch`` runs these module-level functions in spawned
ranks, and a spawned rank imports the module that holds its program, so
this module imports the port and never JAX: the JAX side of each
comparison runs in the test process and reaches a rank as numpy arrays.
Every program returns host values (numpy arrays, floats, strings).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu_torch.core.camera import Camera, band_camera, orbit_cameras
from skyfall_gs_tpu_torch.io.scene import SceneData, View
from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.render import render
from skyfall_gs_tpu_torch.parallel.sharding import (
    make_parallel_render,
    make_parallel_train_step,
    make_tile_parallel_render,
    state_digest,
)
from skyfall_gs_tpu_torch.train import idu as tidu
from skyfall_gs_tpu_torch.train import loop as tloop
from skyfall_gs_tpu_torch.train.step import init_train_state

_CAMERA_TENSORS = ("world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy",
                   "focal_x", "focal_y", "cx", "cy")


def camera_from_arrays(d: dict, device="cpu") -> Camera:
    """A port camera from the numpy fields of a JAX camera."""
    return Camera(**{k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
                     for k in _CAMERA_TENSORS},
                  uid=int(d["uid"]), znear=float(d["znear"]), zfar=float(d["zfar"]),
                  width=int(d["width"]), height=int(d["height"]))


def scene_from_arrays(d: dict, device) -> SceneData:
    """A port scene from the host arrays of a JAX ``SceneData``."""
    def views(vs):
        return [View(camera=camera_from_arrays(v["camera"]), image=v["image"],
                     mask=v["mask"], depth=v["depth"], image_name=v["name"]) for v in vs]

    scene = SceneData(source_path=d["source_path"], scene_type=d["scene_type"],
                      points=d["points"], colors=d["colors"],
                      train_views=views(d["train"]), test_views=views(d["test"]),
                      cameras_extent=d["extent"], device=str(device))
    scene.build_groups()
    return scene


def _host_state(ts) -> dict:
    return {"params": {k: v.numpy().copy() for k, v in tg.flat_fields(ts.model.params)},
            "mu": {k: v.numpy().copy() for k, v in tg.flat_fields(ts.opt.mu)},
            "nu": {k: v.numpy().copy() for k, v in tg.flat_fields(ts.opt.nu)},
            "aux": {k: v.numpy().copy() for k, v in tg.flat_fields(ts.model.aux)},
            "step": ts.step, "count": ts.opt.count, "digest": state_digest(ts)}


# ----------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ----------------------------------------------------------------------------

def step_and_renders(mesh, p: dict) -> dict:
    """One view-parallel step from ``p["state"]`` (rank r trains view r),
    then the tile-parallel render of ``p["render_camera"]`` (one band per
    rank) beside the full render, and the parallel render of the step's
    cameras beside each camera rendered alone."""
    r = mesh.rank
    ts = init_train_state(tg.state_from_numpy(p["state"]))
    step = make_parallel_train_step(mesh, OptimizationConfig(), use_depth=True)
    ts, m = step(ts, camera_from_arrays(p["cameras"][r]),
                 *(torch.from_numpy(p[k][r]) for k in ("images", "masks", "depths")),
                 torch.zeros(3), p["xyz_lr"], p["lambda_opacity"])
    out = {"state": _host_state(ts),
           "metrics": {k: float(getattr(m, k)) for k in m._fields}}

    model = tg.state_from_numpy(p["render_state"])
    bg = torch.zeros(3)
    cam = camera_from_arrays(p["render_camera"])
    out["tile"] = make_tile_parallel_render(mesh)(model, band_camera(cam, r, mesh.size),
                                                  bg).numpy()
    out["full"] = render(model, cam, bg, testing=True, inference=True).color.numpy()
    cams = [camera_from_arrays(c) for c in p["cameras"]]
    colors, depths = make_parallel_render(mesh)(model, cams[r], bg)
    alone = [render(model, c, bg, testing=True) for c in cams]
    out["parallel"] = (colors.numpy(), depths.numpy())
    out["alone"] = (np.stack([o.color.detach().numpy() for o in alone]),
                    np.stack([o.depth.detach().numpy() for o in alone]))
    return out


def fail_on_last_rank(mesh, wait_s: float = 60.0) -> int:
    """The last rank raises; the others stay busy for ``wait_s`` (outside
    any collective, so the last rank's error is the launch's first)."""
    if mesh.rank == mesh.size - 1:
        raise ValueError("rank failed on purpose")
    time.sleep(wait_s)
    return mesh.rank


def sleep_past_the_join(mesh, seconds: float) -> int:
    time.sleep(seconds)
    return mesh.rank


# ----------------------------------------------------------------------------
# tests/test_torch_trainer_mesh.py
# ----------------------------------------------------------------------------

def _trainer(mesh, p: dict, name: str, ray_jitter: bool = False, **opt) -> tloop.Trainer:
    scene = scene_from_arrays(p["scene"], mesh.device)
    base = dict(p["opt"])
    base.update(opt)
    return tloop.Trainer(ModelConfig(model_path=os.path.join(p["root"], name),
                                     ray_jitter=ray_jitter),
                         OptimizationConfig(**base), PipelineConfig(), scene, mesh=mesh)


def _small_pseudo_stack(ele, rad):
    return orbit_cameras([0, 0, 0], ele, 3.0, num_cams=4, width=32, height=32,
                         fov_deg=60.0, uids=[0] * 4)


def _linear_depth(img):
    return np.linspace(1.0, 2.0, img.shape[0] * img.shape[1],
                       dtype=np.float32).reshape(img.shape[:2])


class _Writes:
    """Counts the calls of the functions that write an episode's files."""

    def __init__(self):
        self.calls = []
        self._saved = []
        for mod, name in ((tidu, "_save_frames"), (tidu, "save_checkpoint"),
                          (tloop.Trainer, "save_ply")):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.calls.append(_name)
                return _fn(*a, **k)
            setattr(mod, name, wrapped)

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class _PausingGUI:
    """A viewer stand-in on rank 0: its poll holds training for ``seconds``
    at its ``pause_at``-th call, as a paused SIBR viewer does."""

    def __init__(self, pause_at: int, seconds: float):
        self.pause_at, self.seconds, self.calls = pause_at, seconds, 0
        self.window = None

    def poll(self, render_fn, source_path, training_active, device="cpu"):
        self.calls += 1
        if self.calls == self.pause_at:
            t0 = time.time()
            time.sleep(self.seconds)
            self.window = (t0, time.time())
        return True


def trainer_runs(mesh, p: dict) -> dict:
    """The Trainer on a view mesh: the run held against JAX's 2-device
    Trainer; densify with pseudo views; an IDU episode; a viewer pause on
    rank 0."""
    out = {}

    # Against JAX: no densify, no jitter.
    t = _trainer(mesh, p, "vs_jax")
    picks = []
    pick = t._pick_step

    def recorded():
        g, i = pick()
        picks.append([g.names[j] for j in i])
        return g, i

    t._pick_step = recorded
    s = t.train(t.init_state(), iterations=p["iters"])
    out["vs_jax"] = {"state": _host_state(s), "picks": picks,
                     "py_rng": t.py_rng.getstate()}

    # Densify, pseudo views and ray jitter (tests/test_trainer_mesh.py:153-186).
    t = _trainer(mesh, p, "densify", ray_jitter=True, **p["densify_opt"])
    t.depth_predictor = _linear_depth
    t._gen_pseudo_stack_at = _small_pseudo_stack
    losses = []
    if t.logger:
        t.logger.log_step = lambda it, m, el: losses.append(float(m.loss))
    s = t.train(t.init_state(), iterations=p["densify_iters"])
    out["densify"] = {"state": _host_state(s), "losses": losses,
                      "overflow": int(t.max_overflow)}

    # One IDU episode (tests/test_trainer_mesh.py:117-151).
    from skyfall_gs_tpu_torch.priors import IdentityRefiner, RenderDepthPredictor

    t = _trainer(mesh, p, "idu", **p["idu_opt"])
    t._gen_pseudo_stack_at = _small_pseudo_stack
    writes = _Writes()
    try:
        orch = tidu.IDUOrchestrator(trainer=t, refiner=IdentityRefiner(),
                                    depth_predictor=RenderDepthPredictor())
        s = orch.train_episode(t.init_state(), 0, [[0.0, 0.0, 0.0]], 60.0, 3.0, 60.0)
    finally:
        writes.restore()
    out["idu"] = {"state": _host_state(s), "writes": writes.calls,
                  "episode": orch.episodes[-1], "max_overflow": orch.max_overflow}

    # A viewer pause on rank 0 holds every rank.
    t = _trainer(mesh, p, "pause")
    if mesh.is_main:
        t.gui = _PausingGUI(pause_at=3, seconds=p["pause_s"])
    starts = []
    pick = t._pick_step

    def timed():
        starts.append(time.time())
        return pick()

    t._pick_step = timed
    s = t.train(t.init_state(), iterations=5)
    out["pause"] = {"starts": starts, "window": t.gui.window if t.gui else None,
                    "digest": state_digest(s)}
    return out
