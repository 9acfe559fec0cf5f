"""Stage-1 training orchestration: the host-side curriculum around the step.

Port of the single-device ``Trainer`` of ``skyfall_gs_tpu/train/loop.py``,
line for line in its curriculum:
  * random view sampling from ``random.Random(rng_seed)`` with the optional
    30% high-res resampling and a push-back stack, so with the same seed
    the port picks the same views as the JAX Trainer;
  * SH degree +1 every 1000 iterations; the scheduled xyz LR;
  * densify every ``densification_interval`` iterations inside
    (``densify_from_iter``, ``densify_until_iter``) after growing capacity
    host-side to keep ``free >= max(n_alive, 2048)``, then the 3D filter
    recompute and the binning-capacity re-measure (with hysteresis);
  * opacity reset every ``opacity_reset_interval`` iterations (and at
    ``densify_from_iter`` on a white background) with the
    ``lambda_opacity`` cooldown;
  * pseudo-view monodepth supervision: every ``sample_pseudo_interval``
    iterations inside (``start_sample_pseudo``, ``end_sample_pseudo``) a
    camera popped at random from a stack of orbit rings (elevation 80 -> 45,
    radius 300 -> 250 over the window, regenerated when it empties) is
    rendered, its depth predicted by ``depth_predictor`` and the step adds
    the warm-up scaled Pearson term; the stack and the pops draw from the
    same ``py_rng`` stream as the JAX Trainer;
  * 3D filter refresh every 100 iterations after densification;
  * step metrics through the MetricsLogger, test renders, PLY snapshots
    and checkpoints at milestones; with ``profile_dir``, a torch.profiler
    window of ``profile_steps`` iterations: its chrome trace with the
    program's spans (``utils/trace.py``) and their totals in ``metrics.jsonl``;
  * with a live viewer (``gui``), a poll before every iteration that
    serves its frames and holds training while the viewer pauses it.

The loop reads the device only where the JAX Trainer does: ``num_alive``
at each densify pass, binning-capacity measurements after it, the pseudo
view's render handed to the depth predictor, and the logger's flush,
reports and snapshots, and each viewer frame's overflow count.

``pipe_cfg.fuse_steps`` is accepted and ignored: the JAX Trainer fuses
runs of steps into one ``lax.scan`` dispatch to amortize TPU dispatch
overhead, and fused and unfused JAX training are step-for-step identical,
so the port runs the unfused loop (a CUDA graph is the GPU's answer to
launch overhead).

View-parallel training (``mesh``, a ``parallel.mesh.ViewMesh``, with
``mesh_mode="view"``): each rank runs this Trainer on its own device with
the same ``rng_seed``, so every rank makes the same host draws.  Each
iteration is one B-view step (``parallel.sharding.make_parallel_train_step``,
B = the mesh size): the lead view is picked exactly as the single-device
stream picks it, the other B-1 uniformly from the lead's group, and rank r
trains column r.  The state is replicated: the ranks start from rank 0's
state, the combined gradients and statistics are the same bits on every
rank, densify's split draws come from a generator seeded alike on every
rank, and each measured binning capacity is the ranks' maximum.  Ray jitter
comes from a per-rank generator (rank 0's is seeded as the single-device
Trainer's, the counterpart of JAX's ``fold_in(key, axis_index)``).  Logs,
reports, PLYs and checkpoints are written by rank 0 alone; a viewer is
polled on rank 0 while the other ranks wait (a pause holds every rank).

Gaussian-sharded training (``mesh_mode="gauss"``): each rank holds a row
shard of the splat state (``parallel.gauss_shard``) and every iteration is
one view rendered by all of them, each compositing one depth bin.  Every
rank makes the same host draws and trains the same view.  The conventions
flip from the view mesh: the ray jitter is the same on every rank (each
composites a bin of the same image), and densify's split draws differ per
rank (rank 0's seeded as the single-device Trainer's, the counterpart of
JAX's ``fold_in(rng, axis_index)``).  The capacity is rounded up to a
multiple of the mesh size and sharded at ``init_state``; a binning
capacity is measured over every shard's splats; the 3D filter, densify's
ratio and quantile, and capacity growth (pad slots spread evenly) run on
the shards with collectives.  Checkpoints are ``chkpnt<it>.orbax``
directories that every rank writes its rows into
(``train/checkpoint_sharded.py``); test renders, PLYs and a viewer's frames
come from the state gathered on every rank (``gather_train_state``) and
are rank 0's.
"""

from __future__ import annotations

import functools
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu_torch.core.camera import Camera, orbit_cameras
from skyfall_gs_tpu_torch.eval.lpips import lpips_from_local_packages
from skyfall_gs_tpu_torch.io.gaussian_ply import save_gaussian_ply
from skyfall_gs_tpu_torch.io.scene import SceneData, ViewGroup
from skyfall_gs_tpu_torch.model.appearance import AppearanceConfig
from skyfall_gs_tpu_torch.model.densify import densify_and_prune, grow_capacity
from skyfall_gs_tpu_torch.model.gaussians import (
    camera_filter_arrays,
    compute_3d_filter,
    create_from_points,
    get_opacity,
    reset_opacity,
)
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
from skyfall_gs_tpu_torch.ops.losses import psnr as psnr_fn
from skyfall_gs_tpu_torch.parallel.gauss_shard import (
    gather_train_state,
    make_gauss_sharded_train_step,
    shard_train_state,
    sharded_grow_capacity,
    sharded_render,
)
from skyfall_gs_tpu_torch.parallel.mesh import ViewMesh
from skyfall_gs_tpu_torch.parallel.sharding import broadcast_state_, make_parallel_train_step
from skyfall_gs_tpu_torch.train.checkpoint import (
    load_checkpoint,
    peek_checkpoint_meta,
    save_checkpoint,
)
from skyfall_gs_tpu_torch.train.checkpoint_sharded import (
    load_checkpoint_sharded,
    peek_checkpoint_meta_sharded,
    save_checkpoint_sharded,
)
from skyfall_gs_tpu_torch.train.logging import MetricsLogger
from skyfall_gs_tpu_torch.train.step import (
    TrainState,
    init_train_state,
    make_eval_render,
    make_train_step,
)
from skyfall_gs_tpu_torch.utils.general import expon_lr_schedule, stream_seed
from skyfall_gs_tpu_torch.utils.trace import report, span
from skyfall_gs_tpu_torch.viz.colormap import colorize_depth
from skyfall_gs_tpu_torch.viz.network_gui import NetworkGUI


@dataclass
class Trainer:
    """Drives Stage-1 training for one scene on the scene's device.

    ``depth_predictor`` maps an (H, W, 3) float32 frame in [0, 1] to an
    (H, W) depth (a ``priors`` depth backend); with ``lambda_pseudo_depth
    > 0`` it drives the pseudo-view supervision.

    ``use_lpips_loss`` swaps SSIM for LPIPS (``lpips_net``) in the
    photometric term; the scorer is ``_lpips`` where the caller set one,
    else ``eval.lpips.lpips_from_local_packages``, which raises
    ``RuntimeError`` where no local LPIPS weights exist.

    ``gui`` (a ``viz.network_gui.NetworkGUI``) is polled before every
    iteration; its frames are rendered at a binning capacity measured for
    the request's camera, again whenever a frame overflows.

    ``mesh`` (a ``parallel.mesh.ViewMesh``) trains view-parallel with
    ``mesh_mode="view"`` and gaussian-sharded with ``"gauss"`` (module
    docstring); the scene must lie on the mesh's device.  A
    ``start_checkpoint`` is a ``.npz`` file or a sharded ``.orbax``
    directory, restored into either mode.
    """

    model_cfg: ModelConfig
    opt_cfg: OptimizationConfig
    pipe_cfg: PipelineConfig
    scene: SceneData
    depth_predictor: Optional[Callable] = None
    logger: Optional[MetricsLogger] = None
    rng_seed: int = 0
    gui: Optional[NetworkGUI] = None
    profile_dir: Optional[str] = None   # torch.profiler chrome trace output
    profile_steps: int = 20
    mesh: Optional[ViewMesh] = None
    mesh_mode: str = "view"

    def __post_init__(self):
        cfg, o = self.model_cfg, self.opt_cfg
        if self.mesh_mode not in ("view", "gauss"):
            raise ValueError(f"mesh_mode {self.mesh_mode!r}: 'view' or 'gauss'")
        self.device = torch.device(self.scene.device)
        self.rank = self.mesh.rank if self.mesh is not None else 0
        # The gauss mesh, or None; B views per step on a view mesh, else 0.
        self._gauss = self.mesh if self.mesh_mode == "gauss" else None
        self._mesh_B = self.mesh.size if self.mesh is not None and self._gauss is None else 0
        if self.mesh is not None and torch.device(self.mesh.device) != self.device:
            raise ValueError(f"the scene lies on {self.device}, the mesh rank on "
                             f"{self.mesh.device}")
        self.appearance = AppearanceConfig(
            enabled=cfg.appearance_enabled,
            n_fourier_freqs=cfg.appearance_n_fourier_freqs,
            embedding_dim=cfg.appearance_embedding_dim,
        )
        self.bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
                               device=self.device)
        self.py_rng = random.Random(self.rng_seed)
        # Ray-jitter draws: per rank on a view mesh, alike on a gauss mesh.
        # Densify's split offsets: alike on a view mesh, per rank on a gauss
        # mesh.  Rank 0's are the single-device Trainer's either way.
        per_rank = self.rank != 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.rng_seed, 1, self.rank) if per_rank and self._mesh_B
            else self.rng_seed)
        self.split_generator = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.rng_seed, 2, self.rank) if per_rank and self._gauss is not None
            else stream_seed(self.rng_seed, 2))
        self._step_fns = {}
        self._pick_pushbacks = []
        self.bin_capacity = int(self.pipe_cfg.bin_capacity) or None
        self._eval_caps = {}   # (h, w) -> measured render capacity
        if self.rank != 0:
            self.logger = None
        elif self.logger is None:
            self.logger = MetricsLogger(cfg.model_path)
        self.filter_cams = camera_filter_arrays([v.camera for v in self.scene.train_views])
        self.flat_index = [(key, i) for key, g in self.scene.train_groups.items()
                           for i in range(g.size)]
        self.highres_index = [(k, i) for (k, i) in self.flat_index if k[1] >= 800]
        self.start_iteration = 0
        # The largest binning overflow of any training step so far, kept on
        # the device (the logger sees only every log_every-th step).
        self.max_overflow = torch.zeros((), dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, start_checkpoint: Optional[str] = None) -> TrainState:
        cap = self.pipe_cfg.gaussian_capacity or None
        model = create_from_points(
            self.scene.points, self.scene.colors,
            max_sh_degree=self.model_cfg.sh_degree, appearance=self.appearance,
            num_cameras=self.scene.num_train, spatial_lr_scale=self.scene.cameras_extent,
            capacity=cap, seed=self.rng_seed, device=self.device)
        state = init_train_state(model)
        self.start_iteration = 0
        sharded = ckpt_cap = None
        if start_checkpoint:
            sharded = start_checkpoint.endswith(".orbax") or os.path.isdir(start_checkpoint)
            ckpt_cap = (peek_checkpoint_meta_sharded if sharded
                        else peek_checkpoint_meta)(start_checkpoint)["capacity"]
        if self._gauss is not None:
            return self._init_shard(state, start_checkpoint, sharded, ckpt_cap)
        if start_checkpoint:
            if ckpt_cap != model.params.capacity:
                state.model, state.opt = grow_capacity(state.model, state.opt, ckpt_cap)
            load = load_checkpoint_sharded if sharded else load_checkpoint
            state, self.start_iteration = load(start_checkpoint, state)
        if self.mesh is not None:
            broadcast_state_(state, self.mesh)
        self._refresh_filter(state)
        return state

    def _init_shard(self, state: TrainState, ckpt: Optional[str], sharded: bool,
                    cap: Optional[int]) -> TrainState:
        """This rank's shard of the initial state on a gauss mesh.  A
        sharded checkpoint restores into shards of the fresh state grown to
        its capacity, so no rank holds the full capacity; a ``.npz`` one
        loads whole and is sharded after.  The capacity is rounded up to a
        multiple of the mesh size."""
        mesh = self._gauss
        g = mesh.size
        if sharded and cap % g:
            raise ValueError(f"sharded checkpoint capacity {cap} is not divisible by the "
                             f"{g}-shard gauss mesh; restore on a mesh size that divides it")
        if ckpt and not sharded:
            if cap != state.model.params.capacity:
                state.model, state.opt = grow_capacity(state.model, state.opt, cap)
            state, self.start_iteration = load_checkpoint(ckpt, state)
        n = state.model.params.capacity
        if n % g:
            state.model, state.opt = grow_capacity(state.model, state.opt, -(-n // g) * g)
        state = shard_train_state(state, mesh)
        if sharded:
            state = sharded_grow_capacity(state, mesh, cap)
            state, self.start_iteration = load_checkpoint_sharded(ckpt, state, mesh)
        self._refresh_filter(state)
        return state

    def _refresh_filter(self, state: TrainState) -> None:
        m = state.model
        m.aux.filter_3d.copy_(compute_3d_filter(m.params.xyz, m.aux.alive,
                                                *self.filter_cams, mesh=self._gauss))

    # ------------------------------------------------------------------
    def _get_step_fn(self, use_depth: bool, use_pseudo: bool = False,
                     photometric: bool = True, testing_render: bool = False):
        """The step for one kind of view (cached per kind and capacity):
        Stage-1 views take the defaults; the IDU orchestrator's views set
        ``photometric`` and ``testing_render`` from its options."""
        lpips_fn = self._get_lpips().score if self.opt_cfg.use_lpips_loss else None
        key = (use_depth, use_pseudo, photometric, testing_render, self.bin_capacity, lpips_fn)
        if key not in self._step_fns:
            if self.mesh is None:
                build = make_train_step
            else:
                build = functools.partial(make_gauss_sharded_train_step if self._gauss
                                          else make_parallel_train_step, self.mesh)
            self._step_fns[key] = build(
                self.opt_cfg, kernel_size=self.model_cfg.kernel_size,
                backend=self.pipe_cfg.rasterizer_backend,
                ray_jitter=self.model_cfg.ray_jitter,
                resample_gt=self.model_cfg.resample_gt_image,
                use_depth=use_depth, use_pseudo=use_pseudo, photometric=photometric,
                testing_render=testing_render, bin_capacity=self.bin_capacity,
                lpips_fn=lpips_fn)
        return self._step_fns[key]

    def _get_lpips(self):
        """The LPIPS photometric-loss scorer on the scene's device (reference
        train.py:80-85): ``self._lpips`` where already set, else built once
        from local weights (``lpips_from_local_packages`` raises without)."""
        if getattr(self, "_lpips", None) is None:
            self._lpips = lpips_from_local_packages(self.opt_cfg.lpips_net, device=self.device)
        return self._lpips

    def _update_bin_capacity(self, state: TrainState) -> None:
        """Right-size the binning capacity from the worst train view's
        measured entry count (``capacity_for_entries``: 1.2x headroom in
        64k buckets).  Every train view is measured, where the JAX Trainer
        measures the first view of each resolution group only and relies
        on the headroom to cover the others."""
        if self.pipe_cfg.bin_capacity:
            self.bin_capacity = int(self.pipe_cfg.bin_capacity)
            return
        self.bin_capacity = self._measure(
            state.model, [c for g in self.scene.train_groups.values() for c in g.cameras])
        # Eval capacities were measured against the old splat set.
        self._eval_caps.clear()

    def _eval_render(self, model, camera, bg):
        """No-grad render with a binning capacity measured for the camera's
        resolution, cached per resolution until the next re-measure."""
        key = (camera.height, camera.width)
        if key not in self._eval_caps:
            self._eval_caps[key] = measure_bin_capacity(
                model, [camera], kernel_size=self.model_cfg.kernel_size)
        return make_eval_render(self.model_cfg.kernel_size,
                                self.pipe_cfg.rasterizer_backend,
                                bin_capacity=self._eval_caps[key])(model, camera, bg)

    def _measure(self, model, cameras) -> int:
        """A training step's binning capacity for ``cameras``: on a view
        mesh the ranks' maximum (so no rank bins differently), on a gauss
        mesh over every shard's splats (the same on every rank)."""
        cap = measure_bin_capacity(model, cameras, kernel_size=self.model_cfg.kernel_size,
                                   mesh=self._gauss)
        return self.mesh.max_int(cap) if self._mesh_B else cap

    def _full(self, state: TrainState) -> TrainState:
        """The whole state: gathered from the shards on a gauss mesh (a
        collective: every rank calls it), ``state`` itself otherwise."""
        return state if self._gauss is None else gather_train_state(state, self._gauss)

    def _push_back_pick(self, pick) -> None:
        """Return an unconsumed pick to the front of the stream."""
        self._pick_pushbacks.append(pick)

    def _pick_step(self):
        """One step's views: ``(group, index)`` on one device; on a mesh
        ``(group, [B indices])``, the lead drawn as the single-device stream
        draws it and the other B-1 uniformly from the lead's group (iid,
        with replacement), the whole row at once."""
        g, i = self._pick_view()
        if not self._mesh_B or isinstance(i, list):
            return g, i
        return g, [i] + [self.py_rng.randrange(g.size) for _ in range(self._mesh_B - 1)]

    def _own(self, i):
        """This rank's column of a pick (the pick itself on one device)."""
        return i[self.rank] if self._mesh_B else i

    def _pick_view(self):
        if self._pick_pushbacks:
            return self._pick_pushbacks.pop()
        key, i = self.py_rng.choice(self.flat_index)
        if (self.model_cfg.sample_more_highres and self.highres_index
                and self.py_rng.random() < 0.3):
            key, i = self.py_rng.choice(self.highres_index)
        g: ViewGroup = self.scene.train_groups[key]
        return g, i

    # ------------------------------------------------------------------
    def _pseudo_at(self, j: int) -> bool:
        o = self.opt_cfg
        return (o.lambda_pseudo_depth > 0 and self.depth_predictor is not None
                and j % o.sample_pseudo_interval == 0
                and o.start_sample_pseudo < j < o.end_sample_pseudo)

    def _pseudo_curriculum(self, iteration: int):
        o = self.opt_cfg
        span = max(o.end_sample_pseudo - o.start_sample_pseudo, 1)
        t = (o.end_sample_pseudo - iteration) / span
        return t * (80.0 - 45.0) + 45.0, t * (300.0 - 250.0) + 250.0

    def _gen_pseudo_stack(self, iteration: int) -> list:
        return self._gen_pseudo_stack_at(*self._pseudo_curriculum(iteration))

    def _gen_pseudo_stack_at(self, elevation: float, radius: float) -> list:
        """``num_pseudo_cams // 8`` rings of 8 cameras at 512x512, each
        ring around a Gaussian-drawn target and under a random train uid."""
        o = self.opt_cfg
        cams = []
        for _ in range(max(o.num_pseudo_cams // 8, 1)):
            target = [self.py_rng.gauss(0.0, o.target_std),
                      self.py_rng.gauss(0.0, o.target_std), 0.0]
            uid = self.py_rng.randrange(max(self.scene.num_train, 1))
            cams.extend(orbit_cameras(target, elevation, radius, num_cams=8, num_samples=1,
                                      width=512, height=512, fov_deg=60.0, uids=[uid] * 8,
                                      device=self.device))
        return cams

    def _pseudo_inputs(self, state: TrainState, camera: Camera, predictor,
                       scale: float) -> dict:
        """The step's ``pseudo_*`` arguments for ``camera``: its render (at a
        capacity measured for it) through ``predictor`` on the host.  On a
        gauss mesh every rank renders it with the shards and runs the
        predictor."""
        ks = self.model_cfg.kernel_size
        cap = measure_bin_capacity(state.model, [camera], kernel_size=ks, mesh=self._gauss)
        if self._gauss is None:
            out = make_eval_render(ks, self.pipe_cfg.rasterizer_backend,
                                   bin_capacity=cap)(state.model, camera, self.bg)
        else:
            with torch.no_grad():
                out = sharded_render(self._gauss, state.model, camera, self.bg, kernel_size=ks,
                                     testing=True, bin_capacity=cap, inference=True)
        depth = predictor(torch.clamp(out.color, 0.0, 1.0).cpu().numpy())
        return {"pseudo_camera": camera,
                "pseudo_gt_depth": torch.as_tensor(np.asarray(depth, np.float32),
                                                   device=self.device),
                "pseudo_scale": scale, "pseudo_bin_capacity": cap}

    # ------------------------------------------------------------------
    def train(self, state: Optional[TrainState] = None,
              iterations: Optional[int] = None,
              test_iterations: tuple = (),
              save_iterations: tuple = (),
              checkpoint_iterations: tuple = ()) -> TrainState:
        o = self.opt_cfg
        cfg = self.model_cfg
        if state is None:
            state = self.init_state()
        iterations = iterations or o.iterations
        xyz_sched = expon_lr_schedule(
            o.position_lr_init * state.model.spatial_lr_scale,
            o.position_lr_final * state.model.spatial_lr_scale,
            lr_delay_mult=o.position_lr_delay_mult,
            max_steps=o.position_lr_max_steps,
        )
        lambda_opacity = o.lambda_opacity
        cooldown = None
        pseudo_stack: list = []
        t_start = time.time()
        first_iter = self.start_iteration + 1
        if self.bin_capacity is None:
            self._update_bin_capacity(state)
        prof = None
        prof_start = first_iter + 20 if self.profile_dir else -1
        prof_stop = prof_start + self.profile_steps if self.profile_dir else -1
        use_gui = self._has_gui()

        for iteration in range(first_iter, iterations + 1):
            # The profiled window is whole iterations: prof_start .. prof_stop - 1.
            if iteration == prof_start:
                prof = self._start_profiler()
            elif iteration == prof_stop and prof is not None:
                self._stop_profiler(prof, iteration - 1)
                prof = None
            with span("train.iteration", iteration):
                if use_gui:
                    self._on_main(self._poll_gui, self._full(state), iteration < iterations)
                if cooldown is not None:
                    if cooldown > 0:
                        cooldown -= 1
                    else:
                        cooldown = None
                        lambda_opacity = o.lambda_opacity
                if iteration % 1000 == 0:
                    state.model.one_up_sh_degree()

                g, i = self._pick_step()
                use_depth = o.lambda_depth > 0 and g.has_depth
                use_pseudo = self._pseudo_at(iteration)
                pseudo = {}
                if use_pseudo:
                    if not pseudo_stack:
                        pseudo_stack = self._gen_pseudo_stack(iteration)
                    pcam = pseudo_stack.pop(self.py_rng.randrange(len(pseudo_stack)))
                    pseudo = self._pseudo_inputs(
                        state, pcam, self.depth_predictor,
                        min((iteration - o.start_sample_pseudo) / 500.0, 1.0))
                cam, image, mask, depth = g.select(self._own(i))
                state, metrics = self._get_step_fn(use_depth, use_pseudo)(
                    state, cam, image, mask, depth, self.bg, xyz_sched(iteration),
                    lambda_opacity, generator=self.generator, **pseudo)
                if metrics.overflow is not None:
                    self.max_overflow = torch.maximum(self.max_overflow, metrics.overflow)

                # ---- densification ------------------------------------------
                if iteration < o.densify_until_iter:
                    if (iteration > o.densify_from_iter
                            and iteration % o.densification_interval == 0):
                        state = self._densify(state)
                    if iteration % o.opacity_reset_interval == 0 or (
                            cfg.white_background and iteration == o.densify_from_iter):
                        params = state.model.params
                        params.opacity.copy_(reset_opacity(params, state.model.aux.filter_3d))
                        lambda_opacity = 0.01
                        cooldown = o.opacity_cooldown_iterations
                elif iteration % 100 == 0 and iteration < iterations - 100:
                    self._refresh_filter(state)

                # ---- logging / eval / snapshots -------------------------------
                if self.logger:
                    self.logger.log_step(iteration, metrics, time.time() - t_start)
                if iteration in checkpoint_iterations:
                    self._save_checkpoint(state, iteration)
                if iteration not in test_iterations and iteration not in save_iterations:
                    continue
                full = self._full(state)
                if self.rank != 0:
                    continue
                if iteration in test_iterations:
                    self._report(full, iteration)
                if iteration in save_iterations:
                    self.save_ply(full, iteration)

        if prof is not None:
            prof.stop()
        if self.logger:
            self.logger.flush()
        return state

    def _save_checkpoint(self, state: TrainState, iteration: int) -> None:
        """``chkpnt<it>.orbax``, every rank writing its rows, on a gauss
        mesh; ``chkpnt<it>.npz`` from rank 0 otherwise."""
        path = os.path.join(self.model_cfg.model_path, f"chkpnt{iteration}")
        if self._gauss is not None:
            save_checkpoint_sharded(path + ".orbax", state, iteration, self._gauss)
        elif self.rank == 0:
            save_checkpoint(path + ".npz", state, iteration)

    def _has_gui(self) -> bool:
        """Whether a viewer is polled: on a mesh, whether rank 0 has one."""
        if self.mesh is None:
            return self.gui is not None
        return bool(self.mesh.broadcast_object(self.gui is not None))

    def _on_main(self, fn, *args):
        """``fn(*args)`` on rank 0 while the other ranks wait (the call
        itself on one device)."""
        return fn(*args) if self.mesh is None else self.mesh.on_main(fn, *args)

    @torch.no_grad()
    def _poll_gui(self, state: TrainState, training_active: bool) -> None:
        """Service the live viewer (reference train.py:143-156).  A frame
        renders at the capacity cached for its resolution; one that
        overflows is rendered again at a capacity measured for its own
        camera, and a second overflow raises: no frame drops entries."""
        ks = self.model_cfg.kernel_size
        backend = self.pipe_cfg.rasterizer_backend

        def draw(camera, scaling_modifier, cap):
            return render(state.model, camera, self.bg, kernel_size=ks,
                          scaling_modifier=scaling_modifier, testing=True, backend=backend,
                          bin_capacity=cap, inference=(backend == "tiled"))

        def render_fn(camera, scaling_modifier):
            key = (camera.height, camera.width)
            if key not in self._eval_caps:
                self._eval_caps[key] = measure_bin_capacity(state.model, [camera],
                                                            kernel_size=ks)
            out = draw(camera, scaling_modifier, self._eval_caps[key])
            if out.overflow is not None and int(out.overflow):
                self._eval_caps[key] = measure_bin_capacity(state.model, [camera],
                                                            kernel_size=ks)
                out = draw(camera, scaling_modifier, self._eval_caps[key])
                if int(out.overflow):
                    raise RuntimeError(
                        f"viewer frame overflowed the binning capacity "
                        f"{self._eval_caps[key]} measured for its camera "
                        f"({int(out.overflow)} entries dropped)")
            return torch.clamp(out.color, 0.0, 1.0)

        self.gui.poll(render_fn, self.scene.source_path, training_active,
                      device=self.device)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, last_iteration: int) -> None:
        """Ends the profiled window: its chrome trace (the kernels and the
        program's spans) under ``profile_dir`` and, from rank 0, the spans'
        and counters' totals (``utils.trace.report``) as one ``trace``
        record of ``metrics.jsonl``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir,
            "trace.json" if self.mesh is None else f"trace_rank{self.rank}.json"))
        if self.logger:
            self.logger.log_trace(last_iteration, self.profile_steps, report())
        print(f"wrote profiler trace to {self.profile_dir}", flush=True)

    # ------------------------------------------------------------------
    @span("train.densify")
    def _densify(self, state: TrainState) -> TrainState:
        o = self.opt_cfg
        # Grow capacity host-side before the pass: a worst-case pass adds up
        # to 2 children per live splat, and dropped children permanently
        # lose their (killed) split parents — so keep free >= n_alive.  On
        # a gauss mesh the counts are global and the new capacity a
        # multiple of the mesh size, its pads spread evenly over the shards.
        mesh = self._gauss
        g = 1 if mesh is None else mesh.size
        n_alive = state.model.num_alive
        n_alive = int(n_alive if mesh is None else mesh.all_reduce_(n_alive.reshape(1))[0])
        cap = state.model.params.capacity * g
        if cap - n_alive < max(n_alive, 2048):
            new_cap = max(cap * 2, -(-(2 * n_alive + 2048) // 1024) * 1024)
            if mesh is None:
                state.model, state.opt = grow_capacity(state.model, state.opt, new_cap)
            else:
                state = sharded_grow_capacity(state, mesh, -(-new_cap // g) * g)
        stats = densify_and_prune(
            state.model.params, state.model.aux, state.opt, self.split_generator,
            max_grad=o.densify_grad_threshold, min_opacity=0.005,
            extent=float(self.scene.cameras_extent),
            max_screen_size=float(o.size_threshold), percent_dense=o.percent_dense,
            mesh=mesh)
        self._refresh_filter(state)
        if self.logger:
            self.logger.log_densify(state.step, stats)
        # Re-size the binning capacity with hysteresis (only large swings).
        if not self.pipe_cfg.bin_capacity and self.bin_capacity is not None:
            old = self.bin_capacity
            self._update_bin_capacity(state)
            if 0.5 * old <= self.bin_capacity <= old:
                self.bin_capacity = old
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _report(self, state: TrainState, iteration: int) -> None:
        """Held-out render-off: test/train L1 and PSNR, rendered / depth /
        GT images of the first views, the opacity histogram and the live
        point count."""
        for name, views in (("test", self.scene.test_views),
                            ("train", self.scene.train_views[:5])):
            if not views:
                continue
            l1s, psnrs = [], []
            for i, v in enumerate(views[:8]):
                out = self._eval_render(state.model, v.camera, self.bg)
                img = torch.clamp(out.color, 0.0, 1.0)
                gt = torch.tensor(v.image, device=self.device)
                l1s.append(float(torch.mean(torch.abs(img - gt))))
                psnrs.append(float(psnr_fn(img, gt)))
                if self.logger and i < 5:
                    tag = f"{name}_{v.image_name}"
                    self.logger.log_image(iteration, f"{tag}/render", img.cpu().numpy())
                    self.logger.log_image(iteration, f"{tag}/depth",
                                          colorize_depth(out.depth.cpu().numpy()))
                    if iteration <= self.opt_cfg.densification_interval:
                        self.logger.log_image(iteration, f"{tag}/ground_truth", v.image)
            if self.logger:
                self.logger.log_eval(iteration, name, float(np.mean(l1s)),
                                     float(np.mean(psnrs)))
        if self.logger:
            alive = state.model.aux.alive.cpu().numpy()
            opac = get_opacity(state.model.params).cpu().numpy()[alive]
            self.logger.log_histogram(iteration, "scene/opacity_histogram", opac)
            self.logger.log_scalar(iteration, "scene/total_points", float(alive.sum()))

    def save_ply(self, state: TrainState, iteration: int) -> None:
        path = os.path.join(self.model_cfg.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        save_gaussian_ply(state.model, path)
