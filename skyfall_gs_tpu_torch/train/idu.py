"""Stage 2: the Iterative Dataset Update (IDU) episode curriculum.

Port of the single-device ``IDUOrchestrator`` of
``skyfall_gs_tpu/train/idu.py`` (reference train.py:350-967):
  * ``generate_idu_views``: orbit cameras around each look-at target (uids
    1000 + i, or random train uids with ``idu_random_ap``), rendered with
    the fixed test embedding unless ``idu_random_ap``, refined by the
    refiner when ``idu_refine``, their depth predicted on the refined
    frames; the frames and depths are written under
    ``model_path/idu/<tag>/{render,render_refine}/`` and
    ``render_depth.npy``.  Without a curriculum one ring per (elevation,
    radius) pair is made, shuffled, and 1 / len(elevations) of it kept;
  * ``train_episode``: the 3D filter over train and IDU cameras, an
    episode-relative xyz LR schedule, a Bernoulli draw per iteration
    between an IDU view (photometric term only with ``idu_refine``, depth
    Pearson against the predicted depth) and an original view (photometric
    only), IDU views popped at random from a pool refilled when empty,
    pseudo views inside the episode (elevation 85 -> 45), densify and
    opacity reset with the ``lambda_opacity`` cooling, the filter recompute
    every 100 iterations after densification, and a checkpoint and PLY at
    the episode's end;
  * ``run``: the per-dataset curriculum over ``idu_grid_size``^2 look-at
    targets, or 5 mixed episodes without a curriculum.

Every host draw (view picks, the IDU / original coin, the IDU pool pops,
orbit uids and shuffles, pseudo targets) comes from the Trainer's
``random.Random(rng_seed)`` in the JAX package's order, so both packages
draw the same views for the same seed; the ray jitter and densify split
draws come from the Trainer's torch generator instead of JAX keys.

Binning capacity: the JAX package sizes it on the train views only.
1024^2 orbit views hold several times their entries, and after an
opacity reset the entries grow back as the opacities recover, faster than
a densify-time re-measure follows (a 512 px scene lost ~20k entries per
step that way on an H100).  So unless ``pipe_cfg.bin_capacity`` pins it,
every step measures its own view first and raises the capacity when it
falls short (one projection and one host read per step): no step drops
an entry.  Every orbit render is binned at a capacity measured over the
orbit set, and ``max_overflow`` holds the largest overflow of any render
or step.

With ``use_lpips_loss`` both kinds of step take the Trainer's LPIPS
scorer (``Trainer._get_step_fn``), as the JAX package's episodes do.

On a Trainer with a view mesh (``Trainer.mesh``) every rank runs the
episode: each iteration is one B-view step of the picked kind, an IDU view
row (the pool's pop, then B-1 uniform draws from the IDU set) or an
original row (``Trainer._pick_step``), and rank r trains column r.  Rank 0
alone renders, refines, predicts depth for and writes the view set while
the other ranks wait; then it broadcasts the views, one array at a time.
The orbit cameras and every host draw are made on every rank from the same
stream.  Pseudo views are replicated: every rank renders the same camera and
runs the predictor on its own device.  Reports, the checkpoint and the PLY
are rank 0's.  The JAX package's scan-fused episode windows are not ported
(one B-view step per iteration, on the same draws).

On a gauss mesh (``Trainer(mesh_mode="gauss")``) every rank trains the
same view each iteration with its shard of the splats; rank 0 renders the
view set from the state gathered on every rank
(``parallel.gauss_shard.gather_train_state``), as it writes the reports and
the PLY; pseudo views are rendered by all the shards together; the
episode's checkpoint is a ``chkpnt<it>.orbax`` directory every rank writes
its rows into (``train/checkpoint_sharded.py``).

A sharded refiner (``build_flux_refiner(mesh=...)``, ``refiner.mesh``)
needs every rank of its mesh inside ``run``.  It runs two ways:

  * under a single-device Trainer (``trainer.mesh`` None), as the JAX
    package's single controller does: the Trainer, the depth predictor and
    the orchestrator live on rank 0 of the refiner's mesh, while ranks
    1..tp-1 sit in ``priors.flux_serve.serve_refiner``
    (``priors.flux_serve.serve_or_run`` makes the split).  Rank 0 reaches
    the refiner through its client (``self.client``), which ``run`` enters
    around the curriculum: each refine broadcasts the frames on the mesh's
    host group and every rank refines them, and a heartbeat keeps the
    serving ranks waiting while rank 0 trains.  Leaving the client stops
    them, or fails them when an exception leaves ``run``.  A
    ``generate_idu_views`` call outside ``run`` goes inside an explicit
    ``with orch.client:``.  On any other rank the orchestrator raises
    ``ValueError``;
  * on a Trainer mesh (view or gauss) of the same ranks, view generation
    takes three steps: rank 0 renders and writes the frames while the
    others wait, the frames are broadcast, every rank refines them, then
    rank 0 saves the refined frames, predicts their depth and writes it
    while the others wait.  A Trainer mesh of other ranks raises
    ``ValueError``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from skyfall_gs_tpu_torch.config import IDU_CURRICULA, IDUCurriculum
from skyfall_gs_tpu_torch.core.camera import orbit_cameras
from skyfall_gs_tpu_torch.io.png import write_png
from skyfall_gs_tpu_torch.io.scene import View, stack_views
from skyfall_gs_tpu_torch.model.gaussians import camera_filter_arrays, reset_opacity
from skyfall_gs_tpu_torch.model.render import measure_bin_capacity
from skyfall_gs_tpu_torch.priors.flux_serve import serving_client
from skyfall_gs_tpu_torch.train.checkpoint import save_checkpoint
from skyfall_gs_tpu_torch.train.checkpoint_sharded import save_checkpoint_sharded
from skyfall_gs_tpu_torch.train.loop import Trainer
from skyfall_gs_tpu_torch.train.step import TrainState, make_eval_render
from skyfall_gs_tpu_torch.utils.general import expon_lr_schedule
from skyfall_gs_tpu_torch.utils.trace import span

_WRITE = span("idu.write")


def _save_frames(frames: Sequence[np.ndarray], path: str) -> None:
    os.makedirs(path, exist_ok=True)
    for i, f in enumerate(frames):
        with _WRITE:
            arr = np.clip(np.asarray(f) * 255.0 + 0.5, 0, 255).astype(np.uint8)
            write_png(os.path.join(path, f"{i:05d}.png"), arr)


@dataclass
class IDUOrchestrator:
    trainer: Trainer
    refiner: object          # priors.Refiner
    depth_predictor: object  # priors.DepthPredictor

    def __post_init__(self):
        tp = getattr(self.refiner, "mesh", None)
        mesh = self.trainer.mesh
        if tp is not None and mesh is not None and mesh.global_ranks() != tp.global_ranks():
            raise ValueError(
                "a sharded refiner (refiner.mesh set) under a Trainer mesh runs on every rank "
                "of it: train with Trainer(mesh=<a mesh of the same ranks>), or with a "
                "single-device Trainer on rank 0 of the refiner's mesh while the other ranks "
                "call priors.flux_serve.serve_refiner(refiner)")
        # A single-device Trainer reaches the refiner through its client (rank 0
        # driving the serving ranks of a sharded one; it raises ValueError on any
        # other rank); on a Trainer mesh every rank calls the refiner itself.
        self.client = serving_client(self.refiner) if mesh is None else None
        self.max_overflow = 0    # the largest overflow of any IDU render or step
        # Per episode: the orbit set (views, size, binning capacity,
        # overflow, host ms per render between two synchronizations, mean
        # alpha coverage) and, once trained, the wall seconds of the view
        # generation and of the training loop, its iterations and the
        # largest binning capacity of its steps.
        self.episodes: List[dict] = []

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate_idu_views(self, state: TrainState, targets: Sequence[Sequence[float]],
                           elevation, radius, fov: float, episode_tag: str) -> List[View]:
        t = self.trainer
        o = t.opt_cfg
        size = o.idu_render_size
        rng = t.py_rng
        num_train = max(t.scene.num_train, 1)

        def rings(ele, rad):
            cams = []
            for target in targets:
                uids = None
                if o.idu_random_ap:
                    uids = [rng.randrange(num_train)
                            for _ in range(o.idu_num_cams * o.idu_num_samples_per_view)]
                cams.extend(orbit_cameras(target, ele, rad, num_cams=o.idu_num_cams,
                                          num_samples=o.idu_num_samples_per_view,
                                          width=size, height=size, fov_deg=fov,
                                          uid_base=1000, uids=uids, device=t.device))
            return cams

        if isinstance(elevation, (list, tuple)):
            cams = []
            for ele, rad in zip(elevation, radius):
                cams.extend(rings(ele, rad))
            rng.shuffle(cams)
            cams = cams[: len(cams) // len(elevation)]
        else:
            cams = rings(elevation, radius)

        mesh = t.mesh
        if mesh is None:
            refined, depths = self._render_refine_write(state, cams, episode_tag)
        else:
            full = t._full(state)
            if getattr(self.refiner, "mesh", None) is not None and o.idu_refine:
                # Every rank refines and so already holds the refined frames.
                imgs = mesh.on_main(self._render, full, cams, episode_tag)
                refined = self._refine(mesh.broadcast_arrays(imgs))
                depths = mesh.on_main(self._write_depths, refined, episode_tag)
            else:
                out = mesh.on_main(self._render_refine_write, full, cams, episode_tag)
                refined = mesh.broadcast_arrays(out[0] if mesh.is_main else None)
                depths = out[1] if mesh.is_main else None
            record = mesh.broadcast_object(self.episodes[-1] if mesh.is_main else None)
            if not mesh.is_main:
                self.episodes.append(record)
                self.max_overflow = max(self.max_overflow, record["overflow"])
            depths = mesh.broadcast_arrays(depths)
        return [View(camera=cam, image=np.asarray(img, np.float32), mask=None,
                     depth=np.asarray(dep, np.float32), image_name=episode_tag)
                for cam, img, dep in zip(cams, refined, depths)]

    def _render_refine_write(self, state: TrainState, cams: list, episode_tag: str):
        """The view set's frames and depths for ``cams``: render, refine,
        predict depth and write them."""
        refined = self._refine(self._render(state, cams, episode_tag))
        return refined, self._write_depths(refined, episode_tag)

    @span("idu.render")
    def _render(self, state: TrainState, cams: list, episode_tag: str) -> List[np.ndarray]:
        """The view set's frames for ``cams`` (the fixed test embedding
        unless random_ap), written under ``model_path/idu/<tag>/render/``;
        records the episode's orbit set."""
        t = self.trainer
        o, cfg = t.opt_cfg, t.model_cfg
        size = o.idu_render_size
        cap = measure_bin_capacity(state.model, cams, kernel_size=cfg.kernel_size)
        render = make_eval_render(cfg.kernel_size, t.pipe_cfg.rasterizer_backend,
                                  bin_capacity=cap)
        sync = torch.cuda.synchronize if t.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        colors, overflows, alphas = [], [], []
        for cam in cams:
            out = render(state.model, cam, t.bg)
            colors.append(torch.clamp(out.color, 0.0, 1.0))
            alphas.append(out.alpha.mean())
            if out.overflow is not None:
                overflows.append(out.overflow)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(cams)
        overflow = int(torch.stack(overflows).max()) if overflows else 0
        coverage = float(torch.stack(alphas).mean())
        imgs = [c.cpu().numpy() for c in colors]
        del colors
        self.max_overflow = max(self.max_overflow, overflow)
        self.episodes.append({"tag": episode_tag, "views": len(cams), "size": size,
                                  "capacity": cap, "overflow": overflow,
                                  "ms_per_render": ms, "alpha_coverage": coverage})

        _save_frames(imgs, os.path.join(cfg.model_path, "idu", episode_tag, "render"))
        return imgs

    @span("idu.refine")
    def _refine(self, imgs: List[np.ndarray]) -> List[np.ndarray]:
        """The frames refined with ``idu_refine``, else ``imgs``."""
        o = self.trainer.opt_cfg
        if not o.idu_refine:
            return imgs
        refiner = self.client or self.refiner
        return refiner.run(imgs, n_min=o.idu_flow_edit_n_min, n_max=o.idu_flow_edit_n_max,
                           n_max_end=o.idu_flow_edit_n_max_end, n_avg=o.idu_flow_edit_n_avg)

    def _write_depths(self, refined: List[np.ndarray], episode_tag: str):
        """The refined frames' predicted depths; the frames (with
        ``idu_refine``) and the depths are written under
        ``model_path/idu/<tag>/``."""
        t = self.trainer
        idu_dir = os.path.join(t.model_cfg.model_path, "idu", episode_tag)
        if t.opt_cfg.idu_refine:
            _save_frames(refined, os.path.join(idu_dir, "render_refine"))
        with span("idu.depth"):
            depths = self.depth_predictor.run(refined)
        with _WRITE:
            np.save(os.path.join(idu_dir, "render_depth.npy"),
                    np.stack(depths).astype(np.float32))
        return [np.asarray(dep, np.float32) for dep in depths]

    # ------------------------------------------------------------------
    def train_episode(self, state: TrainState, first_iter: int, targets, elevation,
                      radius, fov: float) -> TrainState:
        t = self.trainer
        o, cfg = t.opt_cfg, t.model_cfg
        tag = (f"e{elevation}_r{radius}" if not isinstance(elevation, (list, tuple))
               else "e_mixed")
        sync = torch.cuda.synchronize if t.device.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        idu_views = self.generate_idu_views(state, targets, elevation, radius, fov, tag)
        idu_group = stack_views(idu_views, t.device)
        del idu_views

        # 3D filter over train + IDU cameras (reference train.py:671).
        t.filter_cams = camera_filter_arrays([v.camera for v in t.scene.train_views]
                                             + idu_group.cameras)
        t._refresh_filter(state)
        t._update_bin_capacity(state)
        max_capacity = t.bin_capacity

        end_iter = first_iter + o.idu_episode_iterations
        densify_until = first_iter + o.idu_densify_until_iter
        xyz_sched = expon_lr_schedule(
            o.position_lr_init * state.model.spatial_lr_scale,
            o.position_lr_final * state.model.spatial_lr_scale,
            lr_delay_mult=o.position_lr_delay_mult, max_steps=o.idu_position_lr_max_steps)

        lambda_opacity = o.lambda_opacity
        cooldown = None
        idu_indices: List[int] = []
        pseudo_stack: list = []

        def draw(j: int):
            """One iteration's host draws: the IDU / original coin and the
            view pick, in the JAX package's order."""
            use_idu = (j + o.idu_iter_full_train <= end_iter
                       and t.py_rng.random() < o.idu_train_ratio)
            if use_idu:
                if not idu_indices:
                    idu_indices.extend(range(idu_group.size))
                i = idu_indices.pop(t.py_rng.randrange(len(idu_indices)))
                if t._mesh_B:
                    i = [i] + [t.py_rng.randrange(idu_group.size)
                               for _ in range(t._mesh_B - 1)]
                return True, idu_group, i
            g, i = t._pick_step()
            return False, g, i

        def pseudo_at(j: int) -> bool:
            return (o.lambda_pseudo_depth > 0 and self.depth_predictor is not None
                    and j % o.sample_pseudo_interval == 0)

        sync()
        t1 = time.perf_counter()
        for iteration in range(first_iter + 1, end_iter + 1):
            with span("train.iteration", iteration):
                if cooldown is not None:
                    if cooldown > 0:
                        cooldown -= 1
                    else:
                        cooldown = None
                        lambda_opacity = o.lambda_opacity
                use_idu, g, i = draw(iteration)
                use_pseudo = pseudo_at(iteration)
                pseudo = {}
                if use_pseudo:
                    # reference train.py:801-832: elevation 85 -> 45 across the
                    # episode, radius 150 -> 75.
                    if not pseudo_stack:
                        frac = (end_iter - iteration) / max(o.idu_episode_iterations, 1)
                        pseudo_stack = t._gen_pseudo_stack_at(frac * (85.0 - 45.0) + 45.0,
                                                              frac * (150.0 - 75.0) + 75.0)
                    pcam = pseudo_stack.pop(t.py_rng.randrange(len(pseudo_stack)))
                    pseudo = t._pseudo_inputs(state, pcam, self.depth_predictor, 1.0)
                cam, image, mask, depth = g.select(t._own(i))
                if not t.pipe_cfg.bin_capacity:
                    t.bin_capacity = max(t.bin_capacity, t._measure(state.model, [cam]))
                    max_capacity = max(max_capacity, t.bin_capacity)
                # IDU views: the depth term, and the photometric one with
                # idu_refine; original views: the photometric term only.
                if use_idu:
                    step = t._get_step_fn(o.lambda_depth > 0, use_pseudo,
                                          photometric=o.idu_refine,
                                          testing_render=not o.idu_random_ap)
                else:
                    step = t._get_step_fn(False, use_pseudo)
                state, metrics = step(state, cam, image, mask, depth, t.bg,
                                      xyz_sched(iteration - first_iter), lambda_opacity,
                                      generator=t.generator, **pseudo)
                if metrics.overflow is not None:
                    t.max_overflow = torch.maximum(t.max_overflow, metrics.overflow)

                if iteration < densify_until:
                    if (iteration > o.densify_from_iter
                            and iteration % o.densification_interval == 0):
                        state = t._densify(state)
                    if (iteration % o.idu_opacity_reset_interval == 0
                            and iteration < end_iter - 100):
                        params = state.model.params
                        params.opacity.copy_(reset_opacity(params, state.model.aux.filter_3d))
                        lambda_opacity = 0.0
                        cooldown = o.idu_opacity_cooling_iterations
                elif iteration % 100 == 0 and iteration < end_iter - 100:
                    t._refresh_filter(state)

                if t.logger:
                    t.logger.log_step(iteration, metrics, 0.0)
                if iteration % o.idu_testing_interval == 0 or iteration == end_iter:
                    full = t._full(state)
                    if t.rank == 0:
                        t._report(full, iteration)

        sync()
        self.episodes[-1].update(views_s=t1 - t0, train_s=time.perf_counter() - t1,
                                 iterations=end_iter - first_iter, step_capacity=max_capacity)
        self.max_overflow = max(self.max_overflow, int(t.max_overflow))
        if t.logger:
            t.logger.flush()
        path = os.path.join(cfg.model_path, f"chkpnt{end_iter}")
        if t._gauss is not None:
            save_checkpoint_sharded(path + ".orbax", state, end_iter, t._gauss)
        elif t.rank == 0:
            save_checkpoint(path + ".npz", state, end_iter)
        full = t._full(state)
        if t.rank == 0:
            t.save_ply(full, end_iter)
        return state

    # ------------------------------------------------------------------
    def run(self, state: TrainState, first_iter: int, episodes: int = 0) -> TrainState:
        """The Stage-2 curriculum (reference training_idu); ``episodes`` > 0
        stops after that many episodes."""
        t = self.trainer
        o = t.opt_cfg
        cur: IDUCurriculum = IDU_CURRICULA[o.datasets_type]
        xs = np.linspace(-o.idu_grid_width / 2, o.idu_grid_width / 2, o.idu_grid_size + 2)[1:-1]
        ys = np.linspace(-o.idu_grid_height / 2, o.idu_grid_height / 2,
                         o.idu_grid_size + 2)[1:-1]
        xx, yy = np.meshgrid(xs, ys)
        targets = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3).tolist()
        if not o.idu_no_curriculum:
            plan = [(float(e), float(r)) for r, e in zip(cur.radius_list, cur.elevation_list)]
        else:
            plan = [(list(cur.elevation_list), list(cur.radius_list))] * 5
        it = first_iter
        with self.client or contextlib.nullcontext():
            for elevation, radius in plan[:episodes or None]:
                print(f"[IDU] episode elevation={elevation} radius={radius}", flush=True)
                state = self.train_episode(state, it, targets, elevation, radius, cur.fov)
                it += o.idu_episode_iterations
        return state
