"""Traffic kind ``train_chunks``: Stage-1 training as a closed loop of
``Trainer.train`` calls of ``chunk`` iterations each.

Set-up draws the scene and the training views' targets from the seed
(``frozen/scene.py``), builds one ``Trainer`` and one state, and drives them
through the first ``first_steps`` iterations by the same call the window
makes; the window continues that object.  ``correct`` compares those first
steps with ``ref_splat.train_steps`` on the same draws: each step's loss,
the first gradient of every leaf (from Adam's first moment after one step)
and every leaf's change after the first steps, each as the gap between the
program's norm and the reference's over the larger of the reference's norm
of that leaf or of the median leaf, worst leaf.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

import ref_splat as ref
from drivers.splat_scene import flat_leaves, program_state
from frozen import scene, work
from harness import Context, Outcome


def rng_seed_for(seed: int, n_views: int, first: int) -> int:
    """The Trainer's ``rng_seed``: the first at or after ``seed`` whose first
    ``first`` view picks all differ, so the steps that ``correct`` follows
    train distinct views."""
    s = seed
    while len(set(scene.view_picks(s, n_views, first))) < first:
        s += 1
    return s


class _Recorder:
    """Wraps the Trainer's step functions: counts failed iterations (a loss
    that is not finite, or binning that dropped an entry) on the device,
    and keeps the losses while ``keep`` is set."""

    def __init__(self, trainer, device):
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.keep = False
        self.losses = []
        orig = trainer._get_step_fn

        def get_step_fn(*a, **k):
            fn = orig(*a, **k)

            def step(state, *args, **kw):
                state, m = fn(state, *args, **kw)
                bad = ~torch.isfinite(m.loss)
                if m.overflow is not None:
                    bad = bad | (m.overflow > 0)
                self.bad += bad
                if self.keep:
                    self.losses.append(m.loss.detach().clone())
                return state, m

            return step

        trainer._get_step_fn = get_step_fn


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _gap(prog: dict, refn: dict, names) -> tuple:
    """Worst leaf of |prog - ref| / max(ref, median ref) over ``names``."""
    med = statistics.median(refn[k] for k in names)
    gaps = {k: abs(prog[k] - refn[k]) / max(refn[k], med) for k in names}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def run(ctx: Context) -> Outcome:
    from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from skyfall_gs_tpu_torch.core.camera import camera_from_c2w
    from skyfall_gs_tpu_torch.io.scene import SceneData, View, ViewGroup
    from skyfall_gs_tpu_torch.train.logging import MetricsLogger
    from skyfall_gs_tpu_torch.train.loop import Trainer
    from skyfall_gs_tpu_torch.train.step import init_train_state

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    start, chunk, first = int(wl["start_iteration"]), int(wl["chunk"]), int(wl["first_steps"])
    v = cfg["train_views"]
    n_views, size = int(v["count"]), int(v["size"])
    app = cfg["appearance"]
    opt = cfg["optimization"]

    # ---- set-up: inputs from the seed, one Trainer, one state ---------------
    images, masks, depths = scene.draw_targets(cfg, ctx.seed, dev)
    poses = scene.train_poses(cfg)
    cams = [camera_from_c2w(c2w, fov, fov, size, size, uid=i, device=dev)
            for i, (c2w, fov) in enumerate(poses)]
    names = [f"view_{i:03d}" for i in range(n_views)]
    group = ViewGroup(cameras=cams, images=images, masks=masks, depths=depths,
                      has_depth=True, names=names)
    data = SceneData(source_path=ctx.scratch, scene_type="satellite",
                     points=np.zeros((0, 3), np.float32), colors=np.zeros((0, 3), np.float32),
                     train_views=[View(camera=c, image_name=n) for c, n in zip(cams, names)],
                     test_views=[], cameras_extent=float(cfg["spatial_lr_scale"]),
                     device=str(dev), train_groups={(size, size): group})
    state = init_train_state(program_state(cfg, scene.draw_splats(cfg, ctx.seed, dev), dev))
    mcfg = ModelConfig(sh_degree=int(cfg["sh_degree"]), appearance_enabled=True,
                       appearance_n_fourier_freqs=int(app["n_fourier_freqs"]),
                       appearance_embedding_dim=int(app["embedding_dim"]),
                       model_path=ctx.scratch, kernel_size=float(cfg["kernel_size"]))
    ocfg = OptimizationConfig(**opt["program"])
    rng_seed = rng_seed_for(ctx.seed, n_views, first)
    trainer = Trainer(mcfg, ocfg, PipelineConfig(), data, logger=MetricsLogger(ctx.scratch),
                      rng_seed=rng_seed)
    trainer._refresh_filter(state)
    trainer.start_iteration = start - 1
    rec = _Recorder(trainer, dev)

    def advance(st, end):
        st = trainer.train(st, iterations=end)
        trainer.start_iteration = end
        ctx.sync()
        return st

    rec.keep = True
    state = advance(state, start)
    b1 = float(opt["adam_b1"])
    grads1 = {k: t / (1.0 - b1) for k, t in flat_leaves(state.opt.mu).items()}
    g_prog = {k: _norm(t) for k, t in grads1.items()}
    del grads1
    state = advance(state, start + first - 1)
    params_after = {k: t.clone() for k, t in flat_leaves(state.model.params).items()}
    losses = [float(x) for x in rec.losses]
    rec.keep = False
    rec.bad.zero_()

    # ---- the window -----------------------------------------------------------
    it = start + first - 1
    setup_s = ctx.setup_s()
    trace, traced = None, 0
    if ctx.trace:
        # The traced iterations come first, outside the timed window.
        traced = int(wl["trace_iterations"])
        with ctx.profile() as prof:
            state = advance(state, it + traced)
        it += traced
    t_w, done = time.perf_counter(), 0
    while done == 0 or time.perf_counter() - t_w < ctx.seconds:
        state = advance(state, it + chunk)
        it += chunk
        done += chunk
    t_end = time.perf_counter()
    window_s = t_end - t_w
    attempted = traced + done
    failed = int(rec.bad)
    peak = torch.cuda.max_memory_allocated() if dev.startswith("cuda") else 0

    out_work = {}
    if ctx.trace:
        trace = prof.result(traced)
        # Per-layer arithmetic of the traced iterations, from the reference's
        # own binning of their views at the window's end state.
        picks = scene.view_picks(rng_seed, n_views, first + traced)[first:]
        p = ref.nest({k: t.detach() for k, t in flat_leaves(state.model.params).items()})
        filt = state.model.aux.filter_3d.detach()
        n = p["xyz"].shape[0]
        n_params = sum(t.numel() for _, t in ref.leaves(p))
        app_f = work.appearance_flops(int(app["embedding_dim"]) + 3 + 6 * int(app["n_fourier_freqs"]),
                                      int(app["hidden"]))
        tiles = (-(-size // 16)) ** 2
        per_view, bound, flops = {}, {"fwd": 0.0, "bwd": 0.0}, 0
        with torch.no_grad(), ref.strict_fp32():
            for i in picks:
                if i not in per_view:
                    c2w, fov = poses[i]
                    rc = ref.ref_camera(c2w, fov, fov, size, size, i, dev)
                    r = ref.render(p, filt, rc, p["appearance_embeddings"][i],
                                   torch.zeros(3, device=dev), float(cfg["kernel_size"]))
                    per_view[i] = (work.composite_bounds(r["work"], n + 1, tiles), r["work"])
                b, w = per_view[i]
                bound["fwd"] += b["fwd"]["s"]
                bound["bwd"] += b["bwd"]["s"]
                flops += work.step_flops(n, n_params, app_f, w["passing"], size, size)
        out_work = {"step_flops": flops / traced, "bound_s": bound,
                    "s_per_unit": window_s / done, "peak_flops": work.FP32_FLOPS}
        del p, filt

    # ---- the reference follows the first steps --------------------------------
    del state, trainer, data, group, cams, images, masks, depths
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, notes = compare(ctx, rng_seed, losses, g_prog, params_after)
    del params_after
    notes.append(f"window {window_s:.3f} s, {done} iterations; reference "
                 f"{time.perf_counter() - t_ref:.3f} s")

    return Outcome(
        attempted=attempted, failed=failed,
        metrics={"setup_s": setup_s, "train_it_s": done / window_s},
        checks=checks, memory_peak_bytes=peak, trace=trace, work=out_work, notes=notes)


def reference_steps(cfg: dict, wl: dict, seed: int, rng_seed: int, device,
                    prec: ref.Precision = ref.FP32, half_view: bool = False) -> tuple:
    """The reference's first steps on the seed's draws: (its result, the
    initial leaves)."""
    v = cfg["train_views"]
    n_views, size = int(v["count"]), int(v["size"])
    start, first = int(wl["start_iteration"]), int(wl["first_steps"])
    opt = cfg["optimization"]
    init = scene.draw_splats(cfg, seed, device)
    images, masks, depths = scene.draw_targets(cfg, seed, device)
    cams = [ref.ref_camera(c2w, fov, fov, size, size, i, device)
            for i, (c2w, fov) in enumerate(scene.train_poses(cfg))]
    views = list(zip(cams, images, masks, depths))
    filt = ref.filter_3d(init["xyz"], cams, prec)
    picks = scene.view_picks(rng_seed, n_views, first)
    scale = float(cfg["spatial_lr_scale"])
    po = opt["program"]
    lr_fixed = {"features_dc": po["feature_lr"], "features_rest": po["feature_lr"] / 20.0,
                "scaling": po["scaling_lr"], "rotation": po["rotation_lr"],
                "opacity": po["opacity_lr"], "embeddings": po["embedding_lr"],
                "appearance_embeddings": po["appearance_embedding_lr"]}
    lrs = []
    for it in range(start, start + first):
        xyz_lr = ref.lr_at(it, po["position_lr_init"] * scale, po["position_lr_final"] * scale,
                           po["position_lr_delay_mult"], po["position_lr_max_steps"])
        lrs.append({k: (xyz_lr if k == "xyz" else po["appearance_mlp_lr"]
                        if k.startswith("appearance_mlp/") else lr_fixed[k])
                    for k, _ in ref.leaves(init)})
    w = {"lambda_dssim": po["lambda_dssim"], "lambda_depth": po["lambda_depth"]}
    out = ref.train_steps(init, filt, views, picks, lrs, w, po["lambda_opacity"],
                          torch.zeros(3, device=device), float(cfg["kernel_size"]), prec,
                          half_view=half_view)
    return out, dict(ref.leaves(init))


def control(ctx: Context, fault: str = "") -> tuple:
    """The correctness numbers of the control: the reference at TF32 in the
    program's place; with ``fault`` "half_view", the float32 reference with
    its loss over half of each view's rows instead."""
    v = ctx.config["train_views"]
    rng_seed = rng_seed_for(ctx.seed, int(v["count"]), int(ctx.workload["first_steps"]))
    if fault not in ("", "half_view"):
        raise ValueError(f"no fault {fault!r} for this cell")
    with ref.strict_fp32():
        lo, _ = reference_steps(ctx.config, ctx.workload, ctx.seed, rng_seed, ctx.device,
                                ref.FP32 if fault else ref.TF32, half_view=bool(fault))
    return compare(ctx, rng_seed, lo["losses"], {k: _norm(t) for k, t in lo["grads1"].items()},
                   lo["params"])


def compare(ctx: Context, rng_seed: int, losses: list, g_prog: dict,
            params_after: dict) -> tuple:
    """The correctness numbers of the first steps against the reference."""
    with ref.strict_fp32():
        r, init = reference_steps(ctx.config, ctx.workload, ctx.seed, rng_seed, ctx.device)
    g_ref = {k: _norm(t) for k, t in r["grads1"].items()}
    leaves_all = sorted(g_ref)
    med = statistics.median(g_ref.values())
    moving = [k for k in leaves_all if g_ref[k] >= 1e-3 * med]
    d_ref = {k: _norm(r["params"][k] - init[k]) for k in moving}
    d_prog = {k: _norm(params_after[k] - init[k]) for k in moving}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r["losses"]))
    grad_gap, grad_leaf = _gap(g_prog, g_ref, leaves_all)
    change_gap, change_leaf = _gap(d_prog, d_ref, moving)
    notes = [f"losses program {losses} reference {r['losses']}",
             f"worst first-gradient leaf {grad_leaf}: program {g_prog[grad_leaf]!r} "
             f"reference {g_ref[grad_leaf]!r}",
             f"worst change leaf {change_leaf}: program {d_prog[change_leaf]!r} "
             f"reference {d_ref[change_leaf]!r}",
             f"leaves left out of the change (reference gradient under 1e-3 of the median "
             f"leaf's): {sorted(set(leaves_all) - set(moving))}"]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}, notes
