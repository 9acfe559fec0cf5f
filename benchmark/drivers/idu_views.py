"""Traffic kind ``idu_views``: Stage-2 view generation as a closed loop of
``IDUOrchestrator.generate_idu_views`` calls, one look-at target per call.

Each call renders the target's orbit views from the splat scene, refines
them with FlowEdit on FLUX (bf16), predicts their depth with MoGe and
writes the frames and depths under the scratch directory, as an IDU
episode does.  Set-up draws the scene, FLUX, the VAE, MoGe and the prompt
conditioning from the seed (``weights.py``, ``frozen/scene.py``) and makes
``warmup_calls`` calls; the targets cycle through the curriculum's grid.

``correct`` takes one call of the window and one of its views, drawn from
the seed, and follows them with ``ref_priors`` in float32 on the same draws
and the refiner's noise stream replayed: the orbit render, the VAE encode,
FlowEdit's velocities, the decode and MoGe's depth.  It compares the
refined frame and the depth.
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

import ref_priors as rp
import ref_splat as ref
import weights
from drivers.splat_scene import program_state
from frozen import paths, scene, work
from harness import Context, Outcome


def sub_seed(seed: int, k: int) -> int:
    """The seed of draw stream ``k`` (< 8) of run seed ``seed``."""
    return (int(seed) * 8 + k) % (1 << 63)


def targets(idu: dict) -> list:
    """The curriculum's look-at grid (``train/idu.py`` ``run``)."""
    n = int(idu["grid_size"])
    xs = np.linspace(-idu["grid_width"] / 2, idu["grid_width"] / 2, n + 2)[1:-1]
    ys = np.linspace(-idu["grid_height"] / 2, idu["grid_height"] / 2, n + 2)[1:-1]
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3).tolist()


def conditioning(cfg: dict, seed: int, device) -> tuple:
    """(source, target) prompt features: T5 sequences (1, L, joint_dim) and
    CLIP pooled vectors (1, pooled_dim), N(0, text_std^2) from the seed."""
    t = cfg["text"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    shape_t, shape_p = (1, int(t["t5_tokens"]), int(cfg["flux"]["joint_dim"])), (
        1, int(cfg["flux"]["pooled_dim"]))
    out = [torch.randn(s, generator=g, device=device) * float(t["text_std"])
           for s in (shape_t, shape_p, shape_t, shape_p)]
    return (out[0], out[1]), (out[2], out[3])


def _config(cls, cfg):
    """A NamedTuple configuration from its JSON object (lists as tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})


class _Spans:
    """Host-clock seconds of each wrapped call (each ends in a host copy,
    so its device work is done when it returns)."""

    def __init__(self):
        self.s = {}

    def wrap(self, obj, attr: str, name: str):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s.setdefault(name, []).append(time.perf_counter() - t0)

        setattr(obj, attr, timed)


def run(ctx: Context) -> Outcome:
    from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from skyfall_gs_tpu_torch.core.camera import camera_from_c2w
    from skyfall_gs_tpu_torch.io.scene import SceneData, View
    from skyfall_gs_tpu_torch.model.gaussians import camera_filter_arrays, compute_3d_filter
    from skyfall_gs_tpu_torch.priors.flux import FluxConfig, FluxCond, FluxTransformer
    from skyfall_gs_tpu_torch.priors.flux_refiner import build_flux_refiner
    from skyfall_gs_tpu_torch.priors.flux_vae import VAE, VAEConfig
    from skyfall_gs_tpu_torch.priors.moge import MoGe, MoGePredictor, ViTConfig
    from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator
    from skyfall_gs_tpu_torch.train.logging import MetricsLogger
    from skyfall_gs_tpu_torch.train.loop import Trainer
    from skyfall_gs_tpu_torch.train.step import init_train_state

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    cuda = dev.startswith("cuda")
    idu, fe, app = cfg["idu"], cfg["flowedit"], cfg["appearance"]
    v = cfg["train_views"]
    size = int(v["size"])

    # ---- set-up -----------------------------------------------------------------
    model = program_state(cfg, scene.draw_splats(cfg, ctx.seed, dev), dev)
    cams = [camera_from_c2w(c2w, fov, fov, size, size, uid=i, device=dev)
            for i, (c2w, fov) in enumerate(scene.train_poses(cfg))]
    model.aux.filter_3d.copy_(compute_3d_filter(model.params.xyz, model.aux.alive,
                                                *camera_filter_arrays(cams)))
    state = init_train_state(model)
    data = SceneData(source_path=ctx.scratch, scene_type="satellite",
                     points=np.zeros((0, 3), np.float32), colors=np.zeros((0, 3), np.float32),
                     train_views=[View(camera=c, image_name=f"view_{i:03d}")
                                  for i, c in enumerate(cams)],
                     test_views=[], cameras_extent=float(cfg["spatial_lr_scale"]),
                     device=str(dev), train_groups={})
    ocfg = OptimizationConfig(
        **cfg["optimization"]["program"], idu_refine=True,
        idu_flow_edit_n_min=int(fe["n_min"]), idu_flow_edit_n_max=int(fe["n_max"]),
        idu_flow_edit_n_avg=int(fe["n_avg"]), idu_flow_edit_n_max_end=-1,
        idu_num_cams=int(idu["num_cams"]), idu_num_samples_per_view=int(idu["samples_per_view"]),
        idu_render_size=int(idu["render_size"]))
    mcfg = ModelConfig(sh_degree=int(cfg["sh_degree"]), appearance_enabled=True,
                       appearance_n_fourier_freqs=int(app["n_fourier_freqs"]),
                       appearance_embedding_dim=int(app["embedding_dim"]),
                       model_path=ctx.scratch, kernel_size=float(cfg["kernel_size"]))
    trainer = Trainer(mcfg, ocfg, PipelineConfig(), data, logger=MetricsLogger(ctx.scratch),
                      rng_seed=int(ctx.seed) % (1 << 63))
    fcfg, vcfg, mgcfg = (_config(FluxConfig, cfg["flux"]), _config(VAEConfig, cfg["vae"]),
                         _config(ViTConfig, cfg["vit"]))
    std = cfg["init_std"]
    flux = weights.build(FluxTransformer, fcfg, getattr(torch, cfg["dtype"]["flux"]), dev,
                         sub_seed(ctx.seed, 1), std["flux"])
    vae = weights.build(VAE, vcfg, torch.float32, dev, sub_seed(ctx.seed, 2), std["vae"])
    moge = weights.build(MoGe, mgcfg, torch.float32, dev, sub_seed(ctx.seed, 3), std["moge"])
    (st, sp), (tt, tp) = conditioning(cfg, ctx.seed, dev)
    refiner = build_flux_refiner(
        transformer=flux, vae=vae, src_cond=FluxCond(st, sp, float(fe["guidance_src"])),
        tar_cond=FluxCond(tt, tp, float(fe["guidance_tar"])), cfg=fcfg, vae_cfg=vcfg,
        num_steps=int(fe["num_steps"]), seed=sub_seed(ctx.seed, 5), device=dev,
        dtype=getattr(torch, cfg["dtype"]["flux"]))
    predictor = MoGePredictor(model=moge, cfg=mgcfg)
    orch = IDUOrchestrator(trainer, refiner, predictor)
    spans = _Spans()
    spans.wrap(orch, "_render", "render_write")
    spans.wrap(refiner, "run", "flowedit")
    spans.wrap(predictor, "run", "moge")
    grid = targets(idu)
    calls = []

    def call():
        k = len(calls)
        views = orch.generate_idu_views(state, [grid[k % len(grid)]], float(idu["elevation_deg"]),
                                        float(idu["radius"]), float(idu["fov_deg"]),
                                        f"call_{k:03d}")
        calls.append([(vw.image, vw.depth) for vw in views])
        return views

    for _ in range(int(wl["warmup_calls"])):
        call()
    ctx.sync()

    # ---- the window -------------------------------------------------------------
    setup_s = ctx.setup_s()
    trace = None
    if ctx.trace:
        with ctx.profile() as prof:
            call()
    first = len(calls)
    spans.s.clear()
    t_w = time.perf_counter()
    while len(calls) == first or time.perf_counter() - t_w < ctx.seconds:
        call()
    window_s = time.perf_counter() - t_w
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if ctx.trace:
        trace = prof.result(len(calls[first - 1]))
    per_call = len(calls[-1])
    views = [vw for c in calls[int(wl["warmup_calls"]):] for vw in c]
    failed = sum(1 for img, dep in views
                 if not (np.isfinite(img).all() and np.isfinite(dep).all()))
    window_views = (len(calls) - first) * per_call

    out_work = {}
    if ctx.trace:
        r = int(idu["render_size"])
        lat = r // 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
        n_img = (lat // 2) ** 2
        steps = int(fe["n_max"]) - int(fe["n_min"])
        flux_f = 2 * steps * int(fe["n_avg"]) * work.flux_flops(fcfg, n_img,
                                                               int(cfg["text"]["t5_tokens"]))
        with torch.device("meta"):
            rv = rp.VAE(_config(rp.VAEConfig, cfg["vae"]))
            rm = rp.MoGe(_config(rp.ViTConfig, cfg["vit"]))
        mh, mw = rp.moge_target_hw(r, r, rm.cfg)
        other = (work.module_flops(rv.encode, (1, r, r, 3))
                 + work.module_flops(rv.decode, (1, lat, lat, int(cfg["vae"]["latent_ch"])))
                 + work.module_flops(rm.depth, (1, mh, mw, 3)))
        out_work = {"step_flops": flux_f + other, "s_per_unit": window_s / window_views,
                    "peak_flops": work.BF16_FLOPS, "window_views": window_views}
    notes = [f"window {window_s:.3f} s, {len(calls) - first} calls, {window_views} views"]

    # ---- the reference follows one view of one call --------------------------------
    rnd = random.Random(ctx.seed)
    c_idx = first + rnd.randrange(len(calls) - first)
    v_idx = rnd.randrange(per_call)
    prog = calls[c_idx][v_idx]
    del orch, predictor, refiner, flux, vae, moge, trainer, state, model, data, cams, calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    with ref.strict_fp32():
        refr = reference_view(cfg, ctx.seed, c_idx, v_idx, dev)
    notes.append(f"compared view {v_idx} of call {c_idx}; reference "
                 f"{time.perf_counter() - t_ref:.3f} s")
    checks = view_gaps(prog, refr)
    return Outcome(attempted=len(views), failed=failed,
                   metrics={"setup_s": setup_s,
                            "idu_views_per_min": window_views / (window_s / 60.0)},
                   checks=checks, memory_peak_bytes=peak, trace=trace, work=out_work,
                   spans=spans.s, notes=notes)


def reference_view(cfg: dict, seed: int, call: int, view: int, device,
                   fp8: bool = False) -> tuple:
    """The reference's refined frame and depth of view ``view`` of call
    ``call`` (counted from the first call of the run)."""
    idu, fe = cfg["idu"], cfg["flowedit"]
    size, r = int(cfg["train_views"]["size"]), int(idu["render_size"])
    p = scene.draw_splats(cfg, seed, device)
    train = [ref.ref_camera(c2w, fov, fov, size, size, i, device)
             for i, (c2w, fov) in enumerate(scene.train_poses(cfg))]
    filt = ref.filter_3d(p["xyz"], train)
    grid = targets(idu)
    n = int(idu["num_cams"])
    poses = paths.orbit_ring(grid[call % len(grid)], float(idu["elevation_deg"]),
                             float(idu["radius"]), n)
    fov = math.radians(float(idu["fov_deg"]))
    s = int(idu["samples_per_view"])
    cam = ref.ref_camera(poses[view // s], fov, fov, r, r, 1000 + view, device)
    emb = p["appearance_embeddings"][min(6, p["appearance_embeddings"].shape[0] - 1)]
    with torch.no_grad():
        frame = torch.clamp(ref.render(p, filt, cam, emb, torch.zeros(3, device=device),
                                       float(cfg["kernel_size"]))["color"], 0.0, 1.0)
    del p, filt

    vcfg = _config(rp.VAEConfig, cfg["vae"])
    std = cfg["init_std"]
    vae = weights.build(rp.VAE, vcfg, torch.float32, device, sub_seed(seed, 2), std["vae"])
    lat = r // 2 ** (len(vcfg.ch_mult) - 1)
    x_src = rp.pack_latents(vae.encode(frame[None] * 2.0 - 1.0))
    fcfg = _config(rp.FluxConfig, cfg["flux"])
    flux = weights.build(rp.FluxTransformer, fcfg, torch.float32, device, sub_seed(seed, 1),
                         std["flux"], round_to=getattr(torch, cfg["dtype"]["flux"]))
    if fp8:
        rp.fp8_linears(flux)
    (st, sp), (tt, tp) = conditioning(cfg, seed, device)
    src = rp.FluxCond(st, sp, float(fe["guidance_src"]))
    tar = rp.FluxCond(tt, tp, float(fe["guidance_tar"]))
    ids = rp.latent_ids(lat, lat, device)
    steps, n_avg = int(fe["n_max"]) - int(fe["n_min"]), int(fe["n_avg"])
    batch = n * s

    def noise():
        g = torch.Generator(device=device).manual_seed(sub_seed(seed, 5))
        shape = (batch,) + tuple(x_src.shape[1:])
        for _ in range(call * steps * n_avg):
            torch.randn(shape, generator=g, device=device)
        while True:
            yield torch.randn(shape, generator=g, device=device)[view:view + 1]

    sig = rp.shifted_sigmas(int(fe["num_steps"]), (lat // 2) ** 2).to(device)
    z = rp.flow_edit(lambda tok, t, c: flux(tok, ids, c, t), x_src, src, tar, noise(), sig,
                     num_steps=int(fe["num_steps"]), n_min=int(fe["n_min"]),
                     n_max=int(fe["n_max"]), n_avg=n_avg)
    del flux
    refined = torch.clamp(vae.decode(rp.unpack_latents(z, lat, lat)) * 0.5 + 0.5, 0.0, 1.0)[0]
    del vae
    moge = weights.build(rp.MoGe, _config(rp.ViTConfig, cfg["vit"]), torch.float32, device,
                         sub_seed(seed, 3), std["moge"])
    depth = rp.moge_predict(moge, refined)
    return refined.cpu().numpy(), depth.cpu().numpy()


def view_gaps(prog: tuple, refr: tuple) -> dict:
    """Worst and mean absolute gap of the refined frame, and the mean
    absolute depth gap over the reference's mean depth."""
    img, dep = (np.asarray(a, np.float64) for a in prog)
    rimg, rdep = (np.asarray(a, np.float64) for a in refr)
    d = np.abs(img - rimg)
    return {"frame_max": float(d.max()), "frame_mean": float(d.mean()),
            "depth_mean": float(np.abs(dep - rdep).mean() / max(np.abs(rdep).mean(), 1e-12))}


def control(ctx: Context) -> tuple:
    """The control: float8 FLUX linears (the next precision below the
    configuration's bf16) against the float32 reference, on the view a run
    with two window calls would compare."""
    cfg, wl = ctx.config, ctx.workload
    rnd = random.Random(ctx.seed)
    first = int(wl["warmup_calls"])
    c_idx = first + rnd.randrange(2)
    v_idx = rnd.randrange(int(cfg["idu"]["num_cams"]) * int(cfg["idu"]["samples_per_view"]))
    with ref.strict_fp32():
        hi = reference_view(cfg, ctx.seed, c_idx, v_idx, ctx.device)
        lo = reference_view(cfg, ctx.seed, c_idx, v_idx, ctx.device, fp8=True)
    return view_gaps(lo, hi), [f"view {v_idx} of call {c_idx}"]
