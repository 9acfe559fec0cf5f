"""Traffic kind ``viewer_orbit``: one viewer client in a closed loop, as the
SIBR viewer drives the program.

Each frame is ``model.render.render`` with the arguments that
``viz/video.py`` ``render_trajectory`` passes (``testing``, ``inference``,
a binning capacity measured over the path), quantized to uint8 on the
device and copied to the host as ``viz/network_gui.py`` sends it.  Cameras
cycle through a trajectory of orbits (``frozen/paths.py``) read by the
program's ``parse_trajectory_json``.  A frame's time runs from its request
to its bytes on the host, by CUDA events on the stream (the stream is idle
when a frame is requested, since the previous copy synchronized it).

``correct`` renders a sample of the window's frames, drawn from the seed,
with ``ref_splat.render`` and compares their bytes, depth and alpha.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

import ref_splat as ref
from drivers.splat_scene import program_state
from frozen import paths, scene, work
from harness import Context, Outcome


def trajectory(wl: dict) -> dict:
    return paths.trajectory([(e, wl["radius"], int(wl["frames_per_orbit"]))
                             for e in wl["elevations_deg"]],
                            int(wl["width"]), int(wl["height"]), float(wl["fov_deg"]))


def sample(seed: int, wl: dict) -> list:
    """Frame numbers of the window compared with the reference."""
    return sorted(random.Random(seed).sample(range(int(wl["sample_from"])),
                                             int(wl["sample_frames"])))


def run(ctx: Context) -> Outcome:
    from skyfall_gs_tpu_torch.core.camera import camera_from_c2w
    from skyfall_gs_tpu_torch.model.gaussians import camera_filter_arrays, compute_3d_filter
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity, render
    from skyfall_gs_tpu_torch.viz.paths import parse_trajectory_json

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    cuda = dev.startswith("cuda")
    ks = float(cfg["kernel_size"])
    v = cfg["train_views"]
    size = int(v["size"])

    # ---- set-up -----------------------------------------------------------------
    model = program_state(cfg, scene.draw_splats(cfg, ctx.seed, dev), dev)
    train_cams = [camera_from_c2w(c2w, fov, fov, size, size, uid=i, device=dev)
                  for i, (c2w, fov) in enumerate(scene.train_poses(cfg))]
    model.aux.filter_3d.copy_(compute_3d_filter(model.params.xyz, model.aux.alive,
                                                *camera_filter_arrays(train_cams)))
    path = trajectory(wl)
    cams, _ = parse_trajectory_json(path, device=dev)
    cap = measure_bin_capacity(model, cams, kernel_size=ks)
    bg = torch.zeros(3, device=dev)
    keep = set(sample(ctx.seed, wl))
    kept, bad = {}, torch.zeros((), dtype=torch.int64, device=dev)

    def frame(k: int):
        with torch.no_grad():
            out = render(model, cams[k % len(cams)], bg, kernel_size=ks, testing=True,
                         bin_capacity=cap, inference=True)
            data = (torch.clamp(out.color, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        return out, data

    for k in range(int(wl["warmup_frames"])):
        frame(k)
    ctx.sync()

    # ---- the window -------------------------------------------------------------
    setup_s = ctx.setup_s()
    n, trace, traced = 0, None, 0
    events = []

    def timed(k):
        nonlocal bad
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        out, data = frame(k)
        if cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            events.append((e0, e1))
        if out.overflow is not None:
            bad = bad + (out.overflow > 0)
        if k in keep:
            kept[k] = (data, out.depth.clone(), out.alpha.clone())

    if ctx.trace:
        # The traced frames come first, outside the timed window.
        traced = int(wl["trace_frames"])
        with ctx.profile() as prof:
            for _ in range(traced):
                timed(n)
                n += 1
        events.clear()
    t_w = time.perf_counter()
    while n == traced or time.perf_counter() - t_w < ctx.seconds:
        timed(n)
        n += 1
    t_end = time.perf_counter()
    ctx.sync()
    window_s = t_end - t_w
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ms = [a.elapsed_time(b) for a, b in events]
    p95 = float(np.percentile(ms, 95)) if ms else float("nan")
    failed = int(bad)

    out_work = {}
    if ctx.trace:
        trace = prof.result(traced)
        out_work = frame_work(ctx, model, path, traced, window_s, n - traced)

    del model, cams, train_cams
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, notes = compare(ctx, kept)
    notes.append(f"window {window_s:.3f} s; reference {time.perf_counter() - t_ref:.3f} s")
    return Outcome(attempted=n, failed=failed,
                   metrics={"setup_s": setup_s, "render_fps": (n - traced) / window_s,
                            "frame_ms_p95": p95},
                   checks=checks, memory_peak_bytes=peak, trace=trace, work=out_work,
                   notes=notes + [f"frames {n}, compared {sorted(kept)}"])


def frame_work(ctx: Context, model, path: dict, traced: int, untraced_s: float,
               untraced: int) -> dict:
    """Arithmetic and compositing bounds of the traced frames, from the
    reference's own binning of the same splats and cameras."""
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    app = cfg["appearance"]
    p = {k: getattr(model.params, k) for k in ("xyz", "features_dc", "features_rest",
                                                "scaling", "rotation", "opacity",
                                                "embeddings", "appearance_embeddings",
                                                "appearance_mlp")}
    n = p["xyz"].shape[0]
    emb = p["appearance_embeddings"][min(6, p["appearance_embeddings"].shape[0] - 1)]
    app_f = work.appearance_flops(int(app["embedding_dim"]) + 3 + 6 * int(app["n_fourier_freqs"]),
                                  int(app["hidden"]))
    poses = paths.trajectory_poses(path)
    w, h = int(wl["width"]), int(wl["height"])
    tiles = (-(-w // 16)) * (-(-h // 16))
    # Every ``stride``-th traced frame stands for the ``stride`` frames
    # from it on (neighbouring cameras of one orbit).
    stride = int(wl["work_stride"])
    bound, flops = 0.0, 0
    with torch.no_grad(), ref.strict_fp32():
        for k in range(0, traced, stride):
            c2w, fx, fy = poses[k % len(poses)]
            r = ref.render(p, model.aux.filter_3d, ref.ref_camera(c2w, fx, fy, w, h, k, dev),
                           emb, torch.zeros(3, device=dev), float(cfg["kernel_size"]))
            m = min(stride, traced - k)
            bound += m * work.composite_bounds(r["work"], n + 1, tiles)["fwd"]["s"]
            flops += m * work.frame_flops(n, app_f, r["work"]["passing"], w * h)
    return {"step_flops": flops / traced, "bound_s": {"fwd": bound, "bwd": 0.0},
            "s_per_unit": untraced_s / max(untraced, 1), "peak_flops": work.FP32_FLOPS}


def reference_frames(cfg: dict, wl: dict, seed: int, frames: list, device,
                     prec: ref.Precision = ref.FP32) -> dict:
    """The reference's bytes, depth and alpha of trajectory frames ``frames``."""
    p = scene.draw_splats(cfg, seed, device)
    v = cfg["train_views"]
    size = int(v["size"])
    train = [ref.ref_camera(c2w, fov, fov, size, size, i, device)
             for i, (c2w, fov) in enumerate(scene.train_poses(cfg))]
    filt = ref.filter_3d(p["xyz"], train, prec)
    emb = p["appearance_embeddings"][min(6, p["appearance_embeddings"].shape[0] - 1)]
    poses = paths.trajectory_poses(trajectory(wl))
    w, h = int(wl["width"]), int(wl["height"])
    out = {}
    with torch.no_grad():
        for k in frames:
            c2w, fx, fy = poses[k % len(poses)]
            r = ref.render(p, filt, ref.ref_camera(c2w, fx, fy, w, h, k, device), emb,
                           torch.zeros(3, device=device), float(cfg["kernel_size"]), prec)
            data = (torch.clamp(r["color"], 0, 1) * 255).to(torch.uint8).cpu().numpy()
            out[k] = (data, r["depth"], r["alpha"])
    return out


def frame_gaps(prog: dict, refr: dict) -> dict:
    """Worst byte difference, mean byte difference, worst relative depth gap
    where the reference's alpha is over 0.5, and worst alpha gap."""
    diffs, depth, alpha = [], 0.0, 0.0
    for k, (data, d, a) in prog.items():
        rdata, rd, ra = refr[k]
        diffs.append(np.abs(data.astype(np.int16) - rdata.astype(np.int16)))
        solid = ra > 0.5
        if bool(solid.any()):
            depth = max(depth, float(torch.max(torch.abs(d - rd)[solid] / rd[solid])))
        alpha = max(alpha, float(torch.max(torch.abs(a - ra))))
    diffs = np.concatenate([x.ravel() for x in diffs])
    return {"bytes_max": float(diffs.max()), "bytes_mean": float(diffs.mean()),
            "depth_gap": depth, "alpha_gap": alpha}


def control(ctx: Context) -> tuple:
    """The correctness numbers of the control: the reference at TF32 in the
    program's place, on the frames a run compares."""
    frames = sample(ctx.seed, ctx.workload)
    with ref.strict_fp32():
        lo = reference_frames(ctx.config, ctx.workload, ctx.seed, frames, ctx.device, ref.TF32)
    return compare(ctx, lo)


def compare(ctx: Context, kept: dict) -> tuple:
    if not kept:
        return {"frames_compared": float("inf")}, ["no sampled frame was rendered"]
    with ref.strict_fp32():
        refr = reference_frames(ctx.config, ctx.workload, ctx.seed, sorted(kept), ctx.device)
    return frame_gaps(kept, refr), []
