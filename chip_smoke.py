#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (skyfall_gs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  0. the card (nvidia-smi name and power limit), torch/CUDA and nvcc versions;
  1. build the compositing kernels from csrc/ with nvcc into build/;
  2. each kernel against its plain PyTorch version at 128x128 on a scene
     with a saturated tile and tiles of more than 1k entries;
  3. the main path: Stage-1 training steps at the bench workload (512x512,
     100k splats, capacity 125k, SH degree 3, filter_3d 0.3, depth loss on,
     8 orbit cameras), with both kernels' launch counts, then each kernel
     timed alone against its plain version at that shape;
  4. one training step's loss and gradients on the card against the same
     step on the CPU (plain versions) on a small scene;
  5. the Stage-1 Trainer on the card, run as the JAX package's quality gate
     (bench.py quality_metric): the 256 px synthetic city (16 views, 2
     held out, 2000 GT points, scene seed 0), appearance (4 frequencies,
     dim 32) and depth (0.1) on, densify every 150 iterations in
     (300, 1200), opacity reset every 1500, 2000 iterations, for Trainer
     seeds 0, 1 and 2.  One line per seed (test PSNR and SSIM, splats and
     capacity, densify passes and drops, the largest binning overflow of
     any step, wall time and it/s, peak memory, kernel launches), then the
     median seed's line.  It fails on a non-finite loss or parameter, any
     overflow, a kernel not launched, or a median PSNR under 22.7 dB (the
     lowest JAX seed of the gate).  Seed 0 also writes and reloads a
     checkpoint and writes a PLY;
  6. the command-line chain at the bench width: ``write_satellite_scene``
     writes a 512 px satellite scene (16 views, 2 held out, 40,000 GT
     points, an init cloud of 13,333, seed 0) to disk, ``cli.train`` trains
     it from disk (1500 iterations, densify every 150 in (300, 1200)),
     ``gen_render_path`` writes a 60-frame 1920x1080 orbit, ``render_video``
     renders it from the checkpoint (RGB) and from the fused PLY (depth),
     and ``create_fused_ply`` writes the fused PLY and a ``.splat``.  It
     fails on a missing artifact, a non-finite loss or parameter, any
     overflow, an unlaunched kernel or a test PSNR under PSNR_FLOOR_DB;
  7. inference at full width: the 125k-splat stress scene of
     scripts/bench_entry_budget.py over 4 orbit cameras at 1920x1088, FPS
     over 30 frames after 3 warm-up frames, full (measured capacity) and
     under entry budgets of 2M, 1M and 500k entries (PSNR against the full
     render, kept entries <= budget), each 1080p configuration profiled
     (device-busy time, launches and the CUDA runtime's host time per
     frame), the full render at 512x512, and the forward kernel against
     its plain version on one 1920x1088 frame under the 1M budget.
Each measurement line carries the card's name and power limit.  The last
two lines before the final one are the kernels' JSON record (launches
counted over phases 3, 5, 6 and 7) and the card's name and power limit;
the final line is the JSON result.  Any failure raises, and the script
exits non-zero without a result.  There is no CPU path.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "skyfall_gs_tpu_torch/csrc/composite.cu"
DEVICE = "cuda"

# Bench workload (bench.py:26-108).
N_GAUSSIANS = 100_000
IMG = 512
WARMUP_STEPS = 3
MEASURE_STEPS = 20

# Quality gate (bench.py:199-262 quality_metric).
Q_SCENE = dict(n_views=16, size=256, n_points=2000, n_test=2)
Q_ITERS = 2000
Q_OPT = dict(densify_from_iter=300, densification_interval=150, densify_until_iter=1200,
             opacity_reset_interval=1500, lambda_depth=0.1, lambda_opacity=0.01)
Q_SEEDS = (0, 1, 2)
Q_MIN_MEDIAN_PSNR = 22.7   # the lowest of the JAX package's three seeds

# Phase 6: the CLI chain (scripts/make_synthetic_satellite.py's scene).
SAT_SCENE = dict(size=512, n_points=40_000, n_views=16, seed=0)
TRAIN_ITERS = 1500
TRAIN_FLAGS = ["--eval", "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "300",
               "--densification_interval", "150", "--densify_until_iter", "1200"]
# The JAX package's cli.train on the CPU, on the same 512 px scene (written by
# write_satellite_scene) with the same flags and seed, reached a test PSNR of
# 28.39 dB (30,321 splats); the floor is that minus 1 dB.
PSNR_FLOOR_DB = 27.39
PATH_FLAGS = ["--width", "1920", "--height", "1080", "--num_frame", "60",
              "--elevation", "45", "--radius", "300", "--fov", "60"]

# Phase 7: the 125k-splat stress scene (scripts/bench_entry_budget.py:37-54).
STRESS_SPLATS = 125_000
STRESS_WARMUP = 3
STRESS_FRAMES = 30
BUDGETS = (2_000_000, 1_000_000, 500_000)


def log(phase, msg: str) -> None:
    print(f"phase {phase}: {msg}", flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def module_version(name: str) -> str:
    try:
        mod = __import__(name)
    except ImportError as e:
        return f"missing ({e})"
    return getattr(mod, "__version__", "present")


def reset_launches(rt) -> None:
    rt.composite_fwd.launches = 0
    rt.composite_bwd.launches = 0


def launches_of(rt) -> dict:
    return {"fwd": rt.composite_fwd.launches, "bwd": rt.composite_bwd.launches}


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_norm(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ----------------------------------------------------------------------------
# Phase 2 scene: screen-space splats at 128x128
# ----------------------------------------------------------------------------

def screen_scene(rng, size: int = 128):
    """~2k screen-space splats: a dense low-opacity cluster (tiles of more
    than 1k entries), an opaque wall over one tile (saturates, with a tail
    of entries past termination) and a random field."""
    groups = []

    def group(n, lo, hi, sigma, opacity):
        mean = rng.uniform(lo, hi, (n, 2))
        s = np.exp(rng.uniform(np.log(sigma[0]), np.log(sigma[1]), (n, 2)))
        th = rng.uniform(0, np.pi, n)
        c, sn = np.cos(th), np.sin(th)
        rot = np.stack([np.stack([c, -sn], -1), np.stack([sn, c], -1)], -2)
        cov = rot @ (s[:, :, None] ** 2 * np.eye(2)) @ np.swapaxes(rot, 1, 2)
        inv = np.linalg.inv(cov)
        groups.append((mean, np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], 1),
                       cov, opacity(n)))

    group(1400, 4.0, 20.0, (2.0, 6.0), lambda n: rng.uniform(0.01, 0.06, n))
    group(300, 76.0, 84.0, (20.0, 30.0), lambda n: rng.uniform(0.8, 0.95, n))
    group(600, -8.0, size + 8.0, (0.7, 12.0), lambda n: rng.uniform(0.05, 0.99, n))
    mean2d = np.concatenate([g[0] for g in groups]).astype(np.float32)
    conic = np.concatenate([g[1] for g in groups]).astype(np.float32)
    cov = np.concatenate([g[2] for g in groups])
    opacity = np.concatenate([g[3] for g in groups]).astype(np.float32)
    n = len(mean2d)
    sm = np.sqrt(np.maximum(2.0 * np.log(255.0 * opacity), 1e-6))
    radius_xy = np.ceil(sm[:, None] * np.sqrt(np.stack([cov[:, 0, 0], cov[:, 1, 1]], 1))
                        + 0.5).astype(np.int32)
    radius = np.ceil(3.0 * np.sqrt(np.linalg.eigvalsh(cov)[:, 1])).astype(np.int32)
    depth = rng.uniform(1.0, 10.0, n).astype(np.float32)
    channels = rng.uniform(-1.0, 1.0, (n, 7)).astype(np.float32)
    offset = rng.uniform(-0.5, 0.5, (size, size, 2)).astype(np.float32)
    return (mean2d, conic, depth, radius, opacity, channels, radius_xy, offset)


def kernels_vs_plain(torch, rt, inputs, dout, dtfin):
    """Kernel and plain version on the same card inputs: errors and rows."""
    table, binned, offx, offy, tiles_x = inputs
    args = (table, binned.gather_idx, binned.tile_start, binned.tile_count,
            offx, offy)
    out_k, tf_k = rt.composite_fwd(*args, tiles_x)
    out_p, tf_p = rt.composite_fwd_torch(*args, tiles_x)
    rows_k = rt.composite_bwd(*args, out_p, tf_p, dout, dtfin, tiles_x)
    rows_p = rt.composite_bwd_torch(*args, out_p, tf_p, dout, dtfin, tiles_x)
    torch.cuda.synchronize()
    fwd_err = max(float((out_k - out_p).abs().max()), float((tf_k - tf_p).abs().max()))
    col_max = rows_p.abs().amax(0)
    row_rel = float(((rows_k - rows_p).abs().amax(0) / col_max.clamp_min(1e-30)).max())
    gi = binned.gather_idx
    g_k = torch.zeros_like(table).index_add_(0, gi, rows_k)[:-1]
    g_p = torch.zeros_like(table).index_add_(0, gi, rows_p)[:-1]
    cols = [c for c in range(g_p.shape[1]) if float(g_p[:, c].norm()) > 0]
    g_rel = max(rel_norm(g_k[:, c], g_p[:, c]) for c in cols)
    return {"fwd_max_abs": fwd_err, "rows_max_abs": float((rows_k - rows_p).abs().max()),
            "rows_rel_colmax": row_rel, "grad_rel_norm": g_rel,
            "tf": tf_p, "rows": rows_k, "rows_plain": rows_p}


# ----------------------------------------------------------------------------
# Phase 5: the Trainer on the quality scene
# ----------------------------------------------------------------------------

def train_quality_seed(torch, rt, scene, seed: int, out_dir: str, snapshots: bool):
    """Train one Trainer seed on ``scene`` and return its record."""
    from skyfall_gs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from skyfall_gs_tpu_torch.io.synthetic import test_psnr
    from skyfall_gs_tpu_torch.model.gaussians import flat_fields
    from skyfall_gs_tpu_torch.ops.ssim import ssim
    from skyfall_gs_tpu_torch.train.logging import MetricsLogger
    from skyfall_gs_tpu_torch.train.loop import Trainer

    model_cfg = ModelConfig(model_path=out_dir, kernel_size=0.1, appearance_enabled=True,
                            appearance_n_fourier_freqs=4, appearance_embedding_dim=32)
    opt_cfg = OptimizationConfig(iterations=Q_ITERS, position_lr_max_steps=Q_ITERS, **Q_OPT)
    # Every step's metrics are logged (overflow included); they stay on the
    # card until the logger flushes every 200 steps.
    logger = MetricsLogger(out_dir, log_every=1, print_every=Q_ITERS)
    trainer = Trainer(model_cfg, opt_cfg, PipelineConfig(), scene, logger=logger,
                      rng_seed=seed)
    state = trainer.init_state()
    last = (Q_ITERS,) if snapshots else ()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(rt)
    t0 = time.perf_counter()
    state = trainer.train(state, iterations=Q_ITERS, test_iterations=last,
                          save_iterations=last, checkpoint_iterations=last)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    psnr = test_psnr(trainer, scene, state)
    with torch.no_grad():
        ssims = [float(ssim(torch.clamp(trainer._eval_render(state.model, v.camera,
                                                              trainer.bg).color, 0, 1)
                            .permute(2, 0, 1),
                            torch.tensor(v.image, device=trainer.device).permute(2, 0, 1)))
                 for v in scene.test_views]
    launches = launches_of(rt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logger.close()

    with open(Path(out_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["type"] == "step"]
    dens = [r for r in records if r["type"] == "densify"]
    assert len(steps) == Q_ITERS, len(steps)
    bad = [r["iter"] for r in steps if not np.isfinite([r["loss"], r["psnr"]]).all()]
    assert not bad, f"seed {seed}: non-finite loss at iterations {bad[:5]}"
    for k, v in flat_fields(state.model.params):
        assert bool(torch.isfinite(v).all()), f"seed {seed}: non-finite parameter {k}"
    overflow = max(int(r["overflow"]) for r in steps)
    assert overflow == 0, f"seed {seed}: binning overflow {overflow}"
    assert launches["fwd"] > 0 and launches["bwd"] > 0, launches
    if snapshots:
        ckpt = Path(out_dir) / f"chkpnt{Q_ITERS}.npz"
        ply = Path(out_dir) / "point_cloud" / f"iteration_{Q_ITERS}" / "point_cloud.ply"
        assert ply.is_file() and ply.stat().st_size > 0, ply
        back = trainer.init_state(start_checkpoint=str(ckpt))
        assert trainer.start_iteration == Q_ITERS and back.step == state.step
        for (k, a), (_, b) in zip(flat_fields(back.model.params), flat_fields(state.model.params)):
            assert bool(torch.equal(a, b)), f"checkpoint round trip changed {k}"
    return {"seed": seed, "psnr": psnr, "ssim": float(np.mean(ssims)),
            "n_splats": int(state.model.num_alive),
            "capacity": state.model.params.capacity, "densify_passes": len(dens),
            "n_dropped": sum(r["n_dropped"] for r in dens), "max_overflow": overflow,
            "wall_s": wall, "it_per_s": Q_ITERS / wall, "peak_gib": peak,
            "launches": launches}


def quality_phase(torch, rt, dev, card: str) -> dict:
    """Phase 5; returns the kernels' launch counts summed over the seeds."""
    from skyfall_gs_tpu_torch.io.synthetic import make_city_scene

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="skyfall_quality_") as tmp:
        scene = make_city_scene(tmp, device=dev, **Q_SCENE)
        runs = []
        for seed in Q_SEEDS:
            r = train_quality_seed(torch, rt, scene, seed, str(Path(tmp) / f"seed{seed}"),
                                   snapshots=(seed == Q_SEEDS[0]))
            runs.append(r)
            log(5, f"seed {seed} on [{card}]: test PSNR {r['psnr']:.3f} dB, SSIM "
                   f"{r['ssim']:.4f}, n_splats {r['n_splats']}, capacity {r['capacity']}, "
                   f"densify passes {r['densify_passes']}, n_dropped {r['n_dropped']}, max "
                   f"overflow {r['max_overflow']}, {Q_ITERS} it in {r['wall_s']:.2f} s "
                   f"({r['it_per_s']:.2f} it/s), peak memory {r['peak_gib']:.3f} GiB, "
                   f"launches fwd {r['launches']['fwd']} bwd {r['launches']['bwd']}")
            torch.cuda.empty_cache()
    psnrs = [r["psnr"] for r in runs]
    med = runs[int(np.argsort(psnrs)[(len(runs) - 1) // 2])]   # lower median: one real run
    log(5, f"median seed {med['seed']}: test PSNR {med['psnr']:.3f} dB, SSIM "
           f"{med['ssim']:.4f}, n_splats {med['n_splats']}; per-seed PSNR "
           f"{[round(p, 3) for p in psnrs]}, spread {max(psnrs) - min(psnrs):.3f} dB "
           f"(gate: median >= {Q_MIN_MEDIAN_PSNR} dB); phase 5 took "
           f"{time.perf_counter() - t_phase:.1f} s")
    assert med["psnr"] >= Q_MIN_MEDIAN_PSNR, f"median test PSNR {med['psnr']:.3f} dB"
    return {k: sum(r["launches"][k] for r in runs) for k in ("fwd", "bwd")}


# ----------------------------------------------------------------------------
# Phase 6: the command-line chain on a scene read from disk
# ----------------------------------------------------------------------------

def mib(path: Path) -> str:
    if path.is_dir():
        return f"{sum(f.stat().st_size for f in path.iterdir()) / 2**20:.2f} MiB (PNG dir)"
    return f"{path.stat().st_size / 2**20:.2f} MiB"


def cli_phase(torch, rt, dev, card: str, tmp: Path) -> dict:
    """Phase 6; returns the kernels' launch counts."""
    from skyfall_gs_tpu_torch.cli import create_fused_ply, gen_render_path, render_video
    from skyfall_gs_tpu_torch.cli import train as train_cli
    from skyfall_gs_tpu_torch.io.scene import load_scene
    from skyfall_gs_tpu_torch.io.synthetic import write_satellite_scene
    from skyfall_gs_tpu_torch.model.gaussians import flat_fields
    from skyfall_gs_tpu_torch.ops.ssim import ssim

    scene_dir, model = tmp / "scene", tmp / "model"
    t_phase = time.perf_counter()
    reset_launches(rt)
    n_init = write_satellite_scene(str(scene_dir), device=dev, **SAT_SCENE)
    t_write = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    scene = load_scene(str(scene_dir), eval_split=True, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    n_views = (scene.num_train, len(scene.test_views))
    assert len(scene.points) == n_init and n_views == (14, 2), (len(scene.points), n_views)
    del scene

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state = train_cli.main(
        ["-s", str(scene_dir), "-m", str(model), *TRAIN_FLAGS, "--device", DEVICE,
         "--test_iterations", str(TRAIN_ITERS), "--save_iterations", str(TRAIN_ITERS),
         "--checkpoint_iterations", str(TRAIN_ITERS), "--quiet"])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    with open(model / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["type"] == "step"]
    bad = [r["iter"] for r in steps if not np.isfinite([r["loss"], r["psnr"]]).all()]
    assert steps and not bad, f"non-finite loss at iterations {bad[:5]}"
    for k, v in flat_fields(state.model.params):
        assert bool(torch.isfinite(v).all()), f"non-finite parameter {k}"
    max_overflow = int(trainer.max_overflow)
    assert max_overflow == 0, f"binning overflow {max_overflow} in training"
    psnr = [r["psnr"] for r in records if r["type"] == "eval" and r["split"] == "test"][-1]
    with torch.no_grad():
        ssims = [float(ssim(torch.clamp(trainer._eval_render(state.model, v.camera,
                                                              trainer.bg).color, 0, 1)
                            .permute(2, 0, 1),
                            torch.tensor(v.image, device=dev).permute(2, 0, 1)))
                 for v in trainer.scene.test_views]
    it_s = TRAIN_ITERS / steps[-1]["elapsed"]
    n_splats = int(state.model.num_alive)
    train_launches = launches_of(rt)
    del trainer, state
    torch.cuda.empty_cache()

    path = gen_render_path.main(["--output_folder", str(tmp / "paths"), *PATH_FLAGS])
    path_kw = dict(zip(PATH_FLAGS[::2], PATH_FLAGS[1::2]))
    ckpt = model / f"chkpnt{TRAIN_ITERS}.npz"
    torch.cuda.reset_peak_memory_stats()
    _, fps_ckpt = render_video.main(["--checkpoint", str(ckpt), "--camera_path", path,
                                     "--out", str(tmp / "ckpt_rgb.mp4"), "--device", DEVICE])
    peak_render = torch.cuda.max_memory_allocated() / 2**30
    create_fused_ply.main(["-c", str(ckpt), "-o", str(tmp / "fused.ply")])
    create_fused_ply.main(["-c", str(ckpt), "-o", str(tmp / "fused.splat")])
    _, fps_ply = render_video.main(["--ply", str(tmp / "fused.ply"), "--camera_path", path,
                                    "--out", str(tmp / "ply_depth.mp4"), "--mode", "depth",
                                    "--device", DEVICE])
    launches = launches_of(rt)
    artifacts = {
        "checkpoint": ckpt,
        "ply": model / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply",
        "input.ply": model / "input.ply", "cameras.json": model / "cameras.json",
        "cfg_args.json": model / "cfg_args.json", "fused.ply": tmp / "fused.ply",
        "fused.splat": tmp / "fused.splat"}
    for name in ("ckpt_rgb", "ply_depth"):   # an MP4, or a PNG directory without cv2
        mp4, pngs = tmp / f"{name}.mp4", tmp / name
        artifacts[name] = mp4 if mp4.exists() else pngs
    for name, p in artifacts.items():
        assert p.exists() and (p.is_dir() and any(p.iterdir()) or p.stat().st_size > 0), \
            f"missing artifact {name}: {p}"
    assert launches["fwd"] > train_launches["fwd"] > 0 and train_launches["bwd"] > 0, launches
    log(6, f"CLI chain on [{card}]: wrote the {SAT_SCENE['size']} px satellite scene in "
           f"{t_write:.2f} s; load_scene {t_load:.3f} s, views {n_views[0]} train / "
           f"{n_views[1]} test, init points {n_init}; cli.train {TRAIN_ITERS} it in "
           f"{t_train:.2f} s wall ({it_s:.2f} it/s over the loop), test PSNR {psnr:.3f} dB "
           f"(floor {PSNR_FLOOR_DB} dB), SSIM {float(np.mean(ssims)):.4f}, final splats "
           f"{n_splats}, max overflow {max_overflow}, peak memory {peak_train:.3f} GiB; "
           f"{path_kw['--width']}x{path_kw['--height']} x {path_kw['--num_frame']}-frame "
           f"trajectory FPS: checkpoint rgb {fps_ckpt:.2f}, fused PLY "
           f"depth {fps_ply:.2f}, peak memory {peak_render:.3f} GiB; artifacts "
           + ", ".join(f"{k} {mib(p)}" for k, p in artifacts.items())
           + f"; launches fwd {launches['fwd']} bwd {launches['bwd']}; phase 6 took "
             f"{time.perf_counter() - t_phase:.1f} s")
    assert psnr >= PSNR_FLOOR_DB, f"test PSNR {psnr:.3f} dB under the floor {PSNR_FLOOR_DB}"
    return launches


# ----------------------------------------------------------------------------
# Phase 7: inference at full width on the 125k-splat stress scene
# ----------------------------------------------------------------------------

def stress_scene(dev):
    """scripts/bench_entry_budget.py's untrained 125k-splat disk scene."""
    from skyfall_gs_tpu_torch.model.gaussians import create_from_points

    rng = np.random.default_rng(0)
    r = 256 * np.sqrt(rng.uniform(0, 1, STRESS_SPLATS))
    th = rng.uniform(0, 2 * np.pi, STRESS_SPLATS)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(0, 40, STRESS_SPLATS)], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (STRESS_SPLATS, 3)).astype(np.float32)
    state = create_from_points(pts, cols, capacity=STRESS_SPLATS, device=dev)
    state.active_sh_degree = 3
    state.aux.filter_3d.fill_(0.3)
    return state


def render_fps(torch, state, cams, **kw):
    """FPS over STRESS_FRAMES frames cycling ``cams`` after STRESS_WARMUP
    warm-up frames, between two synchronizations, every frame held on the
    card until the clock stops (as ``render_trajectory`` holds them);
    returns (fps, the first frame of each camera, the largest overflow, the
    caching allocator's cudaMalloc calls in the timed loop)."""
    from skyfall_gs_tpu_torch.model.render import render

    bg = torch.zeros(3, device=state.params.xyz.device)

    def frame(cam):
        out = render(state, cam, bg, kernel_size=0.1, testing=True, inference=True, **kw)
        return torch.clamp(out.color, 0.0, 1.0), out.overflow

    with torch.no_grad():
        for i in range(STRESS_WARMUP):
            frame(cams[i % len(cams)])
        torch.cuda.synchronize()
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        t0 = time.perf_counter()
        outs = [frame(cams[i % len(cams)]) for i in range(STRESS_FRAMES)]
        torch.cuda.synchronize()
    fps = STRESS_FRAMES / (time.perf_counter() - t0)
    mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - mallocs
    return (fps, [o[0] for o in outs[:len(cams)]],
            int(torch.stack([o[1] for o in outs]).max()), mallocs)


def profile_frames(torch, state, cams, n: int = 8, **kw) -> dict:
    """torch.profiler over ``n`` frames cycling ``cams``, held as in
    ``render_fps``: wall and device-busy ms per frame, kernel launches per
    frame, the kernels with the most device time and the CUDA runtime calls
    with the most host time."""
    from skyfall_gs_tpu_torch.model.render import render

    bg = torch.zeros(3, device=state.params.xyz.device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [render(state, cams[i % len(cams)], bg, kernel_size=0.1, testing=True,
                       inference=True, **kw).color for i in range(n)]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / n
    del outs
    events = prof.key_averages()
    kernels = [(e.key, e.device_time_total / 1000 / n, e.count / n) for e in events
               if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))]
    runtime = [(e.key, e.self_cpu_time_total / 1000 / n, e.count / n) for e in events
               if e.key.startswith("cuda")]

    def top(rows, k):
        rows.sort(key=lambda r: -r[1])
        return "; ".join(f"{name[:60]} {ms:.3f} ms x{c:g}" for name, ms, c in rows[:k])

    busy = sum(r[1] for r in kernels)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle": max(0.0, 1 - busy / wall_ms),
            "launches": sum(c for name, _, c in runtime if name.startswith("cudaLaunchKernel")),
            "kernels": top(kernels, 8), "runtime": top(runtime, 5)}


def profile_summary(p: dict) -> str:
    return (f"under the profiler {p['wall_ms']:.3f} ms/frame wall, device busy "
            f"{p['busy_ms']:.3f} ms (idle share {p['idle']:.3f}), {p['launches']:g} kernel "
            f"launches/frame")


def stress_phase(torch, rt, dev, card: str) -> tuple[dict, float]:
    """Phase 7; returns the kernels' launch counts and the forward kernel's
    max abs error against its plain version on a 1080p frame."""
    from skyfall_gs_tpu_torch.core.camera import orbit_cameras
    from skyfall_gs_tpu_torch.model.gaussians import (
        opacity_with_3d_filter, scaling_with_3d_filter)
    from skyfall_gs_tpu_torch.model.render import compute_colors, measure_bin_capacity
    from skyfall_gs_tpu_torch.ops.binning import num_tiles, per_splat_entries
    from skyfall_gs_tpu_torch.ops.losses import psnr
    from skyfall_gs_tpu_torch.ops.projection import project_gaussians
    from skyfall_gs_tpu_torch.ops.rasterize import _apply_entry_budget

    t_phase = time.perf_counter()
    state = stress_scene(dev)
    launches = {"fwd": 0, "bwd": 0}
    for w, h in ((1920, 1088), (512, 512)):
        cams = orbit_cameras([0, 0, 0], 50.0, 500.0, num_cams=4, width=w, height=h,
                             fov_deg=60.0, uid_base=0, device=dev)
        cap = measure_bin_capacity(state, cams, kernel_size=0.1)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(rt)
        fps_full, full, overflow, mallocs = render_fps(torch, state, cams, bin_capacity=cap)
        for k, v in launches_of(rt).items():
            launches[k] += v
        assert overflow == 0, f"{w}x{h} full render overflow {overflow}"
        log(7, f"stress scene {STRESS_SPLATS} splats {w}x{h} on [{card}]: full render at "
               f"measured capacity {cap}: {fps_full:.2f} FPS ({1000 / fps_full:.3f} ms/frame, "
               f"{STRESS_FRAMES} frames over 4 cameras after {STRESS_WARMUP} warm-up), "
               f"overflow 0, cudaMalloc calls in the timed loop {mallocs}, peak memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if w != 1920:
            continue
        for budget in BUDGETS:
            kept = []
            with torch.no_grad():
                for cam in cams:
                    proj = project_gaussians(
                        state.params.xyz, scaling_with_3d_filter(state.params, state.aux.filter_3d),
                        state.params.rotation,
                        opacity_with_3d_filter(state.params, state.aux.filter_3d), cam,
                        kernel_size=0.1, mask=state.aux.alive)
                    proj = _apply_entry_budget(proj, cam, budget)
                    kept.append(int(per_splat_entries(proj.mean2d, proj.radius, h, w,
                                                      radius_xy=proj.radius_xy).sum()))
            assert max(kept) <= budget, (budget, kept)
            reset_launches(rt)
            fps, imgs, overflow, mallocs = render_fps(torch, state, cams, entry_budget=budget)
            for k, v in launches_of(rt).items():
                launches[k] += v
            assert overflow == 0, f"budget {budget}: overflow {overflow}"
            prof = profile_frames(torch, state, cams, entry_budget=budget)
            q = [float(psnr(a.permute(2, 0, 1), b.permute(2, 0, 1))) for a, b in zip(imgs, full)]
            log(7, f"stress scene 1920x1088 on [{card}]: entry_budget {budget}: {fps:.2f} FPS "
                   f"({fps / fps_full:.2f}x full), PSNR vs full {float(np.mean(q)):.2f} dB "
                   f"(per camera {[round(v, 2) for v in q]}), kept entries {kept} <= budget, "
                   f"overflow 0, cudaMalloc calls in the timed loop {mallocs}; "
                   + profile_summary(prof))
        prof = profile_frames(torch, state, cams, bin_capacity=cap)
        log(7, f"profile of the full 1920x1088 render on [{card}]: {profile_summary(prof)}; "
               f"top kernels per frame: {prof['kernels']}; host CUDA runtime calls per "
               f"frame: {prof['runtime']}")

    # The forward kernel against its plain version on one 1080p frame under
    # the 1M budget (launches for this comparison are not counted).
    cam = orbit_cameras([0, 0, 0], 50.0, 500.0, num_cams=4, width=1920, height=1088,
                        fov_deg=60.0, uid_base=0, device=dev)[1]
    with torch.no_grad():
        proj = project_gaussians(
            state.params.xyz, scaling_with_3d_filter(state.params, state.aux.filter_3d),
            state.params.rotation, opacity_with_3d_filter(state.params, state.aux.filter_3d),
            cam, kernel_size=0.1, mask=state.aux.alive)
        proj = _apply_entry_budget(proj, cam, 1_000_000)
        chans = torch.cat([compute_colors(state, cam, testing=True), proj.depth[:, None],
                           torch.zeros_like(state.params.xyz)], 1)
        table, binned, offx, offy = rt.composite_inputs(
            proj.mean2d, proj.conic, proj.depth, proj.radius, proj.opacity, chans,
            1088, 1920, cap=1_000_000, radius_xy=proj.radius_xy)
        args = (table, binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy,
                num_tiles(1088, 1920)[1])
        out_k, tf_k = rt.composite_fwd(*args)
        t0 = time.perf_counter()
        out_p, tf_p = rt.composite_fwd_torch(*args)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    err = max(float((out_k - out_p).abs().max()), float((tf_k - tf_p).abs().max()))
    assert int(binned.overflow) == 0 and int(binned.num_entries) <= 1_000_000
    log(7, f"forward kernel vs plain on one 1920x1088 frame under entry_budget 1000000 "
           f"({int(binned.num_entries)} entries, max tile {int(binned.tile_count.max())}) on "
           f"[{card}]: max abs {err:.3e} (tol 1e-4), plain version {t_plain:.2f} s; phase 7 "
           f"took {time.perf_counter() - t_phase:.1f} s")
    assert err <= 1e-4, err
    return launches, err


# ----------------------------------------------------------------------------
# Main
# ----------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / KERNEL_SOURCE).is_file():
        print(f"chip_smoke: {KERNEL_SOURCE} not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)

    from skyfall_gs_tpu_torch.config import OptimizationConfig
    from skyfall_gs_tpu_torch.core.camera import orbit_cameras
    from skyfall_gs_tpu_torch.model.gaussians import (
        create_from_points, flat_fields, opacity_with_3d_filter, scaling_with_3d_filter,
        state_from_numpy, state_to_numpy)
    from skyfall_gs_tpu_torch.model.render import compute_colors, measure_bin_capacity
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt
    from skyfall_gs_tpu_torch.ops.binning import num_tiles
    from skyfall_gs_tpu_torch.ops.projection import project_gaussians
    from skyfall_gs_tpu_torch.train.step import (
        _build_grads_fn, init_train_state, make_train_step)

    # -- phase 0: the card and the toolchain ---------------------------------
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    name = torch.cuda.get_device_name(0)
    nvcc = run([rt.nvcc_path(), "--version"]).splitlines()[-1]
    log(0, f"card [{card}] torch {torch.__version__} cuda {torch.version.cuda} "
           f"nvcc [{nvcc}] devices {torch.cuda.device_count()}")
    log(0, f"image libraries: PIL {module_version('PIL')}, cv2 {module_version('cv2')} "
           "(the port reads PNG scenes with io/png.py and needs neither)")

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = rt.build_library()
    rt._library()
    ptxas = " | ".join(ln.split("ptxas info    : ")[-1] for ln in
                       lib.with_suffix(".log").read_text().splitlines() if "Used" in ln)
    log(1, f"built {lib.name} in {time.perf_counter() - t0:.1f} s; ptxas: {ptxas}")

    # -- phase 2: kernels vs plain at 128x128 ---------------------------------
    rng = np.random.default_rng(0)
    mean2d, conic, depth, radius, opacity, channels, radius_xy, offset = [
        torch.from_numpy(a).to(dev) for a in screen_scene(rng)]
    table, binned, offx, offy = rt.composite_inputs(
        mean2d, conic, depth, radius, opacity, channels, 128, 128,
        subpixel_offset=offset, cap=1 << 16, radius_xy=radius_xy)
    tiles_x = num_tiles(128, 128)[1]
    t_total = binned.tile_start.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    dout = torch.randn((t_total, rt.NCH, rt.P), device=dev, generator=gen)
    dtfin = torch.randn((t_total, rt.P), device=dev, generator=gen)
    res = kernels_vs_plain(torch, rt, (table, binned, offx, offy, tiles_x), dout, dtfin)
    counts = binned.tile_count.cpu().numpy()
    tf_tiles = res["tf"].amax(1).cpu().numpy()
    saturated = np.flatnonzero((tf_tiles < 1e-3) & (counts > 100))
    assert int(binned.overflow) == 0, "phase 2 scene overflowed its capacity"
    assert counts.max() > 1000, f"no tile with more than 1k entries: {counts.max()}"
    assert len(saturated) > 0, "no saturated tile in the phase 2 scene"
    # Entries behind the last one the plain version composites in a
    # saturated tile: the kernel's early exit must leave them exactly zero.
    tails = []
    for t in saturated:
        s0, cnt = int(binned.tile_start[t]), int(counts[t])
        live = torch.nonzero(res["rows_plain"][s0:s0 + cnt].abs().sum(1))
        tails.append((cnt - (int(live.max()) + 1 if len(live) else 0), s0, cnt))
    n_tail, s0, cnt = max(tails)
    assert n_tail >= 64, f"saturated tiles have no tail past termination: {n_tail}"
    assert bool((res["rows"][s0 + cnt - n_tail:s0 + cnt] == 0).all()), \
        "post-termination entries got gradient rows"
    log(2, f"128x128, {len(mean2d)} splats, {int(binned.num_entries)} entries, "
           f"max tile {counts.max()}, saturated tiles {len(saturated)} (longest tail "
           f"past termination {n_tail} entries, all-zero rows): "
           f"fwd max abs {res['fwd_max_abs']:.3e} (tol 1e-4), rows max err / col max "
           f"{res['rows_rel_colmax']:.3e} (tol 1e-4), per-gaussian grads rel norm "
           f"{res['grad_rel_norm']:.3e} (tol 1e-4)")
    assert res["fwd_max_abs"] <= 1e-4, res["fwd_max_abs"]
    assert res["rows_rel_colmax"] <= 1e-4, res["rows_rel_colmax"]
    assert res["grad_rel_norm"] <= 1e-4, res["grad_rel_norm"]

    # -- phase 3: the main path at the bench workload --------------------------
    rng = np.random.default_rng(0)
    r = 256 * np.sqrt(rng.uniform(0, 1, N_GAUSSIANS))
    th = rng.uniform(0, 2 * np.pi, N_GAUSSIANS)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(0, 40, N_GAUSSIANS)], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (N_GAUSSIANS, 3)).astype(np.float32)
    state = create_from_points(pts, cols, capacity=int(N_GAUSSIANS * 1.25), device=dev)
    state.active_sh_degree = 3
    state.aux.filter_3d.fill_(0.3)
    ts = init_train_state(state)
    cams = orbit_cameras([0, 0, 0], 50.0, 500.0, num_cams=8, width=IMG, height=IMG,
                         fov_deg=60.0, uid_base=0, device=dev)
    gt = torch.from_numpy(rng.uniform(0, 1, (IMG, IMG, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((IMG, IMG), device=dev)
    gt_depth = torch.from_numpy(rng.uniform(1, 500, (IMG, IMG)).astype(np.float32)).to(dev)
    bg = torch.zeros(3, device=dev)
    opt_cfg = OptimizationConfig()
    cap = measure_bin_capacity(ts.model, cams, kernel_size=0.1)
    step = make_train_step(opt_cfg, use_depth=True, bin_capacity=cap)

    n_steps = WARMUP_STEPS + MEASURE_STEPS
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
    metrics = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(rt)
    t_wall = time.perf_counter()
    for i in range(n_steps):
        if i == WARMUP_STEPS:
            t_wall = time.perf_counter()
        events[i].record()
        ts, m = step(ts, cams[i % len(cams)], gt, mask, gt_depth, bg, 1e-4, 0.1)
        metrics.append(m)
    events[n_steps].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    launches = launches_of(rt)
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(WARMUP_STEPS, n_steps)]
    losses = torch.stack([m.loss for m in metrics])
    overflow = torch.stack([m.overflow for m in metrics])
    n_alive = torch.stack([m.n_alive for m in metrics])
    assert bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}"
    for k, v in flat_fields(ts.model.params):
        assert bool(torch.isfinite(v).all()), f"non-finite parameter {k}"
    assert int(overflow.max()) == 0, f"bin capacity overflow: {overflow.tolist()}"
    assert bool((n_alive == N_GAUSSIANS).all()), n_alive.tolist()
    assert launches == {"fwd": n_steps, "bwd": n_steps}, launches
    med = float(np.median(step_ms))
    log(3, f"main path on [{card}]: {n_steps} steps at {IMG}px / {N_GAUSSIANS} splats, "
           f"bin capacity {cap}, loss {float(losses[0]):.5f} -> {float(losses[-1]):.5f}, "
           f"overflow 0, n_alive {N_GAUSSIANS}, launches fwd {launches['fwd']} bwd "
           f"{launches['bwd']}; median step {med:.3f} ms "
           f"({1000.0 / med:.2f} it/s), host clock {MEASURE_STEPS / wall:.2f} it/s, "
           f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Each kernel alone against its plain version at the bench shape.
    with torch.no_grad():
        model, cam = ts.model, cams[0]
        proj = project_gaussians(
            model.params.xyz, scaling_with_3d_filter(model.params, model.aux.filter_3d),
            model.params.rotation, opacity_with_3d_filter(model.params, model.aux.filter_3d),
            cam, kernel_size=0.1, mask=model.aux.alive)
        chans = torch.cat([compute_colors(model, cam), proj.depth[:, None],
                           torch.zeros_like(model.params.xyz)], 1)
        table, binned, offx, offy = rt.composite_inputs(
            proj.mean2d, proj.conic, proj.depth, proj.radius, proj.opacity, chans,
            IMG, IMG, cap=cap, radius_xy=proj.radius_xy)
    tiles_x = num_tiles(IMG, IMG)[1]
    t_total = binned.tile_start.shape[0]
    dout = torch.randn((t_total, rt.NCH, rt.P), device=dev, generator=gen) * 1e-3
    dtfin = torch.randn((t_total, rt.P), device=dev, generator=gen) * 1e-3
    bench = kernels_vs_plain(torch, rt, (table, binned, offx, offy, tiles_x), dout, dtfin)
    assert bench["fwd_max_abs"] <= 1e-4, bench["fwd_max_abs"]
    assert bench["rows_rel_colmax"] <= 1e-4, bench["rows_rel_colmax"]
    args = (table, binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy)
    out, tf = rt.composite_fwd(*args, tiles_x)
    fwd = lambda: rt.composite_fwd(*args, tiles_x)                       # noqa: E731
    bwd = lambda: rt.composite_bwd(*args, out, tf, dout, dtfin, tiles_x)  # noqa: E731
    fwd_p = lambda: rt.composite_fwd_torch(*args, tiles_x)               # noqa: E731
    bwd_p = lambda: rt.composite_bwd_torch(*args, out, tf, dout, dtfin, tiles_x)  # noqa: E731
    times = {}
    for key, fn, reps in (("fwd_plain", fwd_p, 2), ("fwd", fwd, 50), ("bwd", bwd, 50),
                          ("bwd_plain", bwd_p, 2), ("fwd_plain2", fwd_p, 2),
                          ("fwd2", fwd, 50), ("bwd2", bwd, 50), ("bwd_plain2", bwd_p, 2)):
        fn()
        times[key] = cuda_ms(fn, reps, torch)
    ms = {k: min(times[k], times[k + "2"]) for k in ("fwd", "bwd", "fwd_plain", "bwd_plain")}
    n_entries = int(binned.num_entries)
    log(3, f"kernels alone at {IMG}px ({n_entries} entries, max tile "
           f"{int(binned.tile_count.max())}) on [{card}]: fwd {ms['fwd']:.4f} ms vs plain "
           f"{ms['fwd_plain']:.2f} ms, bwd {ms['bwd']:.4f} ms vs plain "
           f"{ms['bwd_plain']:.2f} ms; fwd max abs {bench['fwd_max_abs']:.3e}, rows max err "
           f"/ col max {bench['rows_rel_colmax']:.3e}, per-gaussian grads rel norm "
           f"{bench['grad_rel_norm']:.3e}")

    # -- phase 4: one step on the card against the CPU on a small scene --------
    rng = np.random.default_rng(1)
    n = 600
    small = create_from_points(rng.normal(0, 1.0, (n, 3)), rng.uniform(0, 1, (n, 3)),
                               capacity=768)
    small.active_sh_degree = 3
    small.aux.filter_3d.fill_(0.05)
    small.params.features_rest.copy_(torch.from_numpy(
        rng.normal(0, 0.1, tuple(small.params.features_rest.shape)).astype(np.float32)))
    host = state_to_numpy(small)
    img = 64
    cam_c = orbit_cameras([0, 0, 0], 30.0, 4.0, num_cams=1, width=img, height=img)[0]
    view = [rng.uniform(0, 1, (img, img, 3)), np.ones((img, img)),
            rng.uniform(1, 5, (img, img))]
    grads_fn = _build_grads_fn(opt_cfg, use_depth=True, ray_jitter=True, resample_gt=True)
    offset = rng.uniform(-0.5, 0.5, (img, img, 2)).astype(np.float32)
    results = []
    for d in (torch.device("cpu"), dev):
        st = state_from_numpy(host, device=d)
        v = [torch.from_numpy(a.astype(np.float32)).to(d) for a in view]
        results.append(grads_fn(st, cam_c.to(d), *v, torch.zeros(3, device=d), 0.01,
                                subpixel_offset=torch.from_numpy(offset).to(d)))
    (loss_c, _, g_c, dd_c), (loss_g, _, g_g, dd_g) = results
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    g_card = dict(flat_fields(g_g))
    grad_rel = {k: rel_norm(g_card[k].cpu(), v) for k, v in flat_fields(g_c)}
    grad_rel["mean2d"] = rel_norm(dd_g[0].cpu(), dd_c[0])
    grad_rel["mean2d_abs"] = rel_norm(dd_g[1].cpu(), dd_c[1])
    worst = max(grad_rel, key=grad_rel.get)
    log(4, f"{img}px / {n} splats, ray jitter + resampled GT: loss card {float(loss_g):.6f} "
           f"cpu {float(loss_c):.6f} (rel {loss_rel:.2e}, tol 1e-4); worst grad rel norm "
           f"{worst} {grad_rel[worst]:.2e} (tol 1e-3)")
    assert loss_rel <= 1e-4, loss_rel
    assert grad_rel[worst] <= 1e-3, grad_rel

    # -- phase 5: the Trainer on the quality scene ------------------------------
    for k, n in quality_phase(torch, rt, dev, card).items():
        launches[k] += n

    # -- phase 6: the CLI chain on a scene read from disk -------------------------
    with tempfile.TemporaryDirectory(prefix="skyfall_cli_") as tmp:
        counts = cli_phase(torch, rt, dev, card, Path(tmp))
    for k, n in counts.items():
        launches[k] += n
    torch.cuda.empty_cache()

    # -- phase 7: inference at full width ---------------------------------------
    counts, fwd_err_1080p = stress_phase(torch, rt, dev, card)
    for k, n in counts.items():
        launches[k] += n

    kernels = [
        {"name": "composite_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "skyfall_gs_tpu/ops/rasterize_tiled.py:506",
         "launches": launches["fwd"],
         "max_abs_err": max(bench["fwd_max_abs"], fwd_err_1080p),
         "ms": ms["fwd"], "plain_ms": ms["fwd_plain"]},
        {"name": "composite_bwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "skyfall_gs_tpu/ops/rasterize_tiled.py:544",
         "launches": launches["bwd"], "max_abs_err": bench["rows_max_abs"],
         "ms": ms["bwd"], "plain_ms": ms["bwd_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
