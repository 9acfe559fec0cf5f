"""Training CLI: the Stage-1 entry point.

Port of ``skyfall_gs_tpu/cli/train.py``: the same flags (one per field of
the model, pipeline and optimization configs, test / save / checkpoint
iterations, ``--start_checkpoint``, ``--seed``, ``--profile_dir``) plus
``--device`` (default ``cuda``; there is no fallback to the CPU).

Usage:
    python -m skyfall_gs_tpu_torch.cli.train -s <scene> -m <out> [--eval] ...
    python -m skyfall_gs_tpu_torch.cli.train -s <scene> -m <out> --device cpu ...

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
Queue 1 item: ``--iterative_datasets_update`` and ``--lambda_pseudo_depth
> 0`` (item 14), ``--gui_port`` (item 15), ``--data_parallel``,
``--shard_gaussians`` and a multi-host ``SKYFALL_*`` environment (item 16).
"""

from __future__ import annotations

import argparse
import os

import torch

from skyfall_gs_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    add_config_args,
    extract_config,
    save_config,
)
from skyfall_gs_tpu_torch.utils.general import seed_everything


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="skyfall_gs_tpu_torch trainer")
    add_config_args(parser, ModelConfig())
    add_config_args(parser, PipelineConfig())
    add_config_args(parser, OptimizationConfig())
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 15_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 15_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[30_000])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--iterative_datasets_update", action="store_true")
    parser.add_argument("--refiner", type=str, default="identity",
                        help="IDU refine backend (identity|flowedit)")
    parser.add_argument("--depth_model", type=str, default="render",
                        help="monodepth backend (render|moge)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler chrome trace of ~20 steps here")
    parser.add_argument("--gui_ip", type=str, default="127.0.0.1")
    parser.add_argument("--gui_port", type=int, default=0,
                        help="enable the SIBR viewer bridge on this port")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly: error at the first "
                             "backward op that produces a NaN")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, cuda:N or cpu)")
    return parser


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def _unported(args, pipe_cfg: PipelineConfig, opt_cfg: OptimizationConfig) -> None:
    multi_host = bool(os.environ.get("SKYFALL_COORDINATOR")) or \
        int(os.environ.get("SKYFALL_NUM_PROCESSES", "1")) > 1
    for hit, what, item in (
            (args.iterative_datasets_update, "--iterative_datasets_update (Stage 2)", 14),
            (opt_cfg.lambda_pseudo_depth > 0, "pseudo-view depth supervision", 14),
            (args.gui_port, "the live viewer (--gui_port)", 15),
            (pipe_cfg.data_parallel, "--data_parallel", 16),
            (pipe_cfg.shard_gaussians, "--shard_gaussians", 16),
            (multi_host, "multi-host training (SKYFALL_* environment)", 16)):
        if hit:
            raise NotImplementedError(f"{what} is not ported yet "
                                      f"(ROADMAP Queue 1 item {item})")


def main(argv=None):
    """Train; returns ``(trainer, final train state)``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    model_cfg = extract_config(args, ModelConfig)
    pipe_cfg = extract_config(args, PipelineConfig)
    opt_cfg = extract_config(args, OptimizationConfig)

    if not model_cfg.source_path or not model_cfg.model_path:
        parser.error("--source_path/-s and --model_path/-m are required")
    _unported(args, pipe_cfg, opt_cfg)
    device = resolve_device(args.device)

    seed_everything(args.seed)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    save_config(model_cfg.model_path, model_cfg, pipe_cfg, opt_cfg)

    from skyfall_gs_tpu_torch.io.scene import load_scene
    from skyfall_gs_tpu_torch.train.loop import Trainer

    scene = load_scene(
        model_cfg.source_path,
        resolution=model_cfg.resolution,
        eval_split=model_cfg.eval,
        white_background=model_cfg.white_background,
        load_allres=model_cfg.load_allres,
        model_path=model_cfg.model_path,
        seed=args.seed,
        device=device,
    )
    print(f"Loaded {scene.scene_type} scene: {scene.num_train} train / "
          f"{len(scene.test_views)} test views, "
          f"{len(scene.points)} points, extent {scene.cameras_extent:.1f}")

    trainer = Trainer(model_cfg, opt_cfg, pipe_cfg, scene, rng_seed=args.seed,
                      profile_dir=args.profile_dir)
    state = trainer.init_state(args.start_checkpoint)
    state = trainer.train(
        state,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
    )
    print("Training complete.")
    return trainer, state


if __name__ == "__main__":
    main()
