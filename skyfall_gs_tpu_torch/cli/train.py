"""Training CLI: Stage 1, and Stage 2 (IDU) from a Stage-1 checkpoint.

Port of ``skyfall_gs_tpu/cli/train.py``: the same flags (one per field of
the model, pipeline and optimization configs, test / save / checkpoint
iterations, ``--start_checkpoint``, ``--seed``, ``--profile_dir``,
``--iterative_datasets_update`` with ``--refiner`` and ``--depth_model``)
plus ``--device`` (default ``cuda``; there is no fallback to the CPU) and
``--idu_episodes`` (stop Stage 2 after that many curriculum episodes: a
cut for smoke runs; 0, the default, runs the whole curriculum).

With ``--lambda_pseudo_depth > 0`` Stage 1 supervises pseudo views with
the ``--depth_model`` backend.  ``--iterative_datasets_update`` needs
``--start_checkpoint`` and runs the IDU curriculum with the ``--refiner``
backend (``flowedit`` when ``--idu_use_flow_edit``).  The ``flowedit`` and
``moge`` backends need weights this command line cannot pass, so they
raise ``RuntimeError``; build them with ``priors.get_refiner`` /
``get_depth_predictor`` and a local checkpoint from Python instead.

Usage:
    python -m skyfall_gs_tpu_torch.cli.train -s <scene> -m <out> [--eval] ...
    python -m skyfall_gs_tpu_torch.cli.train -s <scene> -m <out> \
        --iterative_datasets_update --start_checkpoint <out>/chkpnt30000.npz
    python -m skyfall_gs_tpu_torch.cli.train -s <scene> -m <out> --device cpu ...

``--use_lpips_loss`` (with ``--lpips_net alex|vgg``) trains with the LPIPS
photometric loss; it needs local LPIPS weights (torchvision's cache and the
``lpips`` package) and raises ``RuntimeError`` without them.

``--gui_port P`` (with ``--gui_ip``) opens the SIBR viewer bridge
(``viz.network_gui.NetworkGUI``) on that port; the Trainer serves the
viewer before every Stage-1 iteration.  0, the default, opens none.

``--data_parallel N`` trains view-parallel over N ranks
(``parallel.mesh.launch``, one spawned process per rank; -1: every visible
GPU): NCCL on ``--device cuda`` (rank r on ``cuda:r``; more ranks than
visible GPUs raise before anything starts) and gloo on ``--device cpu``.
Each iteration trains one view per rank (``Trainer(mesh=...)``); rank 0
alone writes ``cfg_args.json``, the scene's ``input.ply`` and
``cameras.json``, logs, reports, checkpoints and PLYs.  A multi-host pod
sets ``SKYFALL_COORDINATOR`` / ``SKYFALL_NUM_PROCESSES`` /
``SKYFALL_PROCESS_ID`` on each host (``parallel.mesh.multihost_slot_envs``
writes them for ``parallel.launcher``); each host then starts its share of
the ranks (``--data_parallel N`` counts the whole pod, -1 every GPU of each
host, 0 one rank per host) and joins the pod at the coordinator.  Half a
configuration raises ``RuntimeError``.  With ranks, ``main`` returns None
once every rank has finished; a rank that fails fails the run.

Not ported, raising ``NotImplementedError`` that names where the ROADMAP
places it: ``--shard_gaussians`` (left out of the port: gaussian-sharded
training).
"""

from __future__ import annotations

import argparse
import sys

import torch

from skyfall_gs_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    add_config_args,
    extract_config,
    save_config,
)
from skyfall_gs_tpu_torch.parallel.mesh import launch, pod_config
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
    parser.add_argument("--idu_episodes", type=int, default=0,
                        help="stop Stage 2 after this many curriculum episodes, a cut "
                             "for smoke runs (0: the whole curriculum)")
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


def local_ranks(data_parallel: int, device: torch.device, pod) -> int:
    """How many ranks this process starts: ``--data_parallel`` ranks (on a
    pod, its share of them), every visible GPU for -1, one per host on a
    pod without the flag."""
    if data_parallel < 0:
        if device.type != "cuda":
            raise SystemExit("--data_parallel -1 means every visible GPU; give a count "
                             f"with --device {device}")
        return torch.cuda.device_count()
    if pod is None or data_parallel == 0:
        return max(data_parallel, 1)
    if data_parallel % pod[1]:
        raise SystemExit(f"--data_parallel {data_parallel} does not divide over the "
                         f"pod's {pod[1]} processes")
    return data_parallel // pod[1]


def main(argv=None):
    """Train; returns ``(trainer, final train state)``, and with
    ``--iterative_datasets_update`` ``(orchestrator, final train state)``.
    With ranks (``--data_parallel`` or a pod) it returns None once they
    have all finished."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    model_cfg = extract_config(args, ModelConfig)
    pipe_cfg = extract_config(args, PipelineConfig)

    if not model_cfg.source_path or not model_cfg.model_path:
        parser.error("--source_path/-s and --model_path/-m are required")
    if pipe_cfg.data_parallel and pipe_cfg.shard_gaussians:
        raise SystemExit("--data_parallel and --shard_gaussians are mutually exclusive")
    if pipe_cfg.shard_gaussians:
        raise NotImplementedError("--shard_gaussians is not ported "
                                  "(ROADMAP: left out of the port)")
    if args.iterative_datasets_update and not args.start_checkpoint:
        parser.error("--start_checkpoint is required for IDU")
    pod = pod_config()
    device = resolve_device(args.device)
    if pipe_cfg.data_parallel or pod is not None:
        n = local_ranks(pipe_cfg.data_parallel, device, pod)
        print(f"view-parallel training: {n} local ranks on {device.type}"
              + (f", process {pod[2]} of a {pod[1]}-process pod" if pod else ""), flush=True)
        launch(_rank_main, n, (argv,), device=device.type, pod=pod)
        return None
    return _train(args, device)


def _rank_main(mesh, argv: list) -> None:
    """One rank of a view-parallel run (``launch``'s target)."""
    _train(build_parser().parse_args(argv), mesh.device, mesh)


def _train(args, device: torch.device, mesh=None):
    model_cfg = extract_config(args, ModelConfig)
    pipe_cfg = extract_config(args, PipelineConfig)
    opt_cfg = extract_config(args, OptimizationConfig)
    main_rank = mesh is None or mesh.is_main

    seed_everything(args.seed)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if main_rank:
        save_config(model_cfg.model_path, model_cfg, pipe_cfg, opt_cfg)

    from skyfall_gs_tpu_torch.io.scene import load_scene
    from skyfall_gs_tpu_torch.priors import get_depth_predictor, get_refiner
    from skyfall_gs_tpu_torch.train.loop import Trainer

    scene = load_scene(
        model_cfg.source_path,
        resolution=model_cfg.resolution,
        eval_split=model_cfg.eval,
        white_background=model_cfg.white_background,
        load_allres=model_cfg.load_allres,
        model_path=model_cfg.model_path if main_rank else None,
        seed=args.seed,
        device=device,
    )
    if main_rank:
        print(f"Loaded {scene.scene_type} scene: {scene.num_train} train / "
              f"{len(scene.test_views)} test views, "
              f"{len(scene.points)} points, extent {scene.cameras_extent:.1f}")

    depth_pred = None
    if opt_cfg.lambda_pseudo_depth > 0:
        depth_pred = get_depth_predictor(args.depth_model)
    gui = None
    if args.gui_port and main_rank:
        from skyfall_gs_tpu_torch.viz.network_gui import NetworkGUI

        gui = NetworkGUI(args.gui_ip, args.gui_port)
    trainer = Trainer(model_cfg, opt_cfg, pipe_cfg, scene, depth_predictor=depth_pred,
                      rng_seed=args.seed, gui=gui, profile_dir=args.profile_dir, mesh=mesh)
    if args.iterative_datasets_update:
        from skyfall_gs_tpu_torch.train.idu import IDUOrchestrator

        # The backends first: one without weights fails before any work.
        orch = IDUOrchestrator(
            trainer=trainer,
            refiner=get_refiner("flowedit" if opt_cfg.idu_use_flow_edit else args.refiner),
            depth_predictor=get_depth_predictor(args.depth_model))
        state = trainer.init_state(args.start_checkpoint)
        state = orch.run(state, trainer.start_iteration, episodes=args.idu_episodes)
        if main_rank:
            print("Training complete.")
        return orch, state
    state = trainer.init_state(args.start_checkpoint)
    state = trainer.train(
        state,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
    )
    if main_rank:
        print("Training complete.")
    return trainer, state


if __name__ == "__main__":
    main()
