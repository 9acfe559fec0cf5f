"""Configuration system: dataclass groups with auto-generated CLI flags.

Capability parity: reference arguments/__init__.py — ParamGroup reflection
(attributes become argparse flags, ``_name`` attributes gain one-letter
shorthands, :35-89), ModelParams (:92-126), PipelineParams (:129-137),
OptimizationParams incl. pseudo-view/IDU/FlowEdit knobs (:140-284), the
per-dataset IDUParams registry (:238-249), and get_combined_args' saved
``cfg_args`` merge (:287-321 — re-implemented with json instead of eval).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field, fields
from typing import Dict, Tuple


# Attributes whose reference names start with "_" (shorthand flags).
_SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "resolution": "r",
    "white_background": "w",
    "kernel_size": "k",
}


@dataclass
class IDUCurriculum:
    """Per-dataset IDU curriculum (reference IDUParams, :22-27, 238-249)."""

    elevation_list: Tuple[float, ...] = ()
    radius_list: Tuple[float, ...] = ()
    fov: float = 60.0


IDU_CURRICULA: Dict[str, IDUCurriculum] = {
    "jax_v1": IDUCurriculum(
        elevation_list=(85.0, 75.0, 65.0, 55.0, 45.0),
        radius_list=(300.0, 275.0, 275.0, 250.0, 250.0),
        fov=60.0,
    ),
    "nyc_v1": IDUCurriculum(
        elevation_list=(85.0, 75.0, 65.0, 55.0, 45.0, 25.0),
        radius_list=(600.0, 600.0, 600.0, 600.0, 600.0, 600.0),
        fov=20.0,
    ),
}


@dataclass
class ModelConfig:
    sh_degree: int = 3
    appearance_enabled: bool = False
    appearance_n_fourier_freqs: int = 4
    appearance_embedding_dim: int = 32
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    kernel_size: float = 0.1
    eval: bool = False
    ray_jitter: bool = False
    resample_gt_image: bool = False
    load_allres: bool = False
    sample_more_highres: bool = False


@dataclass
class PipelineConfig:
    # convert_SHs_python / compute_cov3D_python are CUDA-side toggles in the
    # reference; on TPU colors and covariances are always computed in XLA.
    debug: bool = False
    rasterizer_backend: str = "tiled"          # "tiled" | "reference"
    bin_capacity: int = 0                      # 0 = auto heuristic
    gaussian_capacity: int = 0                 # 0 = auto (1.5x init points)
    # Fuse up to this many consecutive training steps into one lax.scan
    # dispatch (TPU dispatch through the runtime costs ~1.4 ms/call; fused
    # windows amortize it).  Windows never cross host events (SH bump,
    # pseudo-view supervision, densify, opacity reset, logging milestones)
    # and fall back to single steps when the GUI is attached.  1 = off.
    fuse_steps: int = 8
    # View-parallel data parallelism: train B views per iteration over a
    # B-device mesh (gradients pmean'd over ICI, replicated update; see
    # parallel/sharding.py and the Trainer docstring for the batch-scaling
    # semantics).  0 = off, -1 = all local devices, N = exactly N devices.
    data_parallel: int = 0
    # Gaussian (splat-state) sharding: params + Adam moments + densify
    # stats live 1/G per device over a G-device mesh — HBM scaling for
    # scenes larger than one chip (depth-binned exact compositing,
    # densification included; see parallel/gauss_shard.py).  Mutually
    # exclusive with data_parallel.  0 = off, -1 = all local devices.
    shard_gaussians: int = 0


@dataclass
class OptimizationConfig:
    iterations: int = 30_000

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000

    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 1000
    densify_until_iter: int = 20_000
    densify_grad_threshold: float = 0.0002
    size_threshold: int = 20

    lambda_dssim: float = 0.2
    lambda_depth: float = 0.5
    lambda_opacity: float = 0.1
    opacity_cooldown_iterations: int = 500

    # appearance
    embedding_lr: float = 0.005
    appearance_embedding_lr: float = 0.001
    appearance_embedding_regularization: float = 0.0
    appearance_mlp_lr: float = 0.0005

    # LPIPS-based photometric loss (requires local LPIPS weights)
    use_lpips_loss: bool = False
    lpips_net: str = "alex"

    # pseudo-view monodepth supervision
    sample_pseudo_interval: int = 10
    start_sample_pseudo: int = 2000
    end_sample_pseudo: int = 9500
    lambda_pseudo_depth: float = 0.0
    num_pseudo_cams: int = 24
    target_std: float = 64.0

    # IDU (stage 2)
    idu_no_curriculum: bool = False
    idu_episode_iterations: int = 10_000
    idu_densify_until_iter: int = 7500
    idu_opacity_reset_interval: int = 5000
    idu_opacity_cooling_iterations: int = 1000
    idu_testing_interval: int = 5000
    idu_refine: bool = False
    idu_random_ap: bool = False
    idu_iter_full_train: int = 0
    idu_num_cams: int = 12
    idu_num_samples_per_view: int = 4
    idu_train_ratio: float = 0.5
    datasets_type: str = "jax_v1"
    idu_position_lr_max_steps: int = 10_000
    idu_render_size: int = 1024
    idu_grid_width: int = 256
    idu_grid_height: int = 256
    idu_grid_size: int = 2

    # refine backends
    idu_use_flow_edit: bool = False
    idu_flow_edit_n_min: int = 0
    idu_flow_edit_n_max: int = 15
    idu_flow_edit_n_max_end: int = -1
    idu_flow_edit_n_avg: int = 1
    idu_model_type: str = "FLUX"

    post_training_iterations: int = 500


def add_config_args(parser: ArgumentParser, cfg, prefix: str = "") -> None:
    """Reflectively add one flag per dataclass field (ParamGroup analog)."""
    group = parser.add_argument_group(type(cfg).__name__)
    for f in fields(cfg):
        name = f.name
        default = getattr(cfg, name)
        flags = [f"--{prefix}{name}"]
        if name in _SHORTHANDS:
            flags.append(f"-{_SHORTHANDS[name]}")
        if isinstance(default, bool):
            group.add_argument(*flags, action="store_true", default=None)
        elif isinstance(default, (tuple, list)):
            group.add_argument(*flags, nargs="*",
                               type=type(default[0]) if default else float,
                               default=None)
        else:
            group.add_argument(*flags, type=type(default), default=None)


def extract_config(args: Namespace, cls, prefix: str = ""):
    """Build a dataclass from parsed args, keeping defaults for unset flags."""
    kwargs = {}
    for f in fields(cls):
        v = getattr(args, f"{prefix}{f.name}", None)
        if v is not None:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def save_config(model_path: str, *cfgs) -> None:
    """Dump all config groups to model_path/cfg_args.json (reproducibility,
    analog of the reference's cfg_args Namespace dump)."""
    os.makedirs(model_path, exist_ok=True)
    merged = {}
    for cfg in cfgs:
        merged.update(dataclasses.asdict(cfg))
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(merged, f, indent=2, default=list)


def load_saved_config(model_path: str) -> dict:
    path = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def get_combined_config(parser: ArgumentParser, cls_list, argv=None):
    """CLI args override values saved in model_path/cfg_args.json."""
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    saved = load_saved_config(getattr(args, "model_path", "") or "")
    out = []
    for cls in cls_list:
        kwargs = {}
        for f in fields(cls):
            v = getattr(args, f.name, None)
            if v is None and f.name in saved:
                v = saved[f.name]
                if isinstance(v, list):
                    v = tuple(v)
            if v is not None:
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
        out.append(cls(**kwargs))
    return out, args
