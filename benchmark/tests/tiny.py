"""Tiny versions of the cells for the CPU tests: the same code paths at
sizes a test run holds (thousands of splats, 64 px training views, 384 x 256
viewer frames, a two-block FLUX)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

# The cells of BENCHMARK.json whose traffic kinds have a tiny cut below.
CELLS = tuple(w["name"] for w in harness.load_json(BENCH.parent / "BENCHMARK.json")["workloads"]
              if harness.cell_files(w["name"])[3]["kind"]
              in ("train_chunks", "viewer_orbit", "idu_views"))


def cell(name: str) -> tuple:
    """(config, workload) of cell ``name`` cut to a tiny size; the limits
    are the cell's own."""
    _, _, cfg, wl = harness.cell_files(name)
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg["n_splats"] = 6000
    cfg["train_views"].update(count=4, size=64)
    cfg["city"].update(ground_radius=60.0, building_extent=40.0)
    if wl["kind"] == "train_chunks":
        wl.update(chunk=2, trace_iterations=2)
    elif wl["kind"] == "viewer_orbit":
        # Dense enough that TF32's shift of the splats shows in the bytes.
        cfg["n_splats"] = 40000
        wl.update(width=384, height=256, radius=120.0, frames_per_orbit=4, trace_frames=3,
                  sample_from=3, sample_frames=2, warmup_frames=1, work_stride=2)
    elif wl["kind"] == "idu_views":
        cfg["flux"] = dict(in_channels=16, hidden=64, heads=2, head_dim=32, depth_double=2,
                           depth_single=2, joint_dim=32, pooled_dim=16, axes_dim=[8, 12, 12],
                           theta=10000, guidance=True, mlp_ratio=4.0, time_freq_dim=32)
        cfg["vae"] = dict(base_ch=16, ch_mult=[1, 2], num_res=1, latent_ch=4,
                          scaling_factor=0.3611, shift_factor=0.1159, groups=4)
        cfg["vit"] = dict(patch_size=14, width=32, depth=4, heads=2, mlp_ratio=4.0,
                          img_size=28, out_layers=[0, 1, 2, 3], head_width=16)
        cfg["text"]["t5_tokens"] = 8
        cfg["idu"]["render_size"] = 64
        # FLUX and the VAE at 0.02 times the square root of the published
        # width over this one, so their activations and FlowEdit's edit keep
        # the full model's scale; MoGe's LayerNorms keep its scale at 0.02.
        cfg["init_std"] = {"flux": 0.139, "vae": 0.057, "moge": 0.02}
    return cfg, wl


def run(name: str, seed: int = 11, trace: bool = False, seconds: float = 2.0) -> tuple:
    """One tiny run of cell ``name`` on the CPU: (result object, notes)."""
    cfg, wl = cell(name)
    return harness.run_cell(name, seed, seconds, trace, device="cpu", config=cfg, workload=wl)
