"""Time the compositing kernels against an earlier tree's, in turns, on one GPU.

    python3 scripts/compare_composite.py --baseline DIR [--reps 50]

DIR is an unpacked earlier checkout of the repository (``git archive
<commit> | tar -x -C DIR``); its kernels are built from its own sources.  On
one view of chip_smoke.py's phase-3 bench scene (512x512, 100k untrained
splats, measured capacity) the baseline's forward must equal this tree's and
its per-gaussian gradient must agree within 1e-4 per column; then each
kernel is timed by CUDA events over ``--reps`` launches in turns (baseline,
this tree, this tree, baseline).  A backward is timed as the training path
runs it: the wrapper with its zero fill, then, where it returns per-entry
rows, ``index_add_`` of them per gaussian.  The ptxas report of each build
is printed beside the times, with the card's name and power limit.  The
kernels against their plain versions are chip_smoke.py's phases 2 and 3.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def load_rasterize_tiled(tree: Path, name: str):
    """``ops/rasterize_tiled.py`` of ``tree`` as module ``name``; it builds
    its kernels from ``tree``'s own ``csrc/`` into ``tree/build``."""
    path = tree / "skyfall_gs_tpu_torch" / "ops" / "rasterize_tiled.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_gaussian_bwd(torch, mod, table, args, rest):
    """The tree's backward as its autograd function runs it."""
    g = mod.composite_bwd(table, *args, *rest)
    if g.shape[0] != table.shape[0]:                  # per-entry rows
        g = torch.zeros_like(table).index_add_(0, args[0], g)
    return g


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_composite: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from skyfall_gs_tpu_torch.model.render import measure_bin_capacity
    from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt
    from skyfall_gs_tpu_torch.ops.binning import num_tiles

    dev = torch.device(cs.DEVICE)
    card = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    trees = {"baseline": load_rasterize_tiled(opts.baseline.resolve(), "baseline_rasterize_tiled"),
             "this": rt}
    for key, mod in trees.items():
        lib = mod.build_library()
        ptx = cs.ptxas_report(lib.with_suffix(".log").read_text())
        print(f"{key}: built {lib.name}; ptxas fwd_kernel {ptx.get('fwd')} | "
              f"bwd_kernel {ptx.get('bwd')}", flush=True)

    state, cams = cs.bench_scene(np.random.default_rng(0), dev, cs.N_GAUSSIANS, cs.IMG)
    cap = measure_bin_capacity(state, cams, kernel_size=0.1)
    table, binned, offx, offy = cs.bench_inputs(torch, rt, state, cams[0], cap)
    tiles_x = num_tiles(cs.IMG, cs.IMG)[1]
    t_total = binned.tile_start.shape[0]
    args = (binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy)
    gen = torch.Generator(device=dev).manual_seed(0)
    dout = torch.randn((t_total, rt.NCH, rt.P), device=dev, generator=gen) * 1e-3
    dtfin = torch.randn((t_total, rt.P), device=dev, generator=gen) * 1e-3
    out, tf = rt.composite_fwd(table, *args, tiles_x)
    rest = (out, tf, dout, dtfin, tiles_x)
    out_b, tf_b = trees["baseline"].composite_fwd(table, *args, tiles_x)
    fwd_equal = bool(torch.equal(out_b, out) and torch.equal(tf_b, tf))
    gb, gt = (per_gaussian_bwd(torch, mod, table, args, rest) for mod in trees.values())
    rel = max(cs.rel_norm(gt[:, k], gb[:, k]) for k in range(gb.shape[1])
              if float(gb[:, k].norm()) > 0)
    print(f"bench view ({int(binned.num_entries)} entries): forward equal to the baseline's "
          f"{fwd_equal}; per-gaussian gradient rel norm per column {rel:.3e}", flush=True)

    times = {}
    for kind in ("fwd", "bwd"):
        for key in ("baseline", "this", "this", "baseline"):
            mod = trees[key]
            if kind == "fwd":
                fn = lambda: mod.composite_fwd(table, *args, tiles_x)          # noqa: E731
            else:
                fn = lambda: per_gaussian_bwd(torch, mod, table, args, rest)    # noqa: E731
            fn()
            times.setdefault(f"{key} {kind}", []).append(cs.cuda_ms(fn, opts.reps, torch))
    bound = cs.kernel_bounds(rt.composite_work(table, *args, tiles_x), table.shape[0], t_total)
    print(f"bench view on [{card}], ms per call over {opts.reps} launches, in turns: " + "; ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in times.items())
        + f"; bounds fwd {bound['fwd']['bound_ms']:.4f} ms, bwd {bound['bwd']['bound_ms']:.4f} ms",
        flush=True)
    ok = fwd_equal and rel <= 1e-4
    print("ok" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
