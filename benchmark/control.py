"""The control of a cell's ``correct``: the reference computed at the next
lower precision (TF32 for the float32 splatting cells, float8 linears for
the bf16 FLUX) in the program's place, on the numbers a run compares.  A
control that reads under a cell's limits means the comparison cannot tell
that precision from the program's.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line per seed: each number with its limit.  It runs the
reference only, on the card (``--device cpu`` for a CPU rehearsal).
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def control_checks(cell: str, seed: int, device: str, config=None, workload=None,
                   fault: str = "") -> dict:
    _, _, cfg, wl = harness.cell_files(cell)
    cfg, wl = config or cfg, workload or wl
    driver = importlib.import_module(f"drivers.{wl['kind']}")
    with tempfile.TemporaryDirectory(prefix="bench_") as scratch:
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                              config=cfg, workload=wl, t0=time.perf_counter(), scratch=scratch)
        checks, notes = driver.control(ctx, fault) if fault else driver.control(ctx)
    limits = wl.get("limits", {})
    return {"seed": seed, "checks": {k: {"value": v, "limit": limits.get(k)}
                                     for k, v in checks.items()}, "notes": notes}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="",
                   help="a fault planted in the reference put in the program's place "
                        "instead of the lower precision (s1_train: half_view)")
    a = p.parse_args()
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 2
    for s in a.seeds:
        print(json.dumps(control_checks(a.workload, s, a.device, fault=a.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
