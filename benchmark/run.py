"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see benchmark/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
# Kernel caches at fixed paths inside the checkout: only a cell's first run
# there builds or compiles.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_BUILD, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(_BUILD, "torch_extensions"))
sys.path.insert(0, _HERE)

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
