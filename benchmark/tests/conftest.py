"""Puts the benchmark's directory on the import path of its tests."""

import sys
from pathlib import Path

BENCH = str(Path(__file__).resolve().parents[1])
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
