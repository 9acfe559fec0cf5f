"""From a ``csrc/<name>.cu`` file to a launched kernel.

Every CUDA source of the port is its own library with a plain C interface:
``build_library`` compiles it with nvcc into ``<repo>/build/`` (once per
hash of the source and the flags) and ``Library`` loads it with ctypes and
launches its entry points.  A kernel module declares its library once, at
module level, with the signatures of the entry points it owns, and calls
``Library.launch``; nothing is built until the first launch.

Every entry point returns a ``cudaError_t`` as an int and takes the stream
it launches on as its last argument.  ``launches`` counts the calls of each
entry point by its C name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

# Built libraries go to <repo>/build/.
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# The C types of the entry points' arguments.
ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

launches: Counter[str] = Counter()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    if "CUDA_HOME" in os.environ:
        return str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(source: Path) -> Path:
    """Where ``source`` is built: ``libskyfall_<stem>_<hash>.so`` in
    ``BUILD_DIR``, the hash over the source's bytes and the nvcc flags."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libskyfall_{source.stem}_{digest.hexdigest()[:16]}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` with nvcc into its library (unless it is built
    already) and return the library's path.  Raises with nvcc's stderr if
    the build fails.  ptxas's register/shared-memory report is kept beside
    the library as ``.log``."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


class Library:
    """One CUDA source and the signatures of its entry points (their
    arguments before the stream), built and loaded at its first ``load``."""

    def __init__(self, source: Path, **signatures: list):
        self.source = source
        self.signatures = signatures
        self._cdll = None

    def load(self) -> ctypes.CDLL:
        """The library, built and loaded once, its entry points declared."""
        if self._cdll is None:
            lib = ctypes.CDLL(str(build_library(self.source)))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = [*argtypes, ptr]
                fn.restype = i32
            self._cdll = lib
        return self._cdll

    def launch(self, entry: str, *args) -> None:
        """Calls entry point ``entry`` on the current stream of the device of
        its first tensor argument, with that device current; tensors are
        passed as their data pointers.  Counts the call in ``launches`` and
        raises ``RuntimeError`` on a nonzero return."""
        device = next(a.device for a in args if isinstance(a, torch.Tensor))
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            rc = getattr(self.load(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
        launches[entry] += 1
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
