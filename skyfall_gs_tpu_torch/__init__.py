"""skyfall_gs_tpu_torch — the PyTorch/CUDA port of skyfall_gs_tpu.

The module tree mirrors ``skyfall_gs_tpu`` file for file: each module here
is the counterpart of the JAX module at the same relative path, and the
tests hold each one against its JAX twin on the same numpy inputs.

This package imports ``torch``, ``numpy`` and ``scipy`` only.  The two
compositing kernels (``ops/rasterize_tiled.py``) are hand-written CUDA C++
for Hopper (``csrc/composite.cu``), built with ``nvcc`` at first use; on
CPU tensors their plain PyTorch versions run instead.

Ported so far: Stage-1 training -- the step (``train/step.py``), the
single-device ``Trainer`` (``train/loop.py``) with appearance modeling,
densify/prune, checkpoints and PLY snapshots -- and everything they run.
"""

__version__ = "0.1.0"
