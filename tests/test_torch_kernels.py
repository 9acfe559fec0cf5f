"""The compositing kernels themselves (skyfall_gs_tpu_torch/csrc).

The CUDA tests need a card and skip without one; run them on a GPU machine
with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: this file imports neither JAX nor the JAX package, so
it runs where only PyTorch is installed).  The build test runs anywhere.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from skyfall_gs_tpu_torch.ops import rasterize_tiled as rt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'composite.cu(1): error: boom' >&2\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(rt, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom"):
        rt.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both kernels against their plain versions on the card, on a scene
    with a saturated tile and tiles of more than 1k entries."""
    cs = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    m, c, d, r, o, ch, rxy, off = [torch.from_numpy(a).to(dev) for a in
                                   cs.screen_scene(np.random.default_rng(0))]
    table, binned, offx, offy = rt.composite_inputs(
        m, c, d, r, o, ch, 128, 128, subpixel_offset=off, cap=1 << 16, radius_xy=rxy)
    gen = torch.Generator(device=dev).manual_seed(0)
    t = binned.tile_start.shape[0]
    res = cs.kernels_vs_plain(torch, rt, (table, binned, offx, offy, 8),
                              torch.randn((t, rt.NCH, rt.P), device=dev, generator=gen),
                              torch.randn((t, rt.P), device=dev, generator=gen))
    assert res["fwd_max_abs"] <= 1e-4
    assert res["rows_rel_colmax"] <= 1e-4
    assert res["grad_rel_norm"] <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_count_launches_and_check_inputs():
    cs = _cuda()
    dev = torch.device("cuda")
    m, c, d, r, o, ch, rxy, _ = [torch.from_numpy(a).to(dev) for a in
                                 cs.screen_scene(np.random.default_rng(1))]
    table, binned, offx, offy = rt.composite_inputs(m, c, d, r, o, ch, 128, 128,
                                                    cap=1 << 16, radius_xy=rxy)
    args = (binned.gather_idx, binned.tile_start, binned.tile_count, offx, offy, 8)
    before = rt.composite_fwd.launches
    rt.composite_fwd(table, *args)
    assert rt.composite_fwd.launches == before + 1
    with pytest.raises(ValueError, match="table"):
        rt.composite_fwd(table.double(), *args)
    torch.cuda.synchronize()
