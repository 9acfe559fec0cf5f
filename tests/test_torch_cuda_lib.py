"""``ops/cuda_lib.py``: where each CUDA source is built, and the launch.

These run on the CPU and need no nvcc: the library paths are computed from
the sources, and the launch calls a fake entry point in place of the
loaded one.
"""

import hashlib
import types
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch

from skyfall_gs_tpu_torch.ops import attention, cuda_lib, projection, rasterize_tiled

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("module,name", [(rasterize_tiled, "composite"),
                                         (attention, "attention"),
                                         (projection, "projection")])
def test_library_path_is_the_sources_hash(module, name):
    """The file a kernel library is built into: ``libskyfall_<name>_<the
    first 16 hex digits of sha256(source bytes + the nvcc flags joined by
    spaces)>.so`` in ``<repo>/build``.  A library already built for the same
    source is found again, so no build is repeated."""
    source = REPO / "skyfall_gs_tpu_torch" / "csrc" / f"{name}.cu"
    flags = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()
    assert module.LIBRARY.source.resolve() == source
    assert cuda_lib.library_path(module.LIBRARY.source) == \
        REPO / "build" / f"libskyfall_{name}_{digest[:16]}.so"


@pytest.fixture
def fake_library(monkeypatch):
    """A library whose entry point ``skyfall_fake`` returns what the test
    sets, recording its arguments; the device and stream are stubbed."""
    calls, rc = [], {"value": 0}

    def entry(*args):
        calls.append(args)
        return rc["value"]

    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=1234))
    lib = cuda_lib.Library(Path("fake.cu"), skyfall_fake=[cuda_lib.ptr, cuda_lib.i32])
    lib._cdll = types.SimpleNamespace(skyfall_fake=entry)
    return lib, calls, rc


def test_launch_passes_pointers_and_the_stream_and_counts_once(fake_library):
    lib, calls, _ = fake_library
    x = torch.zeros(4)
    before = cuda_lib.launches["skyfall_fake"]
    lib.launch("skyfall_fake", x, 7)
    assert calls == [(x.data_ptr(), 7, 1234)]
    assert cuda_lib.launches["skyfall_fake"] == before + 1


def test_launch_raises_on_a_nonzero_return_naming_the_entry_point(fake_library):
    lib, calls, rc = fake_library
    rc["value"] = 700
    with pytest.raises(RuntimeError, match="skyfall_fake launch failed: cudaError 700"):
        lib.launch("skyfall_fake", torch.zeros(2), 3)
    assert len(calls) == 1
