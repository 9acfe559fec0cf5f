"""FLUX's fused attention (``ops/attention.py``, ``csrc/attention.cu``).

On the CPU: a plain transcription of the kernel's algorithm (128-key tiles,
a running float32 max and sum, bf16-rounded unnormalised weights, one
division at the end) held against float64 beside the plain version
``attention`` of the same module; the wrapper on CPU tensors; the routing
rule of FLUX's blocks; the span and counter they record.

The CUDA tests need a card and skip without one; run them on a GPU machine
with

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py

(this file imports neither JAX nor the JAX package).
"""

import math
import os
import sys

import pytest
import torch

from skyfall_gs_tpu_torch.ops import attention as fa
from skyfall_gs_tpu_torch.ops.cuda_lib import launches
from skyfall_gs_tpu_torch.priors import flux as tf
from skyfall_gs_tpu_torch.priors import moge as tm
from skyfall_gs_tpu_torch.utils import trace

torch.set_num_threads(1)
HD = 128
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (the inputs and the float64 reference of phase 14)


def tiled_attention(q, k, v, block: int = 128):
    """The kernel's algorithm in plain PyTorch: (B, H, L, hd) -> (B, L, H * hd)."""
    b, h, n, hd = q.shape
    c = math.log2(math.e) / math.sqrt(hd)
    qf = q.float()
    m = torch.full((b, h, n, 1), -math.inf)
    l = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, hd))
    for j in range(0, n, block):
        s = qf @ k[:, :, j:j + block].float().transpose(-1, -2)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - mx * c)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(torch.bfloat16).float() @ v[:, :, j:j + block].float()
        m = mx
    return (o / l).to(q.dtype).transpose(1, 2).reshape(b, n, h * hd)


# ----------------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 128, 300, 640])
def test_tiled_algorithm_against_float64_beside_the_plain_version(n):
    q, k, v = cs.attention_inputs(torch, 1, 2, n, seed=n)
    s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(HD)
    if n >= 128:
        assert float(s.abs().max()) > 15.0          # FLUX-like logits reach far out
    want = cs.attention_float64(torch, q, k, v)
    plain_max, plain_mean = cs.abs_errors(fa.attention(q, k, v), want)
    tiled_max, tiled_mean = cs.abs_errors(tiled_attention(q, k, v), want)
    assert tiled_max <= 1.5 * plain_max + 1e-6, (tiled_max, plain_max)
    assert tiled_mean <= 1.5 * plain_mean + 1e-6, (tiled_mean, plain_mean)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = cs.attention_inputs(torch, 2, 3, 70, seed=1)
    before = launches["skyfall_flash_attention"]
    assert torch.equal(fa.fused_attention(q, k, v), fa.attention(q, k, v))
    q32, k32, v32 = (x.float() for x in (q, k, v))
    assert torch.equal(fa.fused_attention(q32, k32, v32), fa.attention(q32, k32, v32))
    assert launches["skyfall_flash_attention"] == before


def _tiny_flux_call(dtype):
    cfg = tf.FluxConfig.tiny()
    model = tf.build_module(tf.FluxTransformer, cfg, dtype=dtype, device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    tok, ids = tf.pack_latents(torch.randn((1, 8, 8, cfg.in_channels // 4), generator=g))
    cond = tf.FluxCond(torch.randn((1, 5, cfg.joint_dim), generator=g),
                       torch.randn((1, cfg.pooled_dim), generator=g))
    return cfg, lambda: tf.flux_velocity(model, tok, ids, cond, torch.tensor([0.6]))


def test_routing_bf16_blocks_take_the_wrapper_float32_and_moge_do_not(monkeypatch):
    calls, fused = [], fa.fused_attention

    def counting(q, k, v):
        calls.append(q.dtype)
        return fused(q, k, v)

    monkeypatch.setattr(fa, "fused_attention", counting)
    cfg, run16 = _tiny_flux_call(torch.bfloat16)
    assert bool(torch.isfinite(run16()).all())
    assert calls == [torch.bfloat16] * (cfg.depth_double + cfg.depth_single)
    calls.clear()
    _, run32 = _tiny_flux_call(torch.float32)
    run32()
    assert calls == []
    assert tm.attention is fa.attention                 # MoGe binds the plain version
    mcfg = tm.ViTConfig(patch_size=14, width=32, depth=2, heads=2, img_size=28,
                        out_layers=(0, 1), head_width=16)
    moge = tf.build_module(tm.MoGe, mcfg, device="cpu", seed=0)
    with torch.no_grad():
        moge(torch.rand((1, 28, 28, 3), generator=torch.Generator().manual_seed(1)))
    assert calls == []


def test_profiled_forward_records_the_attention_span_and_counter():
    cfg, run16 = _tiny_flux_call(torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run16()
    rep = trace.report()
    assert rep["spans"]["flux.attention"]["count"] == cfg.depth_double + cfg.depth_single
    assert rep["counters"].get("flux.attention.kernel", 0) == 0


# ----------------------------------------------------------------------------
# The card
# ----------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,v_view", [(2, 24, 4608, False), (2, 3, 1, True),
                                          (2, 3, 300, False), (1, 4, 4097, True)])
def test_kernel_against_float64_beside_the_plain_version_on_the_card(b, h, n, v_view):
    """At the view-generation shape and at ragged lengths; ``v_view``: v as
    the single block's transposed view of a (B, L, H * 128) projection."""
    dev = _card()
    q, k, v = cs.attention_inputs(torch, b, h, n, seed=n, device=dev)
    if v_view:
        v = v.transpose(1, 2).reshape(b, n, h * HD).reshape(b, n, h, HD).transpose(1, 2)
        assert n == 1 or not v.is_contiguous()     # a size-1 L counts as contiguous
    want = cs.attention_float64(torch, q, k, v)
    before = launches["skyfall_flash_attention"]
    got = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert launches["skyfall_flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, h * HD)
    plain_max, plain_mean = cs.abs_errors(fa.attention(q, k, v), want)
    got_max, got_mean = cs.abs_errors(got, want)
    assert got_max <= 1.5 * plain_max, (got_max, plain_max)
    assert got_mean <= 1.5 * plain_mean, (got_mean, plain_mean)


@pytest.mark.cuda
def test_kernel_wrapper_counts_launches_and_checks_inputs_on_the_card():
    dev = _card()
    q, k, v = cs.attention_inputs(torch, 1, 2, 256, seed=3, device=dev)
    before = launches["skyfall_flash_attention"]
    fa.fused_attention(q, k, v)
    fa.fused_attention(q, k, v)
    assert launches["skyfall_flash_attention"] == before + 2
    with pytest.raises(ValueError, match="bf16"):
        fa.fused_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="bf16"):
        fa.fused_attention(q[..., :64], k[..., :64], v[..., :64])
    strided = torch.empty((1, 2, HD, 256), dtype=torch.bfloat16, device=dev).transpose(-1, -2)
    strided.copy_(k)
    with pytest.raises(ValueError, match="unit stride"):
        fa.fused_attention(q, strided, v)
    assert launches["skyfall_flash_attention"] == before + 2
    torch.cuda.synchronize()
