"""Operation and byte counts of the timed work, and the chip's peaks.

The compositing bound is a frozen copy, at commit a752ef2, of
``chip_smoke.py`` ``kernel_bounds`` and its per-pair constants, with one
change: the per-pair arithmetic is charged to the pairs that pass (power <= 0
and alpha >= 1/255, before the pixel stops), which is the least work any
compositing kernel must do for these inputs, where ``chip_smoke.py`` charged
it to the pairs the present kernels' strip cull keeps.  The pairs and the
walked entries come from the reference's own binning (``ref_splat.composite``),
never from the program's tables.  The step and frame counts are the
benchmark's own, from the shapes: each is the least arithmetic of the step's
parts, so a share of the peak built on them cannot pass 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense bf16,
# HBM3 bandwidth.
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

FLOPS_PER_PAIR = 11          # dx, dy, power, the alpha test
FWD_FLOPS_PER_PASSING = 18   # exp, alpha, T and the blend
BWD_FLOPS_PER_PASSING = 72   # forward again, dot product, dpower, 15 terms and sums

# Per splat: EWA projection (rotation from the quaternion, the covariance and
# its view transform, the Jacobian, dilation, conic, extents) and the 3D
# filter's activation.
PROJECT_FLOPS = 300
# Degree-3 SH: 16 basis terms and 48 multiply-adds.
SH3_FLOPS = 140


def composite_bounds(work: dict, n_rows: int, tiles: int) -> dict:
    """Least seconds of each compositing kernel for one view: the larger of its
    arithmetic over the fp32 peak and its bytes (each input read once, each
    output written once) over HBM.  ``work`` holds ``passing`` pairs and
    ``walked`` entries; ``n_rows`` is the splat table's rows."""
    pix = tiles * 256 * 4
    common = n_rows * 64 + work["walked"] * 8 + tiles * 8 + 2 * pix
    need = {"fwd": ((FLOPS_PER_PAIR + FWD_FLOPS_PER_PASSING) * work["passing"],
                    common + 8 * pix),
            "bwd": ((FLOPS_PER_PAIR + BWD_FLOPS_PER_PASSING) * work["passing"],
                    common + 16 * pix + n_rows * 64)}
    return {k: {"ops": ops, "bytes": b, "s": max(ops / FP32_FLOPS, b / HBM_BYTES_PER_S)}
            for k, (ops, b) in need.items()}


def appearance_flops(n_in: int, hidden: int) -> int:
    """One splat through the appearance MLP (n_in -> hidden -> hidden -> 6)."""
    return 2 * (n_in * hidden + hidden * hidden + hidden * 6)


def ssim_flops(height: int, width: int, channels: int = 3) -> int:
    """Forward SSIM: five separable 11-tap blurs and about 20 operations per
    pixel to combine them."""
    return channels * height * width * (5 * 2 * 11 * 2 + 20)


def frame_flops(n_splats: int, app_flops: int, passing: int, pixels: int) -> int:
    """One inference frame: projection, colours, the forward blend, and the
    clamp and quantisation of each pixel's three channels."""
    return (n_splats * (PROJECT_FLOPS + SH3_FLOPS + app_flops)
            + (FLOPS_PER_PAIR + FWD_FLOPS_PER_PASSING) * passing + 6 * pixels)


def step_flops(n_splats: int, n_params: int, app_flops: int, passing: int,
               height: int, width: int) -> int:
    """One training step: the forward (projection, colours, blend, losses),
    its backward at twice the forward's arithmetic except for the blend's own
    count, and Adam at 10 operations per parameter."""
    per_splat = PROJECT_FLOPS + SH3_FLOPS + app_flops
    losses = ssim_flops(height, width) + 10 * height * width
    fwd = n_splats * per_splat + losses
    blend = (2 * FLOPS_PER_PAIR + FWD_FLOPS_PER_PASSING + BWD_FLOPS_PER_PASSING) * passing
    return 3 * fwd + blend + 10 * n_params


def flux_flops(cfg, n_img: int, n_txt: int) -> int:
    """One FLUX velocity evaluation of one image: the linear layers (2 per
    weight per token of the stream the weight acts on) and the attention
    products (QK^T and PV: 4 L^2 hidden per block).  A frozen copy of
    ``skyfall_gs_tpu_torch/priors/flux.py`` ``flux_flops`` at commit a752ef2
    (which counts the modulation weights once per image, not per token, and
    so leaves them out), summed."""
    d, mlp = cfg.hidden, int(cfg.hidden * cfg.mlp_ratio)
    length = n_img + n_txt
    per_double = 2 * (4 * d * d + 2 * d * mlp)
    per_single = 2 * (3 * d * d + d * mlp + (d + mlp) * d)
    gemm = (cfg.depth_double * per_double * length + cfg.depth_single * per_single * length
            + 2 * cfg.in_channels * d * n_img + 2 * cfg.joint_dim * d * n_txt
            + 2 * d * cfg.in_channels * n_img)
    return gemm + (cfg.depth_double + cfg.depth_single) * 4 * length * length * d


def module_flops(fn, *shapes) -> int:
    """Matrix-product and convolution operations of ``fn`` on meta tensors
    of ``shapes`` (``torch.utils.flop_counter``'s per-operator formulas from
    the shapes; elementwise work is not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        fn(*(torch.empty(s) for s in shapes))
    return int(fc.get_total_flops())
