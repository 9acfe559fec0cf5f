"""The Stage-1 training step.

Port of ``skyfall_gs_tpu/train/step.py`` (reference hot loop
train.py:142-348): optional ray-jitter subpixel offsets with
offset-resampled GT, masked L1 + SSIM photometric loss (L1 + LPIPS with
``lpips_fn``; dropped with ``photometric=False``, for unrefined IDU views), Pearson depth loss,
opacity binary entropy, the optional pseudo-view monodepth term (a second
render at ``pseudo_camera``, warm-up scaled), screen-space gradient
statistics through the dummy-input trick, and Adam with per-field LRs.

PyTorch runs eagerly, so there is no jit; the step updates the parameters,
Adam moments and densification statistics IN PLACE (one copy of each) and
makes no host sync: the loss, the metrics and ``overflow`` stay tensors on
the state's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from skyfall_gs_tpu_torch.core.camera import Camera
from skyfall_gs_tpu_torch.model.densify import add_densification_stats
from skyfall_gs_tpu_torch.model.gaussians import (
    GaussianModelState,
    GaussianParams,
    flat_fields,
    from_flat,
    get_opacity,
    map_fields,
)
from skyfall_gs_tpu_torch.model.optim import (
    AdamState,
    adam_init,
    adam_update,
    make_lr_tree,
    make_weight_decay_tree,
)
from skyfall_gs_tpu_torch.model.render import render
from skyfall_gs_tpu_torch.ops.losses import (
    depth_pearson_loss,
    l1_loss,
    opacity_entropy_loss,
    photometric_loss,
    psnr,
)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    depth_loss: torch.Tensor
    opacity_loss: torch.Tensor
    psnr: torch.Tensor
    n_alive: torch.Tensor
    # duplicated entries dropped by an undersized binning capacity; nonzero
    # means splats silently vanished from this step's render + gradients
    overflow: torch.Tensor


@dataclass
class TrainState:
    model: GaussianModelState
    opt: AdamState
    step: int = 0


def init_train_state(model: GaussianModelState) -> TrainState:
    return TrainState(model=model, opt=adam_init(model.params))


def resample_with_offset(image: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Bilinear-resample (H, W, C) at pixel positions shifted by ``offset``
    (H, W, 2), border-clamped (reference create_offset_gt)."""
    h, w = image.shape[:2]
    dev = image.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + offset[..., 0]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + offset[..., 1]
    # align_corners=True maps -1/+1 to the first/last pixel centers.
    grid = torch.stack([xs * (2.0 / (w - 1)) - 1.0, ys * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(image.permute(2, 0, 1)[None], grid[None], mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0].permute(1, 2, 0)


def _build_grads_fn(
    opt_cfg,
    kernel_size: float = 0.1,
    backend: str = "tiled",
    ray_jitter: bool = False,
    resample_gt: bool = False,
    use_depth: bool = True,
    use_pseudo: bool = False,
    photometric: bool = True,
    testing_render: bool = False,
    bin_capacity: Optional[int] = None,
    lpips_fn: Optional[Callable] = None,
):
    """Build the per-view loss/gradient core: everything from render
    through the backward, but not the optimizer update or the
    densification statistics (the view-parallel step combines those over
    the mesh in between).

    Signature:
        grads(model, camera, gt_image (H,W,3), gt_mask (H,W), gt_depth (H,W),
              bg (3,), lambda_opacity, generator=None, subpixel_offset=None,
              pseudo_camera=None, pseudo_gt_depth=None, pseudo_scale=None,
              pseudo_bin_capacity=None)
            -> (loss, aux dict, grads GaussianParams,
                (d mean2d (C,2), AbsGS d mean2d (C,2)))

    With ``ray_jitter`` the per-pixel subpixel offsets are drawn uniform in
    [-0.5, 0.5) from ``generator`` unless ``subpixel_offset`` gives them.
    ``testing_render`` renders with the fixed test-time appearance
    embedding instead of the camera's own.  ``photometric=False`` drops the
    photometric term; with ``lpips_fn`` (``eval.lpips.LPIPS.score``: two
    (B, H, W, 3) images in [-1, 1] -> (B,)) it is (1 - l) L1 + l LPIPS
    instead of (1 - l) L1 + l (1 - SSIM), l = ``lambda_dssim``
    (reference train.py:218-220).  ``use_pseudo`` adds ``pseudo_scale *
    lambda_pseudo_depth`` times the Pearson loss of a render at
    ``pseudo_camera`` against ``pseudo_gt_depth`` (a NaN loss counts 0),
    binned at ``pseudo_bin_capacity``; its overflow adds to the metric's.
    The gradients cover every present parameter leaf, the appearance MLP
    and embeddings included.
    """

    def grads_fn(model: GaussianModelState, camera: Camera, gt_image, gt_mask,
                 gt_depth, bg, lambda_opacity: float,
                 generator: Optional[torch.Generator] = None,
                 subpixel_offset: Optional[torch.Tensor] = None,
                 pseudo_camera: Optional[Camera] = None,
                 pseudo_gt_depth: Optional[torch.Tensor] = None,
                 pseudo_scale: float = 1.0,
                 pseudo_bin_capacity: Optional[int] = None):
        dev = model.params.xyz.device
        h, w = camera.height, camera.width
        subpix = None
        if ray_jitter:
            subpix = subpixel_offset
            if subpix is None:
                subpix = torch.rand((h, w, 2), generator=generator, device=dev) - 0.5

        # Leaves that share the parameters' storage: autograd reads them,
        # and the optimizer later writes the same storage in place.
        leaves = map_fields(lambda t: t.detach().requires_grad_(True), model.params)
        cap = model.params.capacity
        dummy = torch.zeros((cap, 2), device=dev, requires_grad=True)
        abs_dummy = torch.zeros((cap, 2), device=dev, requires_grad=True)

        m = dataclasses.replace(model, params=leaves)
        out = render(m, camera, bg, kernel_size=kernel_size, subpixel_offset=subpix,
                     mean2d_dummy=dummy, mean2d_abs_dummy=abs_dummy,
                     backend=backend, testing=testing_render,
                     bin_capacity=bin_capacity,
                     # the normal channel is not part of any training loss
                     with_normals=False)
        image = out.color * gt_mask[..., None]
        gt = gt_image * gt_mask[..., None]
        if resample_gt and subpix is not None:
            gt = resample_with_offset(gt, subpix)

        if photometric and lpips_fn is not None:
            ll1 = l1_loss(image, gt)
            lp = lpips_fn(image[None] * 2.0 - 1.0, gt[None] * 2.0 - 1.0)[0]
            total = (1.0 - opt_cfg.lambda_dssim) * ll1 + opt_cfg.lambda_dssim * lp
        elif photometric:
            total, ll1 = photometric_loss(image.permute(2, 0, 1), gt.permute(2, 0, 1),
                                          opt_cfg.lambda_dssim)
        else:
            total = ll1 = torch.zeros((), device=dev)
        d_loss = torch.zeros((), device=dev)
        if use_depth and opt_cfg.lambda_depth > 0:
            d_loss = depth_pearson_loss(gt_depth * gt_mask, out.depth * gt_mask)
            total = total + opt_cfg.lambda_depth * d_loss
        o_loss = opacity_entropy_loss(get_opacity(leaves), model.aux.alive)
        total = total + lambda_opacity * o_loss
        overflow = out.overflow
        if use_pseudo:
            pout = render(m, pseudo_camera, bg, kernel_size=kernel_size, backend=backend,
                          bin_capacity=pseudo_bin_capacity, with_normals=False)
            pd = depth_pearson_loss(pseudo_gt_depth, pout.depth)
            pd = torch.where(torch.isnan(pd), torch.zeros_like(pd), pd)
            total = total + pseudo_scale * opt_cfg.lambda_pseudo_depth * pd
            d_loss = d_loss + pd
            if pout.overflow is not None:
                overflow = overflow + pout.overflow

        paths, tensors = zip(*flat_fields(leaves))
        inputs = [*tensors, dummy, abs_dummy]
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            inputs, torch.autograd.grad(total, inputs, allow_unused=True))]
        aux = {
            "l1": ll1.detach(),
            "depth_loss": d_loss.detach(),
            "opacity_loss": o_loss.detach(),
            "radii": out.radii,
            "psnr": psnr(image.detach(), gt.detach()),
            "overflow": overflow,
        }
        return (total.detach(), aux, from_flat(GaussianParams, zip(paths, grads[:-2])),
                (grads[-2], grads[-1]))

    return grads_fn


def apply_update(state: TrainState, grads: GaussianParams, opt_cfg, xyz_lr: float) -> None:
    """The optimizer half of a step, IN PLACE: Adam with per-field LRs (the
    scheduled ``xyz_lr``) and the appearance embeddings' weight decay, then
    the step count.  The single-device step runs it right after its own
    gradients; the view-parallel step (``parallel/sharding.py``) after the
    gradients are averaged over the mesh."""
    params = state.model.params
    adam_update(grads, state.opt, params, make_lr_tree(params, opt_cfg, xyz_lr),
                weight_decay_tree=make_weight_decay_tree(params, opt_cfg))
    state.step += 1


def make_train_step(opt_cfg, **kwargs):
    """Build the single training step (``kwargs`` as for
    :func:`_build_grads_fn`).

    Signature:
        step(state, camera, gt_image (H,W,3), gt_mask (H,W), gt_depth (H,W),
             bg (3,), xyz_lr, lambda_opacity, generator=None,
             subpixel_offset=None, **pseudo) -> (state, StepMetrics)

    ``pseudo`` holds the grads function's ``pseudo_*`` arguments when built
    with ``use_pseudo``.  ``state`` is updated in place and returned.
    """
    grads_fn = _build_grads_fn(opt_cfg, **kwargs)

    def step(state: TrainState, camera: Camera, gt_image, gt_mask, gt_depth, bg,
             xyz_lr: float, lambda_opacity: float,
             generator: Optional[torch.Generator] = None,
             subpixel_offset: Optional[torch.Tensor] = None, **pseudo):
        model = state.model
        loss, aux, grads, (g_mean2d, g_abs) = grads_fn(
            model, camera, gt_image, gt_mask, gt_depth, bg, lambda_opacity,
            generator, subpixel_offset, **pseudo)
        add_densification_stats(model.aux, g_mean2d, g_abs, aux["radii"],
                                camera.width, camera.height)
        apply_update(state, grads, opt_cfg, xyz_lr)
        metrics = StepMetrics(
            loss=loss,
            l1=aux["l1"],
            depth_loss=aux["depth_loss"],
            opacity_loss=aux["opacity_loss"],
            psnr=aux["psnr"],
            n_alive=torch.sum(model.aux.alive),
            overflow=aux["overflow"],
        )
        return state, metrics

    return step


def make_eval_render(kernel_size: float = 0.1, backend: str = "tiled",
                     bin_capacity: Optional[int] = None):
    """No-grad render for test-time evaluation (the forward kernel only),
    with the fixed test-time appearance embedding.

    ``bin_capacity`` should come from render.measure_bin_capacity for the
    target resolution.
    """

    @torch.no_grad()
    def fn(model: GaussianModelState, camera: Camera, bg):
        return render(model, camera, bg, kernel_size=kernel_size, testing=True,
                      backend=backend, bin_capacity=bin_capacity,
                      inference=(backend == "tiled"))

    return fn
