"""FlowEdit: inversion-free flow-matching image editing.

Port of ``skyfall_gs_tpu/priors/flowedit.py`` (FlowEdit, Kulikov et al.
2024, the reference's ``FlowEditRefineIDU`` with knobs n_min / n_max /
n_max_end / n_avg):
  * :func:`flow_edit_ode` — the FlowEdit sampling loop on one latent;
  * :func:`flow_edit_ode_batch` — one loop over a stacked batch with the
    per-image editing window (the n_max -> n_max_end annealing across the
    orbit set) applied as a mask, which is data and not a shape;
  * :class:`FlowEditRefiner` — the IDU-facing backend: encode frames to
    latents, run the batched ODE with source / target conditioning, decode.
    ``priors/flux_refiner.py`` builds it on FLUX; any (encode, decode,
    velocity) triple can be injected.

FlowEdit recurrence (paper Alg. 1, rectified-flow form):
    t_k:            decreasing timesteps indexed n_max -> n_min
    z_src_t  = (1 - t) x_src + t eps              (eps ~ N(0, I), n_avg draws)
    z_tar_t  = z_src_t + (z_edit - x_src)
    dv       = v(z_tar_t, t, c_tar) - v(z_src_t, t, c_src)   (averaged)
    z_edit  <- z_edit + (t_{k+1} - t_k) * dv

z_tar_t adds the edit made so far to z_src_t (the JAX package writes
z_edit + (z_src_t - x_src), equal in exact arithmetic): until z_edit moves,
both branches see bit-identical inputs, so equal conditions leave the
latent exactly where it was, where the other order's one-ulp differences
are amplified by a deep bf16 model.

The noise comes from a ``torch.Generator``: a different stream from the
JAX package's ``PRNGKey`` splits, so the two packages agree exactly only
where the noise cancels (an affine velocity field, as the tests use).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from skyfall_gs_tpu_torch.utils.trace import span

# One span per ODE step: the two velocity evaluations of each noise draw.
_STEP = span("flowedit.step")


def _timesteps(num_steps: int, sigmas, device) -> torch.Tensor:
    if sigmas is None:
        return torch.linspace(1.0, 0.0, num_steps + 1, device=device)
    return torch.as_tensor(sigmas, dtype=torch.float32, device=device)


def _delta_v(velocity_fn, x_src, z_edit, t, src_cond, tar_cond, generator, n_avg):
    """The mean over ``n_avg`` noise draws of v(z_tar_t) - v(z_src_t)."""
    dv = torch.zeros_like(x_src)
    for _ in range(n_avg):
        eps = torch.randn(x_src.shape, generator=generator, device=x_src.device,
                          dtype=x_src.dtype)
        z_src_t = (1.0 - t) * x_src + t * eps
        z_tar_t = z_src_t + (z_edit - x_src)
        dv = dv + (velocity_fn(z_tar_t, t, tar_cond) - velocity_fn(z_src_t, t, src_cond))
    return dv / n_avg


@torch.no_grad()
def flow_edit_ode(
    velocity_fn: Callable,
    x_src: torch.Tensor,
    src_cond,
    tar_cond,
    generator: torch.Generator,
    num_steps: int = 28,
    n_min: int = 0,
    n_max: int = 15,
    n_avg: int = 1,
    sigmas=None,
) -> torch.Tensor:
    """Run the FlowEdit ODE on one latent.

    Args:
        velocity_fn: v(z, t (0-d tensor), cond) -> velocity.
        x_src: source latent (any shape).
        src_cond / tar_cond: conditioning of the two prompts.
        generator: the noise stream (on ``x_src``'s device).
        num_steps: the timestep grid size (t_k = 1 - k / num_steps).
        n_min / n_max: the editing window, timesteps indexed
            [num_steps - n_max, num_steps - n_min).
        n_avg: noise draws averaged per step.
        sigmas: optional (num_steps + 1,) decreasing sigma grid replacing
            the uniform one (e.g. FLUX's shifted schedule).
    """
    ts = _timesteps(num_steps, sigmas, x_src.device)
    z = x_src.clone()
    for k in range(num_steps - n_max, num_steps - n_min):
        with _STEP:
            t, t_next = ts[k], ts[k + 1]
            z = z + (t_next - t) * _delta_v(velocity_fn, x_src, z, t, src_cond, tar_cond,
                                            generator, n_avg)
    return z


@torch.no_grad()
def flow_edit_ode_batch(
    velocity_fn: Callable,
    x_src: torch.Tensor,
    src_cond,
    tar_cond,
    generator: torch.Generator,
    n_max_per_image,
    num_steps: int = 28,
    n_min: int = 0,
    n_max: int = 15,
    n_avg: int = 1,
    sigmas=None,
) -> torch.Tensor:
    """Batched FlowEdit with per-image editing windows.

    The loop runs the widest window, ``n_max - n_min`` steps.  Image i
    advances only on steps with ``k >= num_steps - n_max_per_image[i]``;
    until then its z_edit stays x_src, the state a shorter-window run starts
    from, so the mask is exact.

    Args:
        x_src: (B, ...) stacked source latents.
        velocity_fn: batched field v(z (B, ...), t, cond) -> (B, ...).
        n_max_per_image: (B,) per-image window sizes <= n_max.
    """
    ts = _timesteps(num_steps, sigmas, x_src.device)
    nmax = torch.as_tensor(n_max_per_image, device=x_src.device).reshape(
        (-1,) + (1,) * (x_src.ndim - 1))
    z = x_src.clone()
    for k in range(num_steps - n_max, num_steps - n_min):
        with _STEP:
            t, t_next = ts[k], ts[k + 1]
            active = (k >= num_steps - nmax).to(x_src.dtype)
            dv = _delta_v(velocity_fn, x_src, z, t, src_cond, tar_cond, generator, n_avg)
            z = z + active * (t_next - t) * dv
    return z


class FlowEditRefiner:
    """IDU refine backend running FlowEdit over a flow-matching backbone.

    ``run(images, n_min, n_max, n_max_end, n_avg)`` -> refined images, as
    the reference's FlowEditRefineIDU.  ``n_max_end >= 0`` anneals the
    per-image n_max linearly from ``n_max`` to ``n_max_end`` across the
    set.  Frames are grouped by shape and run in batches of at most
    ``batch_size``; a short tail batch runs as it is (eager PyTorch has no
    compiled signature to keep, so nothing is padded).

    ``shape_fns(height, width) -> (encode, decode, velocity)`` gives each
    image shape its own functions (its own RoPE id grid); ``sigmas_fn(
    height, width)`` its own sigma grid (else the uniform one).  Frames go
    to ``device`` (the card unless the caller asks for the CPU) before
    ``encode``.  Without ``velocity_fn`` or ``shape_fns`` construction
    raises ``RuntimeError``.
    """

    def __init__(
        self,
        save_path: Optional[str] = None,
        model_type: str = "FLUX",
        encode_fn: Optional[Callable] = None,
        decode_fn: Optional[Callable] = None,
        velocity_fn: Optional[Callable] = None,
        src_cond=None,
        tar_cond=None,
        num_steps: int = 28,
        seed: int = 0,
        batch_size: int = 8,
        shape_fns: Optional[Callable] = None,
        sigmas_fn: Optional[Callable] = None,
        device="cuda",
    ):
        if velocity_fn is None and shape_fns is None:
            raise RuntimeError(
                f"No {model_type} flow-matching weights were given and no velocity_fn "
                "was injected. Build the refiner with skyfall_gs_tpu_torch.priors."
                "flux_refiner.build_flux_refiner(checkpoint_path=<local diffusers "
                "FLUX directory>) or pass transformer=/vae= modules, or use the "
                "'identity' refiner.")
        self.save_path = save_path
        self.num_steps = num_steps
        self.batch_size = batch_size
        self.sigmas_fn = sigmas_fn
        self.seed = seed
        self.device = torch.device(device)
        self.encode = encode_fn if encode_fn is not None else (lambda x: x)
        self.decode = decode_fn if decode_fn is not None else (lambda z: z)
        self.velocity_fn = velocity_fn
        self.shape_fns = shape_fns
        self.src_cond = src_cond
        self.tar_cond = tar_cond
        self._generators: Dict[torch.device, torch.Generator] = {}
        # The tensor-parallel mesh of a sharded velocity field
        # (``build_flux_refiner(mesh=...)``): every rank of it calls ``run``.
        self.mesh = None

    def generator(self, device) -> torch.Generator:
        """The refiner's noise stream on ``device`` (seeded once)."""
        device = torch.device(device)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device).manual_seed(self.seed)
        return self._generators[device]

    @torch.no_grad()
    def run(self, images: Sequence[np.ndarray], n_min: int = 0, n_max: int = 15,
            n_max_end: int = -1, n_avg: int = 1, **_) -> List[np.ndarray]:
        n = len(images)
        if n == 0:
            return []
        if n_max_end >= 0 and n > 1:
            nms = [int(round(n_max + (n_max_end - n_max) * i / (n - 1))) for i in range(n)]
        else:
            nms = [n_max] * n
        # The loop must cover the widest per-image window (n_max_end > n_max
        # anneals wider); narrower images are masked inactive before theirs.
        window = max(max(nms), n_max)
        if window > self.num_steps:
            raise ValueError(f"editing window {window} (n_max={n_max}, n_max_end="
                             f"{n_max_end}) exceeds num_steps={self.num_steps}")

        groups: Dict[tuple, List[int]] = {}
        for idx, im in enumerate(images):
            groups.setdefault(np.asarray(im).shape, []).append(idx)
        out: List[Optional[np.ndarray]] = [None] * n
        for shape, idxs in groups.items():
            hh, ww = shape[:2]
            if self.shape_fns is not None:
                enc, dec, vel = self.shape_fns(hh, ww)
            else:
                enc, dec, vel = self.encode, self.decode, self.velocity_fn
            sig = self.sigmas_fn(hh, ww) if self.sigmas_fn is not None else None
            for i in range(0, len(idxs), self.batch_size):
                sel = idxs[i:i + self.batch_size]
                x = torch.stack([torch.as_tensor(np.asarray(images[j], np.float32))
                                 for j in sel]).to(self.device)
                with span("flowedit.encode"):
                    z = enc(x)
                z2 = flow_edit_ode_batch(vel, z, self.src_cond, self.tar_cond,
                                         self.generator(z.device), [nms[j] for j in sel],
                                         num_steps=self.num_steps, n_min=n_min,
                                         n_max=window, n_avg=n_avg, sigmas=sig)
                with span("flowedit.decode"):
                    x_out = dec(z2)
                for j, im_out in zip(sel, x_out.float().cpu().numpy()):
                    out[j] = im_out
        return out
