"""Photometric / perceptual evaluation suite.

Port of ``skyfall_gs_tpu/eval/photometric.py``: PSNR and SSIM are the
port's ``ops/losses.psnr`` and ``ops/ssim.ssim`` on ``device``, the MMD is
``eval/cmmd.mmd``; frames, patches, the Frechet distance and the CSVs are
the JAX package's numpy / OpenCV / scipy code.

Capability parity: reference eval.py —
  * frame extraction from rendered MP4s at a uniform sample count
    (:137-205, 30 frames JAX / 24 NYC);
  * per-frame PSNR / SSIM / LPIPS (IntegratedIQACalculator :278-329) —
    PSNR/SSIM are native torch here; LPIPS requires pretrained backbone
    weights and is gated (pluggable callable);
  * 512x512 patchify with a minimum 9x16 patch grid per image (:46-135);
  * distribution metrics over the patch sets: CMMD (eval/cmmd.py) and a
    Frechet distance over pluggable embeddings (the CLIP-FID analog of
    clean-fid's clip_vit_b_32 backend, :331-366);
  * per-scene / per-method CSV summaries (:410-590).
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from skyfall_gs_tpu_torch.eval.cmmd import ClipEmbedder, mmd
from skyfall_gs_tpu_torch.ops.losses import psnr as psnr_fn
from skyfall_gs_tpu_torch.ops.ssim import ssim as ssim_fn


# ----------------------------------------------------------------------------
# Frames
# ----------------------------------------------------------------------------

def extract_frames(video_path: str, num_frames: int,
                   resize: Optional[int] = None) -> List[np.ndarray]:
    """Uniformly sample ``num_frames`` RGB frames (float [0,1]) from a video."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    idxs = np.linspace(0, max(total - 1, 0), num_frames).astype(int)
    frames = []
    for idx in idxs:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            continue
        frame = frame[..., ::-1].astype(np.float32) / 255.0
        if resize is not None:
            frame = cv2.resize(frame, (resize, resize),
                               interpolation=cv2.INTER_AREA)
        frames.append(frame)
    cap.release()
    return frames


def patchify(image: np.ndarray, patch_size: int = 512,
             min_patches: tuple = (9, 16)) -> List[np.ndarray]:
    """Overlapping patches with a guaranteed minimum grid (reference
    eval.py:46-135 semantics, including the undersized-image fallback)."""
    h, w = image.shape[:2]
    min_h, min_w = min_patches
    if h < patch_size or w < patch_size:
        return []
    h_stride = max(1, (h - patch_size) // max(min_h - 1, 1))
    w_stride = max(1, (w - patch_size) // max(min_w - 1, 1))
    stride = min(h_stride, w_stride)
    n_h = max(1, (h - patch_size) // stride + 1)
    n_w = max(1, (w - patch_size) // stride + 1)
    if n_h < min_h or n_w < min_w:
        hs = (h - patch_size) / max(min_h - 1, 1)
        ws = (w - patch_size) / max(min_w - 1, 1)
        ys = [min(int(i * hs), h - patch_size) for i in range(min_h)]
        xs = [min(int(j * ws), w - patch_size) for j in range(min_w)]
        return [image[y:y + patch_size, x:x + patch_size]
                for y in ys for x in xs]
    return [image[i * stride:i * stride + patch_size,
                  j * stride:j * stride + patch_size]
            for i in range(n_h) for j in range(n_w)]


# ----------------------------------------------------------------------------
# Paired metrics
# ----------------------------------------------------------------------------

def paired_metrics(
    gt_frames: Sequence[np.ndarray],
    pred_frames: Sequence[np.ndarray],
    lpips_fn: Optional[Callable] = None,
    device="cuda",
) -> Dict[str, float]:
    """Mean PSNR/SSIM (and LPIPS when a backend is supplied) over frame
    pairs, computed on ``device``."""
    psnrs, ssims, lpips_vals = [], [], []
    for gt, pred in zip(gt_frames, pred_frames):
        g = torch.as_tensor(np.asarray(gt, np.float32), device=device)
        p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
        psnrs.append(float(psnr_fn(p, g)))
        ssims.append(float(ssim_fn(p.permute(2, 0, 1), g.permute(2, 0, 1))))
        if lpips_fn is not None:
            lpips_vals.append(float(lpips_fn(gt, pred)))
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "psnr_std": float(np.std(psnrs)), "ssim_std": float(np.std(ssims))}
    if lpips_vals:
        out["lpips"] = float(np.mean(lpips_vals))
        out["lpips_std"] = float(np.std(lpips_vals))
    return out


# ----------------------------------------------------------------------------
# Distribution metrics
# ----------------------------------------------------------------------------

def frechet_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Frechet distance between Gaussians fit to two embedding sets — the
    FID formula; with CLIP embeddings this is the CLIP-FID of clean-fid."""
    from scipy import linalg

    mu1, mu2 = x.mean(0), y.mean(0)
    c1 = np.cov(x, rowvar=False)
    c2 = np.cov(y, rowvar=False)
    covmean = linalg.sqrtm(c1 @ c2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(c1) + np.trace(c2)
                 - 2.0 * np.trace(covmean))


def distribution_metrics(
    gt_frames: Sequence[np.ndarray],
    pred_frames: Sequence[np.ndarray],
    embed_fn: Optional[Callable] = None,
    patch_size: int = 512,
    min_patches: tuple = (9, 16),
    device="cuda",
) -> Dict[str, float]:
    """CLIP-FID + CMMD over 512^2 patch sets (needs an embedding backend;
    the default ``ClipEmbedder`` and the MMD run on ``device``)."""
    gt_patches = [p for f in gt_frames
                  for p in patchify(f, patch_size, min_patches)]
    pr_patches = [p for f in pred_frames
                  for p in patchify(f, patch_size, min_patches)]
    if not gt_patches or not pr_patches:
        return {}
    if embed_fn is None:
        embed_fn = ClipEmbedder(device=device)
    x = embed_fn(gt_patches)
    y = embed_fn(pr_patches)
    return {
        "clip_fid": frechet_distance(x, y),
        "cmmd": float(mmd(torch.as_tensor(x, device=device), y)),
    }


# ----------------------------------------------------------------------------
# CSV reporting
# ----------------------------------------------------------------------------

def write_csv(path: str, rows: List[Dict[str, object]]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not rows:
        return
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)


def summarize(rows: List[Dict[str, object]],
              metric_keys: Sequence[str]) -> Dict[str, str]:
    """mean+-std summary line per metric (reference eval.py:558-587)."""
    out = {}
    for k in metric_keys:
        vals = [float(r[k]) for r in rows if k in r and r[k] == r[k]]
        if vals:
            out[k] = f"{np.mean(vals):.4f}+-{np.std(vals):.4f}"
    return out
