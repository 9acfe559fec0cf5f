"""Scene container: views grouped by resolution, stacked on the device.

Port of ``skyfall_gs_tpu/io/scene.py``: ``load_scene`` (type sniffing,
the seeded shuffle of the train records, uids 0..M-1 for train and again
for test views, the ``input.ply`` and ``cameras.json`` dumps),
``record_to_view`` with the reference's resolution rules, ``View``,
``ViewGroup``, ``stack_views`` and ``SceneData``.  A group's images, masks
and depths are stacked (M, H, W, ...) tensors on the scene's device, so
picking a training view moves no data.  Its cameras stay a list of
``Camera`` objects whose tensors already live on that device (the port
runs no fused scan that would need them stacked).

Downscaling is OpenCV's INTER_AREA written as two separable overlap-weight
matrices (``_resize_area``), so loading a scene needs no OpenCV.
"""

from __future__ import annotations

import json
import math
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import Camera, make_camera
from skyfall_gs_tpu_torch.io.readers import (
    SCENE_READERS,
    CameraRecord,
    RawScene,
    detect_scene_type,
    store_point_ply,
)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_AREA weights: output cell i averages the input
    pixels under [i s, (i + 1) s), s = n_in / n_out, each weighted by its
    overlap (OpenCV's ``computeResizeAreaTab``, slivers under 1e-3 dropped
    as OpenCV drops them)."""
    scale = 1.0 / (n_out / n_in)
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        f1 = i * scale
        f2 = f1 + scale
        s1, s2 = math.ceil(f1), math.floor(f2)
        cell = min(scale, n_in - f1)
        if s1 - f1 > 1e-3:
            w[i, s1 - 1] = (s1 - f1) / cell
        w[i, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[i, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w


def _resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Area-average downscale of (H, W) or (H, W, C) to (h, w), as OpenCV's
    ``resize(..., interpolation=INTER_AREA)``; float32 out.  Upscaling, where
    OpenCV switches to bilinear, raises."""
    src_h, src_w = img.shape[:2]
    if w > src_w or h > src_h:
        raise ValueError(f"_resize_area only downscales: ({src_w}, {src_h}) -> ({w}, {h})")
    wy = _area_weights(src_h, h).astype(np.float32)
    wx = _area_weights(src_w, w).astype(np.float32)
    out = np.einsum("yi,ij...->yj...", wy, np.asarray(img, np.float32))
    return np.einsum("xj,yj...->yx...", wx, out).astype(np.float32)


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """Training resolution: a divisor in {1, 2, ..., 64}, -1 (cap the width
    at 1600), or a target width."""
    if resolution in (1, 2, 4, 8, 16, 32, 64):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


@dataclass
class View:
    """One view: camera + host ground-truth arrays."""

    camera: Camera
    image: Optional[np.ndarray] = None   # (H, W, 3)
    mask: Optional[np.ndarray] = None    # (H, W)
    depth: Optional[np.ndarray] = None   # (H, W)
    image_name: str = ""


def record_to_view(rec: CameraRecord, resolution: int = -1,
                   resolution_scale: float = 1.0, uid: Optional[int] = None,
                   resize: bool = True, device="cpu") -> View:
    if rec.image is not None and resize:
        w, h = resolve_resolution(rec.width, rec.height, resolution, resolution_scale)
    else:
        w, h = rec.width, rec.height
    image = rec.image
    mask = rec.mask
    depth = rec.depth
    if image is not None and (w, h) != (rec.width, rec.height):
        image = _resize_area(image, w, h)
        if mask is not None:
            mask = (_resize_area(mask, w, h) > 0.5).astype(np.float32)
        if depth is not None:
            depth = _resize_area(depth, w, h)
    cam = make_camera(rec.R, rec.T, rec.fov_x, rec.fov_y, w, h, cx=rec.cx, cy=rec.cy,
                      uid=rec.uid if uid is None else uid, device=device)
    return View(camera=cam, image=image, mask=mask, depth=depth, image_name=rec.image_name)


@dataclass
class ViewGroup:
    """Views of identical resolution, stacked for on-device random access."""

    cameras: List[Camera]
    images: torch.Tensor                 # (M, H, W, 3)
    masks: torch.Tensor                  # (M, H, W)
    depths: torch.Tensor                 # (M, H, W)
    has_depth: bool
    names: List[str]

    @property
    def size(self) -> int:
        return self.images.shape[0]

    def select(self, i: int):
        """View ``i`` as (camera, image, mask, depth)."""
        return self.cameras[i], self.images[i], self.masks[i], self.depths[i]


def stack_views(views: Sequence[View], device="cpu") -> ViewGroup:
    h, w = views[0].image.shape[:2]

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays).astype(np.float32)).to(device)

    return ViewGroup(
        cameras=[v.camera.to(device) for v in views],
        images=stack([v.image for v in views]),
        masks=stack([v.mask if v.mask is not None else np.ones((h, w), np.float32)
                     for v in views]),
        depths=stack([v.depth if v.depth is not None else np.zeros((h, w), np.float32)
                      for v in views]),
        has_depth=any(v.depth is not None for v in views),
        names=[v.image_name for v in views],
    )


@dataclass
class SceneData:
    """Everything the trainer needs for one scene.  ``device`` is where the
    train groups, and the model trained on them, live."""

    source_path: str
    scene_type: str
    points: np.ndarray
    colors: np.ndarray
    train_views: List[View]
    test_views: List[View]
    cameras_extent: float
    device: str = "cpu"
    train_groups: Dict[tuple, ViewGroup] = field(default_factory=dict)
    idu_views: List[View] = field(default_factory=list)

    @property
    def num_train(self) -> int:
        return len(self.train_views)

    def build_groups(self) -> None:
        """Group the train views by resolution and stack them on ``device``."""
        groups: Dict[tuple, List[View]] = {}
        for v in self.train_views:
            groups.setdefault((v.camera.height, v.camera.width), []).append(v)
        self.train_groups = {k: stack_views(vs, self.device) for k, vs in groups.items()}


def load_scene(
    source_path: str,
    resolution: int = -1,
    resolution_scales: Sequence[float] = (1.0,),
    eval_split: bool = False,
    white_background: bool = False,
    load_allres: bool = False,
    model_path: Optional[str] = None,
    shuffle: bool = True,
    seed: int = 0,
    device="cpu",
) -> SceneData:
    """Read a scene directory into views and train groups on ``device``.

    Like the reference Scene, copies the input point cloud to
    ``model_path/input.ply`` and dumps ``model_path/cameras.json``.
    """
    scene_type = detect_scene_type(source_path)
    reader = SCENE_READERS[scene_type]
    if scene_type in ("satellite", "colmap"):
        raw: RawScene = reader(source_path, eval_split=eval_split)
    elif scene_type == "multiscale":
        raw = reader(source_path, white_background=white_background,
                     eval_split=eval_split, load_allres=load_allres)
    else:
        raw = reader(source_path, white_background=white_background, eval_split=eval_split)

    if shuffle:
        random.Random(seed).shuffle(raw.train_cameras)

    scale = resolution_scales[0]
    train_views = [record_to_view(r, resolution, scale, uid=i, device=device)
                   for i, r in enumerate(raw.train_cameras)]
    test_views = [record_to_view(r, resolution, scale, uid=i, device=device)
                  for i, r in enumerate(raw.test_cameras)]

    if model_path:
        os.makedirs(model_path, exist_ok=True)
        store_point_ply(os.path.join(model_path, "input.ply"), raw.points,
                        raw.colors * 255.0)
        with open(os.path.join(model_path, "cameras.json"), "w") as f:
            json.dump([_camera_to_json(i, v)
                       for i, v in enumerate(train_views + test_views)], f)

    scene = SceneData(
        source_path=source_path,
        scene_type=scene_type,
        points=raw.points,
        colors=raw.colors,
        train_views=train_views,
        test_views=test_views,
        cameras_extent=float(raw.radius),
        device=str(device),
    )
    scene.build_groups()
    return scene


def _camera_to_json(idx: int, view: View) -> dict:
    cam = view.camera
    c2w = np.linalg.inv(cam.world_view.cpu().numpy())     # float32, as JAX inverts it
    return {
        "id": idx,
        "img_name": view.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [row.tolist() for row in c2w[:3, :3]],
        "fx": float(cam.focal_x),
        "fy": float(cam.focal_y),
        "cx": float(cam.cx),
        "cy": float(cam.cy),
    }
