"""Scene container: views grouped by resolution, stacked on the device.

Port of the device side of ``skyfall_gs_tpu/io/scene.py``: ``View``,
``ViewGroup``, ``stack_views``, ``SceneData.build_groups`` and
``resolve_resolution``.  A group's images, masks and depths are stacked
(M, H, W, ...) tensors on the scene's device, so picking a training view
moves no data.  Its cameras stay a list of ``Camera`` objects whose
tensors already live on that device (the port runs no fused scan that
would need them stacked).

The on-disk readers and ``load_scene`` are not ported yet (ROADMAP
Queue 1, the io readers item); scenes come from ``io/synthetic.py`` or are
assembled in memory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from skyfall_gs_tpu_torch.core.camera import Camera


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

    @property
    def num_train(self) -> int:
        return len(self.train_views)

    def build_groups(self) -> None:
        """Group the train views by resolution and stack them on ``device``."""
        groups: Dict[tuple, List[View]] = {}
        for v in self.train_views:
            groups.setdefault((v.camera.height, v.camera.width), []).append(v)
        self.train_groups = {k: stack_views(vs, self.device) for k, vs in groups.items()}
