"""Scene readers: Satellite / COLMAP / Blender / multi-scale Blender.

Port of ``skyfall_gs_tpu/io/readers.py``, which is host-side numpy, so the
code is the JAX package's: ``CameraRecord`` / ``RawScene``, nerf++
normalization, the COLMAP reader with its every-8th test split and
normalized principal point, the Blender and multi-scale readers with alpha
compositing, and the satellite reader whose global R/T fix rescales the
points3D.txt cloud to a radius-256 sphere (99th percentile), shifts the
1st-percentile z to 0 and applies the same rescale to every camera, in
float64.

Images decode to float32 [0, 1] HWC.  PNG goes through ``io/png.py``
(numpy + zlib), so a PNG scene with ``.npy`` masks and depths needs neither
PIL nor OpenCV; other image formats go through PIL, ``.exr`` depths
through OpenCV.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import List, Optional

import numpy as np

from skyfall_gs_tpu_torch.core.transforms import focal_to_fov, fov_to_focal, world_to_view
from skyfall_gs_tpu_torch.io import colmap as colmap_io
from skyfall_gs_tpu_torch.io.exr import read_depth
from skyfall_gs_tpu_torch.io.ply import read_ply, write_ply
from skyfall_gs_tpu_torch.io.png import read_png


@dataclass
class CameraRecord:
    """Host-side description of one view."""

    uid: int
    R: np.ndarray          # (3,3) camera-to-world rotation (transposed w2c)
    T: np.ndarray          # (3,) world-to-camera translation
    fov_x: float
    fov_y: float
    cx: float = 0.0        # normalized principal-point shift
    cy: float = 0.0
    width: int = 0
    height: int = 0
    image: Optional[np.ndarray] = None   # (H, W, 3) float32 [0,1]
    mask: Optional[np.ndarray] = None    # (H, W) float32 {0,1}
    depth: Optional[np.ndarray] = None   # (H, W) float32
    image_name: str = ""
    image_path: str = ""


@dataclass
class RawScene:
    points: np.ndarray                 # (N, 3)
    colors: np.ndarray                 # (N, 3) in [0, 1]
    train_cameras: List[CameraRecord]
    test_cameras: List[CameraRecord]
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0
    ply_path: str = ""


def _decode(path: str, mode: str) -> np.ndarray:
    """(H, W, 3|4) uint8, as PIL's ``Image.open(path).convert(mode)``."""
    if path.lower().endswith(".png"):
        return read_png(path, mode)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


def _load_image(path: str) -> np.ndarray:
    return _decode(path, "RGB").astype(np.float32) / 255.0


def _load_image_rgba_composited(path: str, white_background: bool) -> np.ndarray:
    data = _decode(path, "RGBA").astype(np.float32) / 255.0
    bg = np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
    return data[..., :3] * data[..., 3:4] + bg * (1.0 - data[..., 3:4])


def _prefetch_images(paths, loader) -> dict:
    """Decode a scene's images concurrently (zlib and PIL release the GIL
    while they decode).  Returns {path: array}."""
    from concurrent.futures import ThreadPoolExecutor

    uniq = list(dict.fromkeys(paths))
    if len(uniq) <= 1:
        return {p: loader(p) for p in uniq}
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        return dict(zip(uniq, ex.map(loader, uniq)))


def nerfpp_normalization(cameras: List[CameraRecord]) -> tuple[np.ndarray, float]:
    """Camera-centroid translate + 1.1 x max-distance radius."""
    centers = []
    for cam in cameras:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    diagonal = float(np.max(np.linalg.norm(centers - center, axis=1)))
    return -center, diagonal * 1.1


# ----------------------------------------------------------------------------
# Point-cloud helpers
# ----------------------------------------------------------------------------

def fetch_point_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    return pts, cols


def store_point_ply(path: str, xyz: np.ndarray, rgb255: np.ndarray) -> None:
    n = xyz.shape[0]
    zeros = np.zeros(n, np.float32)
    write_ply(
        path,
        {
            "x": xyz[:, 0].astype(np.float32),
            "y": xyz[:, 1].astype(np.float32),
            "z": xyz[:, 2].astype(np.float32),
            "nx": zeros, "ny": zeros, "nz": zeros,
            "red": rgb255[:, 0].astype(np.uint8),
            "green": rgb255[:, 1].astype(np.uint8),
            "blue": rgb255[:, 2].astype(np.uint8),
        },
        order=["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
    )


def _random_point_cloud(n: int = 100_000, seed: int = 0):
    rng = np.random.default_rng(seed)
    xyz = rng.random((n, 3)) * 2.6 - 1.3
    cols = rng.random((n, 3))
    return xyz.astype(np.float32), cols.astype(np.float32)


# ----------------------------------------------------------------------------
# COLMAP scenes
# ----------------------------------------------------------------------------

def read_colmap_scene(path: str, images_dir: str = "images", eval_split: bool = False,
                      llffhold: int = 8, load_images: bool = True) -> RawScene:
    sparse = os.path.join(path, "sparse", "0")
    try:
        extr = colmap_io.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap_io.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap_io.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap_io.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    images = _prefetch_images(
        [os.path.join(path, images_dir, os.path.basename(extr[k].name)) for k in extr],
        _load_image) if load_images else {}
    records: List[CameraRecord] = []
    for key in extr:
        e = extr[key]
        c = intr[e.camera_id]
        R = colmap_io.qvec_to_rotmat(e.qvec).T
        T = np.asarray(e.tvec)
        if c.model == "SIMPLE_PINHOLE":
            fx = fy = c.params[0]
            cx_px, cy_px = c.params[1], c.params[2]
        elif c.model == "PINHOLE":
            fx, fy = c.params[0], c.params[1]
            cx_px, cy_px = c.params[2], c.params[3]
        else:
            raise ValueError(f"unsupported COLMAP camera model {c.model}; undistort first")
        img_path = os.path.join(path, images_dir, os.path.basename(e.name))
        records.append(CameraRecord(
            uid=c.id,
            R=R, T=T,
            fov_x=focal_to_fov(fx, c.width),
            fov_y=focal_to_fov(fy, c.height),
            cx=(cx_px - c.width / 2) / c.width * 2,
            cy=(cy_px - c.height / 2) / c.height * 2,
            width=c.width, height=c.height,
            image=images[img_path] if load_images else None,
            image_name=os.path.basename(img_path).split(".")[0],
            image_path=img_path,
        ))
    records.sort(key=lambda r: r.image_name)

    if eval_split:
        train = [r for i, r in enumerate(records) if i % llffhold != 0]
        test = [r for i, r in enumerate(records) if i % llffhold == 0]
    else:
        train, test = records, []

    translate, radius = nerfpp_normalization(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap_io.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap_io.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_point_ply(ply_path, xyz, rgb)
    pts, cols = fetch_point_ply(ply_path)
    return RawScene(pts, cols, train, test, translate, radius, ply_path)


# ----------------------------------------------------------------------------
# Blender (NeRF-synthetic) scenes
# ----------------------------------------------------------------------------

def _read_transforms_cameras(path: str, fname: str, white_background: bool,
                             extension: str = ".png") -> List[CameraRecord]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    fov_x = contents["camera_angle_x"]
    images = _prefetch_images(
        [os.path.join(path, f["file_path"] + extension) for f in contents["frames"]],
        lambda p: _load_image_rgba_composited(p, white_background))
    records = []
    for idx, frame in enumerate(contents["frames"]):
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
        w2c = np.linalg.inv(c2w)
        img_path = os.path.join(path, frame["file_path"] + extension)
        image = images[img_path]
        h, w = image.shape[:2]
        fov_y = focal_to_fov(fov_to_focal(fov_x, w), h)
        records.append(CameraRecord(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], fov_x=fov_x, fov_y=fov_y,
            width=w, height=h, image=image, image_name=Path(img_path).stem,
            image_path=img_path,
        ))
    return records


def _random_cloud_ply(path: str, seed: int) -> str:
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        xyz, cols = _random_point_cloud(seed=seed)
        store_point_ply(ply_path, xyz, cols * 255)
    return ply_path


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False, extension: str = ".png",
                       seed: int = 0) -> RawScene:
    train = _read_transforms_cameras(path, "transforms_train.json", white_background,
                                     extension)
    test = _read_transforms_cameras(path, "transforms_test.json", white_background,
                                    extension)
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_normalization(train)
    ply_path = _random_cloud_ply(path, seed)
    pts, cols = fetch_point_ply(ply_path)
    return RawScene(pts, cols, train, test, translate, radius, ply_path)


# ----------------------------------------------------------------------------
# Multi-scale Blender scenes (metadata.json)
# ----------------------------------------------------------------------------

def _read_multiscale_cameras(path: str, split: str, white_background: bool,
                             only_highres: bool) -> List[CameraRecord]:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)[split]
    images = _prefetch_images(
        [os.path.join(path, rel) for rel in meta["file_path"]
         if not (only_highres and not rel.endswith("d0.png"))],
        lambda p: _load_image_rgba_composited(p, white_background))
    records = []
    for idx, rel in enumerate(meta["file_path"]):
        if only_highres and not rel.endswith("d0.png"):
            continue
        c2w = np.array(meta["cam2world"][idx], np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        img_path = os.path.join(path, rel)
        image = images[img_path]
        h, w = image.shape[:2]
        focal = meta["focal"][idx]
        records.append(CameraRecord(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
            fov_x=focal_to_fov(focal, w), fov_y=focal_to_fov(focal, h),
            width=w, height=h, image=image,
            image_name=Path(img_path).stem, image_path=img_path,
        ))
    return records


def read_multiscale_scene(path: str, white_background: bool = False,
                          eval_split: bool = False, load_allres: bool = False,
                          seed: int = 0) -> RawScene:
    train = _read_multiscale_cameras(path, "train", white_background,
                                     only_highres=not load_allres)
    test = _read_multiscale_cameras(path, "test", white_background, only_highres=False)
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_normalization(train)
    ply_path = _random_cloud_ply(path, seed)
    pts, cols = fetch_point_ply(ply_path)
    return RawScene(pts, cols, train, test, translate, radius, ply_path)


# ----------------------------------------------------------------------------
# Satellite scenes
# ----------------------------------------------------------------------------

def _read_satellite_cameras(path: str, fname: str) -> tuple[List[CameraRecord],
                                                            Optional[np.ndarray],
                                                            Optional[np.ndarray]]:
    with open(os.path.join(path, fname)) as f:
        contents = json.load(f)
    if "R" in contents:
        r_fix = np.array(contents["R"])[:3, :3]
        t_fix = np.array(contents["T"])
        c2w_key = "transform_matrix_rotated"
    else:
        r_fix = t_fix = None
        c2w_key = "transform_matrix"

    images = _prefetch_images(
        [os.path.join(path, f["file_path"]) for f in contents["frames"]], _load_image)
    records = []
    for idx, frame in enumerate(contents["frames"]):
        img_path = os.path.join(path, frame["file_path"])
        image = images[img_path]
        h, w = image.shape[:2]
        name = Path(img_path).stem

        mask_path = os.path.join(path, "masks", name + ".npy")
        if os.path.exists(mask_path):
            mask = np.load(mask_path).astype(np.float32)
        else:
            mask = 1.0 - np.all(image == 0.0, axis=-1).astype(np.float32)

        depth = None
        for ext in (".exr", ".npy"):
            dp = os.path.join(path, "depths_moge", name + ext)
            if os.path.exists(dp):
                depth = read_depth(dp)
                break

        c2w = np.array(frame[c2w_key], np.float64)  # already COLMAP convention
        w2c = np.linalg.inv(c2w)
        cx = (frame["cx"] - w / 2) / w * 2
        cy = (frame["cy"] - h / 2) / h * 2
        records.append(CameraRecord(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
            fov_x=focal_to_fov(frame["fl_x"], w),
            fov_y=focal_to_fov(frame["fl_y"], h),
            cx=cx, cy=cy, width=w, height=h,
            image=image, mask=mask, depth=depth,
            image_name=name, image_path=img_path,
        ))
    return records, r_fix, t_fix


def _rescale_camera(rec: CameraRecord, scale: float, z_min: float) -> CameraRecord:
    w2c = np.eye(4)
    w2c[:3, :3] = rec.R.T
    w2c[:3, 3] = rec.T
    c2w = np.linalg.inv(w2c)
    c2w[:3, 3] *= scale
    c2w[2, 3] -= z_min
    w2c = np.linalg.inv(c2w)
    return replace(rec, R=w2c[:3, :3].T, T=w2c[:3, 3])


def read_satellite_scene(path: str, eval_split: bool = False,
                         target_radius: float = 256.0) -> RawScene:
    train, r_fix, t_fix = _read_satellite_cameras(path, "transforms_train.json")
    test, _, _ = _read_satellite_cameras(path, "transforms_test.json")
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_normalization(train)

    ply_path = os.path.join(path, "points3D.ply")
    txt_path = os.path.join(path, "points3D.txt")
    xyz, rgb, _ = colmap_io.read_points3d_text(txt_path)
    if r_fix is not None and t_fix is not None:
        xyz = xyz @ r_fix.T - t_fix
        cloud_radius = np.percentile(np.linalg.norm(xyz, axis=1), 99)
        scale = target_radius / cloud_radius
        xyz = xyz * scale
        z_min = np.percentile(xyz[:, 2], 1)
        xyz = xyz - np.array([0.0, 0.0, z_min])
        train = [_rescale_camera(r, scale, z_min) for r in train]
        test = [_rescale_camera(r, scale, z_min) for r in test]
        translate, radius = np.zeros(3), target_radius / 2.0
    store_point_ply(ply_path, xyz, rgb)
    pts, cols = fetch_point_ply(ply_path)
    return RawScene(pts, cols, train, test, translate, radius, ply_path)


# ----------------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------------

def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        if os.path.exists(os.path.join(path, "points3D.txt")):
            return "satellite"
        return "blender"
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "metadata.json")):
        return "multiscale"
    raise ValueError(f"could not identify scene type at {path}")


SCENE_READERS = {
    "satellite": read_satellite_scene,
    "colmap": read_colmap_scene,
    "blender": read_blender_scene,
    "multiscale": read_multiscale_scene,
}
