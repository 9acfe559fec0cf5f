"""Port parity: the on-disk readers, the PNG codec, the area resize and
load_scene (io/colmap.py, io/png.py, io/readers.py, io/scene.py).

Tolerances, and why:
  * readers: both packages run the same float64 numpy on the same files,
    so poses agree to 1e-12 and images, masks, depths and points EXACTLY;
  * io/png.py decodes to the bytes PIL decodes (exact);
  * ``_resize_area`` against OpenCV's INTER_AREA: max abs 1e-5 on [0, 1]
    data (both sum float32 products, in different orders);
  * load_scene: cameras are built from the same float64 records (1e-6 on
    the float32 matrices), ``cameras.json`` agrees to 1e-6 and
    ``input.ply`` byte for byte.
"""

import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from skyfall_gs_tpu.io import colmap as jcolmap
from skyfall_gs_tpu.io import readers as jreaders
from skyfall_gs_tpu.io import scene as jscene
from skyfall_gs_tpu_torch.io import colmap as tcolmap
from skyfall_gs_tpu_torch.io import png as tpng
from skyfall_gs_tpu_torch.io import readers as treaders
from skyfall_gs_tpu_torch.io import scene as tscene
from tests.test_io import (
    _make_blender_fixture,
    _make_multiscale_fixture,
    _make_satellite_fixture,
)

torch.set_num_threads(1)


# ----------------------------------------------------------------------------
# Fixtures
# ----------------------------------------------------------------------------

def _colmap_fixture(root, rng, binary: bool, n_images=5, size=(40, 30)):
    """A COLMAP scene: PINHOLE and SIMPLE_PINHOLE cameras, PNG and JPEG
    images, points3D with tracks, in the binary or the text format."""
    from PIL import Image

    w, h = size
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    cams = {1: ("PINHOLE", [50.0, 52.0, w / 2 + 1.5, h / 2 - 0.5]),
            2: ("SIMPLE_PINHOLE", [45.0, w / 2, h / 2])}
    images = []
    for i in range(n_images):
        q = rng.normal(size=4)
        q = q / np.linalg.norm(q) * np.sign(q[0])
        t = rng.normal(0, 2, 3)
        name = f"im_{(7 * i) % n_images:02d}.{'jpg' if i == 3 else 'png'}"
        images.append((i + 1, q, t, 1 + i % 2, name))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", name))
    xyz = rng.normal(0, 3, (30, 3))
    rgb = rng.integers(0, 256, (30, 3))
    if binary:
        model_ids = {name: mid for mid, (name, _) in jcolmap._MODELS.items()}
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, (model, params) in cams.items():
                f.write(struct.pack("<iiQQ", cid, model_ids[model], w, h))
                f.write(struct.pack("<" + "d" * len(params), *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, q, t, cid, name in images:
                f.write(struct.pack("<idddddddi", iid, *q, *t, cid))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2))
                f.write(struct.pack("<ddqddq", 1.0, 2.0, 1, 3.0, 4.0, -1))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(xyz)))
            for k in range(len(xyz)):
                f.write(struct.pack("<QdddBBBd", k + 1, *xyz[k], *rgb[k], 0.5))
                f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# camera list\n")
            for cid, (model, params) in cams.items():
                f.write(f"{cid} {model} {w} {h} {' '.join(repr(p) for p in params)}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# image list\n")
            for iid, q, t, cid, name in images:
                f.write(f"{iid} {' '.join(repr(float(v)) for v in (*q, *t))} {cid} {name}\n")
                f.write("1.0 2.0 1 3.0 4.0 -1\n")
        jcolmap.write_points3d_text(os.path.join(sparse, "points3D.txt"), xyz, rgb)
    return root


def _same_records(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.uid, g.width, g.height, g.image_name, g.image_path) == \
            (r.uid, r.width, r.height, r.image_name, r.image_path)
        np.testing.assert_allclose(g.R, r.R, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.T, r.T, rtol=0, atol=1e-12)
        for k in ("fov_x", "fov_y", "cx", "cy"):
            assert getattr(g, k) == pytest.approx(getattr(r, k), abs=1e-12), k
        for k in ("image", "mask", "depth"):
            a, b = getattr(g, k), getattr(r, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)


def _same_raw(got, ref):
    _same_records(got.train_cameras, ref.train_cameras)
    if ref.test_cameras:
        _same_records(got.test_cameras, ref.test_cameras)
    else:
        assert got.test_cameras == []
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.colors, ref.colors)
    np.testing.assert_allclose(got.translate, ref.translate, rtol=0, atol=1e-12)
    assert got.radius == pytest.approx(ref.radius, abs=1e-12)


def _with_rt_fix(root):
    for split in ("train", "test"):
        p = os.path.join(root, f"transforms_{split}.json")
        with open(p) as f:
            d = json.load(f)
        d["R"] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
        d["T"] = [3.0, -2.0, 1.0]
        for fr in d["frames"]:
            fr["transform_matrix_rotated"] = fr["transform_matrix"]
        with open(p, "w") as f:
            json.dump(d, f)


def _masks_and_depths(root, rng, size=32, n=3):
    os.makedirs(os.path.join(root, "masks"))
    os.makedirs(os.path.join(root, "depths_moge"))
    for i in range(n):
        np.save(os.path.join(root, "masks", f"img_{i}.npy"),
                (rng.uniform(0, 1, (size, size)) > 0.3).astype(np.uint8))
        if i != 1:   # one view without depth
            np.save(os.path.join(root, "depths_moge", f"img_{i}.npy"),
                    rng.uniform(1, 9, (size, size)).astype(np.float32))


# ----------------------------------------------------------------------------
# COLMAP parsers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_colmap_parsers_match_jax(tmp_path, rng, binary):
    root = _colmap_fixture(str(tmp_path / "c"), rng, binary)
    sparse = os.path.join(root, "sparse", "0")
    ext = "bin" if binary else "txt"
    kind = "binary" if binary else "text"
    for what in ("cameras", "images"):
        got = getattr(tcolmap, f"read_{what}_{kind}")(os.path.join(sparse, f"{what}.{ext}"))
        ref = getattr(jcolmap, f"read_{what}_{kind}")(os.path.join(sparse, f"{what}.{ext}"))
        assert got.keys() == ref.keys()
        for k in ref:
            for a, b in zip(got[k], ref[k]):
                np.testing.assert_array_equal(a, b)
    got = getattr(tcolmap, f"read_points3d_{kind}")(os.path.join(sparse, f"points3D.{ext}"))
    ref = getattr(jcolmap, f"read_points3d_{kind}")(os.path.join(sparse, f"points3D.{ext}"))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_colmap_rotations_and_points_text(tmp_path, rng):
    q = rng.normal(size=4)
    q = q / np.linalg.norm(q)
    R = tcolmap.qvec_to_rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec_to_rotmat(q))
    np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R), jcolmap.rotmat_to_qvec(R))
    np.testing.assert_allclose(tcolmap.rotmat_to_qvec(R), q * np.sign(q[0]), atol=1e-12)
    xyz, rgb = rng.normal(0, 5, (20, 3)), rng.integers(0, 256, (20, 3)).astype(float)
    tcolmap.write_points3d_text(str(tmp_path / "t.txt"), xyz, rgb)
    jcolmap.write_points3d_text(str(tmp_path / "j.txt"), xyz, rgb)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


# ----------------------------------------------------------------------------
# The four readers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("eval_split", [False, True])
def test_colmap_reader_matches_jax(tmp_path, rng, binary, eval_split):
    root = _colmap_fixture(str(tmp_path / "c"), rng, binary, n_images=10)
    got = treaders.read_colmap_scene(root, eval_split=eval_split)
    os.remove(got.ply_path)          # JAX converts the points itself
    ref = jreaders.read_colmap_scene(root, eval_split=eval_split)
    _same_raw(got, ref)
    assert (len(got.test_cameras) == 2) == eval_split


@pytest.mark.parametrize("white", [False, True])
def test_blender_reader_matches_jax(tmp_path, rng, white):
    root = _make_blender_fixture(str(tmp_path / "b"), rng)
    got = treaders.read_blender_scene(root, white_background=white, eval_split=True)
    os.remove(got.ply_path)          # each package draws its own random cloud
    ref = jreaders.read_blender_scene(root, white_background=white, eval_split=True)
    _same_raw(got, ref)
    assert got.train_cameras[0].image.shape == (32, 32, 3)


@pytest.mark.parametrize("load_allres", [False, True])
def test_multiscale_reader_matches_jax(tmp_path, rng, load_allres):
    root = _make_multiscale_fixture(str(tmp_path / "m"), rng)
    got = treaders.read_multiscale_scene(root, eval_split=True, load_allres=load_allres)
    os.remove(got.ply_path)
    ref = jreaders.read_multiscale_scene(root, eval_split=True, load_allres=load_allres)
    _same_raw(got, ref)
    assert len(got.train_cameras) == (6 if load_allres else 3)


@pytest.mark.parametrize("rt_fix", [False, True])
def test_satellite_reader_matches_jax(tmp_path, rng, rt_fix):
    root = _make_satellite_fixture(str(tmp_path / "s"), rng)
    _masks_and_depths(root, rng)
    if rt_fix:
        _with_rt_fix(root)
    got = treaders.read_satellite_scene(root, eval_split=True)
    ply = (tmp_path / "s" / "points3D.ply").read_bytes()
    ref = jreaders.read_satellite_scene(root, eval_split=True)
    assert (tmp_path / "s" / "points3D.ply").read_bytes() == ply
    _same_raw(got, ref)
    assert got.train_cameras[1].depth is None and got.train_cameras[0].depth is not None
    if rt_fix:
        assert got.radius == 128.0
        assert np.percentile(got.points[:, 2], 1) == pytest.approx(0.0, abs=1e-3)


def test_detect_scene_type_and_resolution(tmp_path, rng):
    roots = {
        "blender": _make_blender_fixture(str(tmp_path / "b"), rng),
        "satellite": _make_satellite_fixture(str(tmp_path / "s"), rng),
        "multiscale": _make_multiscale_fixture(str(tmp_path / "m"), rng),
        "colmap": _colmap_fixture(str(tmp_path / "c"), rng, True),
    }
    for kind, root in roots.items():
        assert treaders.detect_scene_type(root) == jreaders.detect_scene_type(root) == kind
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="could not identify"):
        treaders.detect_scene_type(str(tmp_path / "empty"))
    assert set(treaders.SCENE_READERS) == set(jreaders.SCENE_READERS)
    for args in [(1600, 1200, 2), (1600, 1200, 1), (3200, 2400, -1), (800, 600, -1),
                 (1000, 750, 500), (1001, 777, 4, 2.0), (48, 48, 30), (1920, 1080, 8)]:
        assert tscene.resolve_resolution(*args) == jscene.resolve_resolution(*args), args


def test_random_cloud_and_nerfpp(tmp_path, rng):
    for a, b in zip(treaders._random_point_cloud(500, seed=3),
                    jreaders._random_point_cloud(500, seed=3)):
        np.testing.assert_array_equal(a, b)
    recs = [treaders.CameraRecord(uid=i, R=np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                  T=rng.normal(size=3), fov_x=1.0, fov_y=1.0)
            for i in range(4)]
    jrecs = [jreaders.CameraRecord(uid=r.uid, R=r.R, T=r.T, fov_x=1.0, fov_y=1.0)
             for r in recs]
    (t1, r1), (t2, r2) = treaders.nerfpp_normalization(recs), \
        jreaders.nerfpp_normalization(jrecs)
    np.testing.assert_array_equal(t1, t2)
    assert r1 == r2
    rec2 = treaders._rescale_camera(recs[0], 1.7, 3.2)
    jrec2 = jreaders._rescale_camera(jrecs[0], 1.7, 3.2)
    np.testing.assert_array_equal(rec2.R, jrec2.R)
    np.testing.assert_array_equal(rec2.T, jrec2.T)


# ----------------------------------------------------------------------------
# PNG codec
# ----------------------------------------------------------------------------

def _filtered_png(path, img, ftypes):
    """Write an 8-bit PNG of ``img`` (H, W, C), row y filtered with
    ``ftypes[y % len(ftypes)]`` (PNG filters 0-4)."""
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    x = img.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        cur = x[y]
        prev = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        t = ftypes[y % len(ftypes)]
        if t == 0:
            pred = 0
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        rows.append(bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


def _pil(path, mode):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filters_and_colour_types_match_pil(tmp_path, rng, ftypes, channels):
    img = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    img[4:9] = np.cumsum(img[4:9], axis=1, dtype=np.uint8)     # smooth rows too
    path = str(tmp_path / "f.png")
    _filtered_png(path, img, ftypes)
    for mode in ("RGB", "RGBA"):
        np.testing.assert_array_equal(tpng.read_png(path, mode), _pil(path, mode))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_png_pil_written_files_and_transparency(tmp_path, rng, mode):
    from PIL import Image

    base = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    base[..., :3] = np.cumsum(base[..., :3], axis=1, dtype=np.uint8) // 4
    im = Image.fromarray(base, "RGBA").convert(mode)
    first = np.asarray(im)[0, 0]
    kw = {}
    if mode == "L":
        kw["transparency"] = int(first)
    elif mode == "RGB":
        kw["transparency"] = tuple(int(v) for v in first)
    elif mode == "P":
        kw["transparency"] = bytes(range(0, 120, 3))
    for optimize in (False, True):
        path = str(tmp_path / f"{mode}{optimize}.png")
        im.save(path, optimize=optimize, **kw)
        for out in ("RGB", "RGBA"):
            np.testing.assert_array_equal(tpng.read_png(path, out), _pil(path, out))


def test_png_write_and_errors(tmp_path, rng):
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    tpng.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(_pil(str(tmp_path / "w.png"), "RGB"), img)
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "w.png")), img)
    with pytest.raises(ValueError):
        tpng.write_png(str(tmp_path / "x.png"), img.astype(np.float32))
    from PIL import Image

    Image.fromarray(img).convert("I;16").save(str(tmp_path / "d16.png"))
    with pytest.raises(ValueError, match="bit depth 16"):
        tpng.read_png(str(tmp_path / "d16.png"))
    data = bytearray((tmp_path / "w.png").read_bytes())
    data[28] = 1                     # IHDR interlace method: Adam7
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlace 1"):
        tpng.read_png(str(tmp_path / "i.png"))
    (tmp_path / "n.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        tpng.read_png(str(tmp_path / "n.png"))


# ----------------------------------------------------------------------------
# Area resize
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("src, dst", [((64, 48), (32, 24)), ((64, 48), (21, 17)),
                                      ((100, 37), (33, 29)), ((48, 48), (20, 48)),
                                      ((135, 240), (45, 80)), ((97, 131), (40, 55))])
def test_resize_area_matches_cv2(rng, src, dst):
    import cv2

    (h, w), (oh, ow) = src, dst
    for shape in ((h, w), (h, w, 3)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        got = tscene._resize_area(img, ow, oh)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # weights: rows sum to 1, overlap-weighted at non-integer factors
    wts = tscene._area_weights(w, ow)
    np.testing.assert_allclose(wts.sum(1), 1.0, atol=1e-3)


def test_resize_area_upscale_raises():
    with pytest.raises(ValueError, match="only downscales"):
        tscene._resize_area(np.zeros((8, 8), np.float32), 16, 4)


# ----------------------------------------------------------------------------
# load_scene
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sat_scene(tmp_path_factory):
    """A satellite scene with masks, depths and a global R/T fix, 8 views."""
    root = str(tmp_path_factory.mktemp("sat") / "scene")
    rng = np.random.default_rng(5)
    _make_satellite_fixture(root, rng, n_frames=4, size=32)
    # test split differs from train: drop the last two test frames
    p = os.path.join(root, "transforms_test.json")
    with open(p) as f:
        d = json.load(f)
    d["frames"] = d["frames"][:2]
    with open(p, "w") as f:
        json.dump(d, f)
    _masks_and_depths(root, rng, n=4)
    _with_rt_fix(root)
    return root


@pytest.mark.parametrize("resolution", [-1, 2, 20])
@pytest.mark.parametrize("seed", [0, 3])
def test_load_scene_matches_jax(tmp_path, sat_scene, resolution, seed):
    kw = dict(resolution=resolution, eval_split=True, seed=seed)
    got = tscene.load_scene(sat_scene, model_path=str(tmp_path / "t"), **kw)
    ref = jscene.load_scene(sat_scene, model_path=str(tmp_path / "j"), **kw)
    assert got.scene_type == ref.scene_type == "satellite"
    assert got.cameras_extent == ref.cameras_extent
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.colors, ref.colors)
    for gv, rv in ((got.train_views, ref.train_views), (got.test_views, ref.test_views)):
        assert [v.image_name for v in gv] == [v.image_name for v in rv]
        assert [v.camera.uid for v in gv] == [int(v.camera.uid) for v in rv] \
            == list(range(len(gv)))
        for a, b in zip(gv, rv):
            assert (a.camera.width, a.camera.height) == (b.camera.width, b.camera.height)
            for k in ("world_view", "full_proj", "cam_center", "focal_x", "focal_y", "cx", "cy"):
                np.testing.assert_allclose(getattr(a.camera, k).numpy(),
                                           np.asarray(getattr(b.camera, k)), rtol=0,
                                           atol=1e-6, err_msg=k)
            np.testing.assert_allclose(a.image, b.image, rtol=0, atol=1e-5)
            assert (a.depth is None) == (b.depth is None)
            if b.depth is not None:
                np.testing.assert_allclose(a.depth, b.depth, rtol=0,
                                           atol=1e-5 * float(np.abs(b.depth).max()))
            # a resized mask pixel may flip only where its average is within
            # float32 summation noise of the 0.5 threshold
            flips = a.mask != b.mask
            if flips.any():
                rec = next(r for r in treaders.read_satellite_scene(sat_scene, True)
                           .train_cameras + treaders.read_satellite_scene(
                               sat_scene, True).test_cameras
                           if r.image_name == a.image_name)
                avg = tscene._resize_area(rec.mask, a.camera.width, a.camera.height)
                assert np.abs(avg[flips] - 0.5).max() < 1e-5
    if resolution == 20:
        assert got.train_views[0].image.shape == (20, 20, 3)
    g = next(iter(got.train_groups.values()))
    assert g.size == len(got.train_views) and g.has_depth
    assert got.idu_views == [] and got.device == "cpu"

    assert (tmp_path / "t" / "input.ply").read_bytes() == \
        (tmp_path / "j" / "input.ply").read_bytes()
    tj = json.loads((tmp_path / "t" / "cameras.json").read_text())
    jj = json.loads((tmp_path / "j" / "cameras.json").read_text())
    assert len(tj) == len(jj) == len(got.train_views) + len(got.test_views)
    for a, b in zip(tj, jj):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


def test_load_scene_blender_and_device(tmp_path, rng):
    root = _make_blender_fixture(str(tmp_path / "b"), rng)
    shutil.copytree(root, tmp_path / "b2")
    got = tscene.load_scene(root, white_background=True, eval_split=False)
    ref = jscene.load_scene(str(tmp_path / "b2"), white_background=True, eval_split=False)
    assert got.num_train == ref.num_train == 6 and got.test_views == []
    for a, b in zip(got.train_views, ref.train_views):
        np.testing.assert_array_equal(a.image, b.image)
    g = next(iter(got.train_groups.values()))
    assert tuple(g.images.shape) == (6, 32, 32, 3) and g.images.device.type == "cpu"
    assert all(c.world_view.device.type == "cpu" for c in g.cameras)
