"""Port parity: the evaluation suites (eval/dsmr.py, geometry.py,
sat_utils.py, lpips.py, cmmd.py, photometric.py) against the JAX package.

Tolerances, and why:
  * dsmr, geometry, sat_utils, patchify and the Frechet distance are the
    JAX package's numpy code: exact (NaNs in the same places);
  * LPIPS alex / vgg at the published channel widths, 64 px, against JAX
    and against a torchvision-layout oracle written out below: 1e-5
    relative (float32 convolutions, different summation orders);
  * the LPIPS gradient: ``torch.autograd.gradcheck`` in float64;
  * ``mmd`` and ``paired_metrics`` (PSNR, SSIM, LPIPS): 1e-5 relative
    (the CMMD of unit-norm embeddings: 1e-3 absolute, see its test);
  * ``ClipEmbedder`` on a small CLIP vision tower built in code: 1e-6
    against the JAX package's class on the same model.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from torch import nn

import jax.numpy as jnp

from skyfall_gs_tpu.eval import cmmd as jcmmd
from skyfall_gs_tpu.eval import dsmr as jdsmr
from skyfall_gs_tpu.eval import geometry as jgeo
from skyfall_gs_tpu.eval import lpips as jlpips
from skyfall_gs_tpu.eval import photometric as jphoto
from skyfall_gs_tpu.eval import sat_utils as jsat
from skyfall_gs_tpu_torch.eval import cmmd as tcmmd
from skyfall_gs_tpu_torch.eval import dsmr as tdsmr
from skyfall_gs_tpu_torch.eval import geometry as tgeo
from skyfall_gs_tpu_torch.eval import lpips as tlpips
from skyfall_gs_tpu_torch.eval import photometric as tphoto
from skyfall_gs_tpu_torch.eval import sat_utils as tsat

torch.set_num_threads(1)

# torchvision layouts: (conv index, out channels, in channels, kernel)
ALEX = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
        (10, 256, 256, 3))
VGG = ((0, 64, 3, 3), (2, 64, 64, 3), (5, 128, 64, 3), (7, 128, 128, 3),
       (10, 256, 128, 3), (12, 256, 256, 3), (14, 256, 256, 3), (17, 512, 256, 3),
       (19, 512, 512, 3), (21, 512, 512, 3), (24, 512, 512, 3), (26, 512, 512, 3),
       (28, 512, 512, 3))
TAP_WIDTHS = {"alex": (64, 192, 384, 256, 256), "vgg": (64, 128, 256, 512, 512)}


def lpips_state(net: str, seed: int = 0):
    """Random torchvision-layout backbone and lpips-head state dicts (numpy)
    at the published widths: He-scaled convolutions, non-negative heads."""
    rng = np.random.default_rng(seed)
    backbone = {}
    for i, o, c, k in (ALEX if net == "alex" else VGG):
        backbone[f"{i}.weight"] = (rng.normal(size=(o, c, k, k))
                                   * np.sqrt(2.0 / (c * k * k))).astype(np.float32)
        backbone[f"{i}.bias"] = rng.normal(0, 0.05, o).astype(np.float32)
    lin = {f"lin{t}.model.1.weight": np.abs(rng.normal(0, 0.1, (1, c, 1, 1)))
           .astype(np.float32) for t, c in enumerate(TAP_WIDTHS[net])}
    return backbone, lin


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------------------------
# dsmr, geometry, sat_utils: the JAX test classes on the port, and twins
# ----------------------------------------------------------------------------

class TestDSMR:
    def test_recovers_known_shift(self, rng):
        base = ndi.gaussian_filter(rng.normal(0, 1, (160, 160)), 3)
        dx, dy = 4, -3
        v = np.roll(np.roll(base, dy, axis=0), dx, axis=1) * 2.0 + 5.0
        got = tdsmr.compute_shift_arrays(base, v, scaling=True)
        assert (got[0], got[1]) == (dx, dy)
        assert got[2] == pytest.approx(0.5, rel=0.05)
        assert got == jdsmr.compute_shift_arrays(base, v, scaling=True)

    def test_apply_shift_inverts(self, rng):
        u = ndi.gaussian_filter(rng.normal(0, 1, (64, 64)), 2)
        v = np.roll(u, 2, axis=1) * 3.0 - 1.0
        dx, dy, a, b = tdsmr.compute_shift_arrays(u, v)
        reg = tdsmr.apply_shift_arrays(v, dx, dy, a, b)
        m = np.isfinite(reg)
        assert np.abs(reg[m] - u[m]).mean() < 0.05
        np.testing.assert_array_equal(reg, jdsmr.apply_shift_arrays(v, dx, dy, a, b))

    def test_downsample_nan_aware(self):
        u = np.ones((1, 4, 4))
        u[0, 0, 0] = np.nan
        d = tdsmr.downsample2x(u)
        assert d.shape == (1, 2, 2)
        np.testing.assert_allclose(d[0], 1.0)

    def test_twins_on_nan_patches(self, rng):
        u = ndi.gaussian_filter(rng.normal(0, 1, (3, 130, 120)), 2)
        u[:, rng.uniform(size=(130, 120)) < 0.1] = np.nan
        v = np.roll(u, (1, -2), axis=(1, 2)) + 0.5
        np.testing.assert_array_equal(tdsmr.downsample2x(u), jdsmr.downsample2x(u))
        for args in ((0, 0), (3, -2), (200, 0)):
            np.testing.assert_array_equal(tdsmr.mean_std(u, v, *args),
                                          jdsmr.mean_std(u, v, *args))
            assert tdsmr.ncc(u, v, *args) == jdsmr.ncc(u, v, *args) or \
                np.isnan(tdsmr.ncc(u, v, *args))
        assert tdsmr.recursive_ncc(u, v) == jdsmr.recursive_ncc(u, v)
        assert tdsmr.ncc(np.ones((8, 8)), np.ones((8, 8))) == -np.inf


class TestGeometry:
    def test_latlon_to_utm_known_points(self):
        e, n, zone, letter = tgeo.latlon_to_utm(40.71435, -74.00597)  # NYC
        assert (zone, letter) == (18, "T")
        assert e == pytest.approx(583960, abs=2)
        assert n == pytest.approx(4507523, abs=2)
        e, n, zone, letter = tgeo.latlon_to_utm(47.9941214, 7.8509671)  # Freiburg
        assert (zone, letter) == (32, "T")
        assert e == pytest.approx(414278, abs=2)
        assert n == pytest.approx(5316286, abs=2)
        e, n, zone, _ = tgeo.latlon_to_utm(0.0, 3.0)
        assert (e, n, zone) == (500000.0, 0.0, 31)
        for lat, lon in ((-33.9, 151.2), (30.35, -81.66), (85.0, 0.0), (-79.9, -179.9)):
            assert tgeo.latlon_to_utm(lat, lon) == jgeo.latlon_to_utm(lat, lon)

    def test_backprojection_roundtrip(self):
        h = w = 16
        depth = np.full((h, w), 10.0)
        pts = tgeo.depth_to_point_cloud(depth, np.eye(3), np.zeros(3),
                                        focal_x=20.0, focal_y=20.0)
        assert pts.shape == (h * w, 3)
        np.testing.assert_allclose(pts[:, 2], 10.0)
        center = pts.reshape(h, w, 3)[h // 2, w // 2]
        assert abs(center[0]) < 10 / 20 * 1.1

    def test_dsm_rasterize_max(self):
        pts = np.array([[0.5, 0.5, 1.0], [0.5, 0.5, 3.0], [2.5, 1.5, 2.0]])
        dsm = tgeo.rasterize_dsm(pts, 0.0, 0.0, 4, 1.0)
        assert dsm[3, 0] == 3.0
        assert dsm[2, 2] == 2.0
        assert np.isnan(dsm[0, 0])

    def test_metrics(self):
        gt = np.array([[1.0, 2.0], [3.0, np.nan]])
        pred = np.array([[1.5, 2.0], [np.nan, 4.0]])
        m = tgeo.compute_dsm_metrics(pred, gt)
        assert m["mae"] == pytest.approx(0.25)
        assert m["completeness"] == pytest.approx(2 / 3)

    def test_register_and_score(self, rng):
        gt = ndi.gaussian_filter(rng.normal(0, 5, (128, 128)), 4) + 100
        pred = np.roll(gt, 2, axis=1) + 7.0
        reg, shift = tgeo.register_dsms(pred, gt)
        m = tgeo.compute_dsm_metrics(reg, gt)
        assert m["mae"] < 0.2
        assert abs(shift["b"] + 7.0) < 0.5

    def test_enu_to_utm_shift(self):
        pts = np.array([[10.0, 20.0, 5.0]])
        out = tgeo.enu_to_utm(pts, [30.0, -81.0, 2.0])
        e, n, _, _ = tgeo.latlon_to_utm(30.0, -81.0)
        np.testing.assert_allclose(out[0], [e + 10, n + 20, 7.0])

    def test_pipeline_twins(self, rng, tmp_path):
        """Backprojection, rasterization, water-masked registration and the
        whole evaluate_depth_views chain: the same numbers as JAX."""
        h, w = 40, 48
        th = 0.3
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        views = []
        for i in range(2):
            depth = 50.0 + ndi.gaussian_filter(rng.normal(0, 3, (h, w)), 2)
            depth[rng.uniform(size=(h, w)) < 0.05] = np.nan
            mask = (rng.uniform(size=(h, w)) > 0.1).astype(np.float32)
            views.append((depth, R, rng.normal(0, 5, 3), 40.0, 41.0, 0.02 * i, -0.01, mask))
        origin = [30.35, -81.66, 3.0]
        for v in views:
            np.testing.assert_array_equal(tgeo.depth_to_point_cloud(*v, enu_origin=origin),
                                          jgeo.depth_to_point_cloud(*v, enu_origin=origin))
        cloud = tgeo.depth_to_point_cloud(*views[0])
        roi = (float(cloud[:, 0].min()), float(cloud[:, 1].min()), 64, 0.75)
        dsm = tgeo.rasterize_dsm(cloud, *roi)
        np.testing.assert_array_equal(dsm, jgeo.rasterize_dsm(cloud, *roi))
        gt = np.where(np.isnan(dsm), np.nan, ndi.gaussian_filter(np.nan_to_num(dsm), 1)) + 0.3
        water = rng.uniform(size=gt.shape) > 0.2
        got, want = tgeo.register_dsms(dsm, gt, water), jgeo.register_dsms(dsm, gt, water)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert tgeo.compute_dsm_metrics(got[0], gt, water) == \
            jgeo.compute_dsm_metrics(want[0], gt, water)
        got = tgeo.evaluate_depth_views(views, gt, roi, water_mask=water)
        assert got == jgeo.evaluate_depth_views(views, gt, roi, water_mask=water)
        np.savetxt(tmp_path / "roi.txt", [roi[0], roi[1], roi[2], roi[3]])
        assert tgeo.read_roi_metadata(str(tmp_path / "roi.txt")) == \
            jgeo.read_roi_metadata(str(tmp_path / "roi.txt"))


class TestSatUtils:
    def test_ecef_roundtrip(self):
        lat, lon, alt = 30.35, -81.66, 25.0
        x, y, z = tsat.latlon_to_ecef(lat, lon, alt)
        la2, lo2, al2 = tsat.ecef_to_latlon(x, y, z)
        assert float(la2) == pytest.approx(lat, abs=1e-7)
        assert float(lo2) == pytest.approx(lon, abs=1e-7)
        assert float(al2) == pytest.approx(alt, abs=1e-3)

    def test_rpc_rescale(self):
        rpc = tsat.RPCModel(row_scale=100.0, row_offset=50.0, col_scale=200.0,
                            col_offset=100.0)
        r2 = tsat.rescale_rpc(rpc, 0.5)
        assert r2.row_scale == 50.0 and r2.col_offset == 50.0
        assert rpc.row_scale == 100.0
        s, o = tsat.rpc_scaling_params([2.0, 10.0])
        assert (s, o) == (4.0, 6.0)

    def test_dsm_pointwise_diff(self, rng):
        gt = ndi.gaussian_filter(rng.normal(0, 5, (120, 120)), 4) + 30
        pred = np.roll(gt, 3, axis=1) - 2.0
        reg, err, info = tsat.dsm_pointwise_diff(pred, gt)
        assert info["mae"] < 0.2
        assert err.shape == gt.shape

    def test_twins(self, rng):
        lat = rng.uniform(-60, 60, 7)
        lon = rng.uniform(-180, 180, 7)
        alt = rng.uniform(-10, 500, 7)
        for a, b in zip(tsat.latlon_to_ecef(lat, lon, alt), jsat.latlon_to_ecef(lat, lon, alt)):
            np.testing.assert_array_equal(a, b)
        xyz = jsat.latlon_to_ecef(lat, lon, alt)
        for a, b in zip(tsat.ecef_to_latlon(*xyz), jsat.ecef_to_latlon(*xyz)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tsat.utm_from_latlon(lat[:3], lon[:3] * 0 + 7.0),
                        jsat.utm_from_latlon(lat[:3], lon[:3] * 0 + 7.0)):
            np.testing.assert_array_equal(a, b)
        dsm = rng.normal(20, 3, (50, 60))
        roi = (500010.0, 3000020.0, 32, 1.5)
        np.testing.assert_array_equal(
            tsat.crop_to_roi(dsm, (500000.0, 3000080.0), 1.0, roi),
            jsat.crop_to_roi(dsm, (500000.0, 3000080.0), 1.0, roi))
        gt = ndi.gaussian_filter(rng.normal(0, 5, (70, 70)), 3)
        water = rng.uniform(size=gt.shape) > 0.1
        got = tsat.dsm_pointwise_diff(np.roll(gt, 2, axis=0) + 1.0, gt, water)
        want = jsat.dsm_pointwise_diff(np.roll(gt, 2, axis=0) + 1.0, gt, water)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


# ----------------------------------------------------------------------------
# LPIPS
# ----------------------------------------------------------------------------

def torchvision_features(net: str, backbone) -> nn.Sequential:
    """``torchvision.models.alexnet().features`` / ``vgg16().features``,
    written out layer by layer (indices as torchvision numbers them)."""
    if net == "alex":
        layers = [nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
                  nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
                  nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
                  nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
                  nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2)]
    else:
        layers, c = [], 3
        for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
                  512, 512, 512, "M"):
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, v, 3, padding=1), nn.ReLU()]
                c = v
    seq = nn.Sequential(*layers)
    seq.load_state_dict({k: torch.from_numpy(v) for k, v in backbone.items()})
    return seq


def lpips_oracle(net: str, backbone, lin, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The lpips package's LPIPS: ScalingLayer, torchvision feature slices
    (alex [0:2], [2:5], [5:8], [8:10], [10:12]; vgg [0:4], [4:9], [9:16],
    [16:23], [23:30]), normalize_tensor, NetLinLayer heads, spatial_average,
    summed over the taps.  a, b: (B, 3, H, W) in [-1, 1]."""
    feats = torchvision_features(net, backbone)
    cuts = (0, 2, 5, 8, 10, 12) if net == "alex" else (0, 4, 9, 16, 23, 30)
    shift = torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None]
    scale = torch.tensor([0.458, 0.448, 0.450])[None, :, None, None]
    ha, hb = (a - shift) / scale, (b - shift) / scale
    total = 0.0
    for t in range(5):
        stage = feats[cuts[t]:cuts[t + 1]]
        ha, hb = stage(ha), stage(hb)
        na = ha / (torch.sqrt(torch.sum(ha ** 2, dim=1, keepdim=True)) + 1e-10)
        nb = hb / (torch.sqrt(torch.sum(hb ** 2, dim=1, keepdim=True)) + 1e-10)
        head = nn.Sequential(nn.Dropout(), nn.Conv2d(TAP_WIDTHS[net][t], 1, 1, bias=False))
        head.load_state_dict({"1.weight": torch.from_numpy(lin[f"lin{t}.model.1.weight"])})
        head.eval()
        total = total + head((na - nb) ** 2).mean([2, 3], keepdim=True)
    return total[:, 0, 0, 0]


@pytest.fixture(scope="module", params=["alex", "vgg"])
def lpips_pair(request):
    net = request.param
    backbone, lin = lpips_state(net)
    return (net, backbone, lin, tlpips.LPIPS(net, backbone, lin, device="cpu"),
            jlpips.LPIPS(net, backbone, lin))


def test_lpips_matches_jax_and_the_torchvision_oracle(lpips_pair):
    net, backbone, lin, port, jax_lp = lpips_pair
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    got = port.score(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax_lp._jitted(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2,) and float(got.min()) > 0
    assert rel(got, want) <= 1e-5, rel(got, want)
    with torch.no_grad():
        oracle = lpips_oracle(net, backbone, lin, torch.from_numpy(a).permute(0, 3, 1, 2),
                              torch.from_numpy(b).permute(0, 3, 1, 2))
    assert rel(got.detach(), oracle) <= 1e-5, rel(got.detach(), oracle)
    # The float interface on (H, W, 3) images in [0, 1].
    img0, img1 = (a[0] + 1) / 2, (b[0] + 1) / 2
    v = port(img0, img1)
    assert isinstance(v, float) and v == pytest.approx(jax_lp(img0, img1), rel=1e-5)
    assert port(img0, img0) == 0.0


def test_lpips_gradient_gradcheck(lpips_pair):
    """d score / d input in float64 (vgg on a 16 px image; alex needs 64 px
    for its stride-4 stem and two 3x3/2 pools)."""
    net, _, _, port, _ = lpips_pair
    size = 16 if net == "vgg" else 64
    lp = tlpips.LPIPS(net, *lpips_state(net), device="cpu").double()
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3))).requires_grad_(True)
    b = torch.from_numpy(rng.uniform(-1, 1, (1, size, size, 3)))
    assert torch.autograd.gradcheck(lambda x: lp.score(x, b), (a,), fast_mode=True)
    assert not any(t.requires_grad for t in port.buffers())


def test_lpips_from_files_and_local_packages(tmp_path, monkeypatch):
    backbone, lin = lpips_state("alex", seed=1)
    torch.save({k: torch.from_numpy(v) for k, v in backbone.items()}, tmp_path / "b.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, tmp_path / "l.pth")
    lp = tlpips.lpips_from_torch_files(str(tmp_path / "b.pth"), str(tmp_path / "l.pth"),
                                       device="cpu")
    rng = np.random.default_rng(2)
    a, b = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    assert lp(a, b) == tlpips.LPIPS("alex", backbone, lin, device="cpu")(a, b)
    with pytest.raises(RuntimeError, match="unavailable locally"):
        tlpips.lpips_from_local_packages("vgg", device="cpu")
    with pytest.raises(RuntimeError, match="weights"):
        tlpips.LPIPS("alex", device="cpu")


# ----------------------------------------------------------------------------
# cmmd and photometric
# ----------------------------------------------------------------------------

class TestMMD:
    def test_identical_sets_zero(self, rng):
        x = rng.normal(size=(64, 16)).astype(np.float32)
        assert float(tcmmd.mmd(x, x)) == pytest.approx(0.0, abs=1e-3)

    def test_separated_sets_positive(self, rng):
        x = rng.normal(size=(64, 16)).astype(np.float32)
        assert float(tcmmd.mmd(x, x + 3.0)) > 10.0

    def test_matches_jax_and_reference_formula(self, rng):
        x = rng.normal(size=(20, 8))
        y = rng.normal(size=(30, 8)) + 0.3
        d2 = lambda a, b: ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)  # noqa: E731
        k = lambda a, b: np.exp(-d2(a, b) / 200.0).mean()                 # noqa: E731
        ref = 1000.0 * (k(x, x) + k(y, y) - 2 * k(x, y))
        got = tcmmd.mmd(torch.from_numpy(x), y)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(ref, rel=1e-3)
        want = float(jcmmd.mmd(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)))
        assert float(got) == pytest.approx(want, rel=1e-5)

    def test_frechet_zero_for_same_distribution_and_twin(self, rng):
        x = rng.normal(size=(500, 8))
        assert abs(tphoto.frechet_distance(x, x)) < 1e-6
        y = rng.normal(size=(300, 8)) * 1.3 + 0.2
        assert tphoto.frechet_distance(x, y) == jphoto.frechet_distance(x, y)


class TestPhotometric:
    def test_patchify_min_grid_and_twin(self, rng):
        img = rng.uniform(size=(1024, 1024, 3)).astype(np.float32)
        patches = tphoto.patchify(img, 512, (9, 16))
        assert len(patches) >= 9 * 16 and patches[0].shape == (512, 512, 3)
        for shape, args in (((1024, 1024, 3), (512, (9, 16))), ((600, 2000, 3), (512, (9, 16))),
                            ((700, 520, 3), (512, (3, 4))), ((100, 100, 3), (512,))):
            im = rng.uniform(size=shape).astype(np.float32)
            got, want = tphoto.patchify(im, *args), jphoto.patchify(im, *args)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert tphoto.patchify(rng.uniform(size=(100, 100, 3)), 512) == []

    def test_paired_metrics_identical(self, rng):
        f = [rng.uniform(size=(32, 32, 3)).astype(np.float32)]
        m = tphoto.paired_metrics(f, f, device="cpu")
        assert m["psnr"] > 50
        assert m["ssim"] == pytest.approx(1.0, abs=1e-4)

    def test_paired_metrics_match_jax(self, rng):
        backbone, lin = lpips_state("alex", seed=4)
        gt = [rng.uniform(size=(64, 72, 3)).astype(np.float32) for _ in range(3)]
        pred = [np.clip(g + rng.normal(0, 0.1, g.shape), 0, 1).astype(np.float32) for g in gt]
        got = tphoto.paired_metrics(gt, pred, tlpips.LPIPS("alex", backbone, lin, device="cpu"),
                                    device="cpu")
        want = jphoto.paired_metrics(gt, pred, jlpips.LPIPS("alex", backbone, lin))
        assert got.keys() == want.keys() and "lpips" in got
        for k in ("psnr", "ssim", "lpips"):
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
        for k in ("psnr_std", "ssim_std", "lpips_std"):
            assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k

    def test_summarize_and_csv(self, tmp_path):
        rows = [{"psnr": 20.0, "m": "a"}, {"psnr": 22.0, "ssim": 0.5}]
        assert tphoto.summarize(rows, ["psnr", "ssim"]) == \
            jphoto.summarize(rows, ["psnr", "ssim"])
        assert tphoto.summarize(rows, ["psnr"])["psnr"].startswith("21.0")
        tphoto.write_csv(str(tmp_path / "t.csv"), rows)
        jphoto.write_csv(str(tmp_path / "j.csv"), rows)
        assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


@pytest.fixture(scope="module")
def clip_parts():
    from transformers import CLIPImageProcessor, CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(0)
    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=56, patch_size=14,
                           projection_dim=16)
    model = CLIPVisionModelWithProjection(cfg).eval()
    proc = CLIPImageProcessor(size={"shortest_edge": 56},
                              crop_size={"height": 56, "width": 56})
    return model, proc


def test_clip_embedder_and_distribution_metrics_match_jax(clip_parts, rng):
    model, proc = clip_parts
    port = tcmmd.ClipEmbedder(device="cpu", model=model, processor=proc)
    ref = object.__new__(jcmmd.ClipEmbedder)     # the JAX class on the same built model
    ref.model, ref.processor, ref.device = model, proc, "cpu"
    imgs = [rng.uniform(size=(70, 90, 3)).astype(np.float32) for _ in range(5)]
    got, want = port(imgs, batch_size=2), ref(imgs, batch_size=2)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    a = [rng.uniform(size=(80, 96, 3)).astype(np.float32) for _ in range(2)]
    b = [np.clip(f + 0.2, 0, 1).astype(np.float32) for f in a]
    kw = dict(patch_size=48, min_patches=(2, 3))
    got = tphoto.distribution_metrics(a, b, port, device="cpu", **kw)
    want = jphoto.distribution_metrics(a, b, ref, **kw)
    assert got["clip_fid"] == pytest.approx(want["clip_fid"], rel=1e-5)
    # The CMMD of unit-norm embeddings is 1000 x a difference of float32
    # kernel means near 1, so either package's value carries ~1e-4 of
    # rounding: both are held to the float64 formula within 1e-3.
    x, y = port([p for f in a for p in tphoto.patchify(f, **kw)]), \
        port([p for f in b for p in tphoto.patchify(f, **kw)])
    d2 = lambda u, v: ((u[:, None, :] - v[None, :, :]) ** 2).sum(-1)  # noqa: E731
    k = lambda u, v: np.exp(-d2(u, v) / 200.0).mean()                  # noqa: E731
    x, y = x.astype(np.float64), y.astype(np.float64)
    exact = 1000.0 * (k(x, x) + k(y, y) - 2 * k(x, y))
    for v in (got["cmmd"], want["cmmd"]):
        assert v == pytest.approx(exact, abs=1e-3)
    assert tcmmd.compute_cmmd(a, b, port, device="cpu") == pytest.approx(
        jcmmd.compute_cmmd(a, b, ref), abs=1e-3)


def test_clip_embedder_without_local_weights_raises(monkeypatch):
    def no_network(*args, **kwargs):
        raise OSError("no network in this test")

    monkeypatch.setattr("socket.socket.connect", no_network)
    with pytest.raises(RuntimeError, match="not available locally"):
        tcmmd.ClipEmbedder("no-such-org/no-such-clip-model", device="cpu")
