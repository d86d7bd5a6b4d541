"""The last public names of the JAX front-end that the port lacked, each
held against its ppg_slam_tpu function on the same seeded numpy inputs:
ops.heatmap.remap_heatmap, PPGExtractor.remap_heat_host (through the
native library and through its numpy spec), native.pair_geometry_native,
ops.nms.nms_keypoints_scan, PPGExtractor.fetch_desc_strided and
PPGExtractor.warmup. (ops.device_match.match_bytes and
gated_match_batch_packed: tests/test_torch_device_match.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ppg_slam_tpu.native as jnative
from ppg_slam_tpu.frontend import PPGExtractor as JaxExtractor
from ppg_slam_tpu.geometry.cameras import CAM_FISHEYE, CAM_PINHOLE
from ppg_slam_tpu.geometry.cameras import CameraModel as JaxCamera
from ppg_slam_tpu.ops import heatmap as jheat
from ppg_slam_tpu.ops import nms as jnms

import ppg_slam_tpu_torch.native as pnative
from ppg_slam_tpu_torch.frontend import PPGExtractor
from ppg_slam_tpu_torch.geometry.cameras import CameraModel
from ppg_slam_tpu_torch.ops import heatmap as pheat
from ppg_slam_tpu_torch.ops import nms as pnms

# TUM-VI's k1..k4 at a small size (tests/test_torch_extractor.py's camera)
KB8 = dict(kind=CAM_FISHEYE, fx=150.0, fy=150.0, cx=127.5, cy=128.4,
           dist=(0.003482389402, 0.000715034845, -0.002053236141,
                 0.000202936736), width=256, height=256)
PINHOLE = dict(kind=CAM_PINHOLE, fx=100.0, fy=100.0, cx=80.0, cy=64.0,
               dist=(0.0, 0.0, 0.0, 0.0), width=160, height=128)
# bilinear taps of one map: the XLA and PyTorch sums may round apart
REMAP_ATOL = 1e-6


@pytest.fixture(scope="module")
def kb8_pair():
    return (JaxExtractor(JaxCamera(**KB8)),
            PPGExtractor(CameraModel(**KB8), device="cpu"))


def _heat(h, w, seed=3):
    rng = np.random.RandomState(seed)
    heat = rng.rand(h, w).astype(np.float32)
    heat[rng.rand(h, w) < 0.5] = 0.0
    return heat


def test_remap_heatmap_matches_reference():
    cam = CameraModel(**KB8)
    rmap = cam.undistort_rectify_map()
    heat = _heat(cam.height, cam.width)
    ref = np.asarray(jheat.remap_heatmap(jnp.asarray(heat), jnp.asarray(rmap)))
    got = pheat.remap_heatmap(torch.from_numpy(heat),
                              torch.from_numpy(rmap)).numpy()
    assert np.count_nonzero(ref) > 0.3 * ref.size
    np.testing.assert_allclose(got, ref, atol=REMAP_ATOL, rtol=0)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_remap_heat_host_matches_reference(kb8_pair, native, monkeypatch):
    jex, pex = kb8_pair
    if native:
        assert jnative.get_lib() is not None and pnative.get_lib() is not None
    else:  # the spec each package falls back to without its library
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(pnative, "get_lib", lambda: None)
    # the two packages' undistortion maps agree to f32 round-off
    np.testing.assert_allclose(pex._remap_xy, jex._remap_xy, atol=1e-3,
                               rtol=0)
    heat = _heat(KB8["height"], KB8["width"])
    ref = jex.remap_heat_host(heat)
    got = pex.remap_heat_host(heat)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # on one map, the native library and the spec agree with each other
    # and with the device remap
    from ppg_slam_tpu_torch.frontend.graph_build import remap_np

    spec = remap_np(heat, pex._remap_xy)
    np.testing.assert_allclose(got, spec, atol=REMAP_ATOL, rtol=0)
    dev = pheat.remap_heatmap(torch.from_numpy(heat),
                              torch.from_numpy(pex._remap_xy)).numpy()
    np.testing.assert_allclose(got, dev, atol=REMAP_ATOL, rtol=0)


def test_remap_heat_host_is_identity_without_distortion():
    pex = PPGExtractor(CameraModel(**PINHOLE), device="cpu")
    heat = _heat(PINHOLE["height"], PINHOLE["width"])
    assert pex.remap_heat_host(heat) is heat


def test_pair_geometry_native_matches_reference():
    rng = np.random.RandomState(7)
    kp = rng.uniform(0, 300, (97, 2)).astype(np.float32)
    ref = jnative.pair_geometry_native(kp)
    got = pnative.pair_geometry_native(kp)
    for g, r in zip(got, ref):  # one C++ source, compiled in each package
        np.testing.assert_array_equal(g, r)
    monkey = pnative.get_lib
    try:
        pnative.get_lib = lambda: None
        assert pnative.pair_geometry_native(kp) is None
    finally:
        pnative.get_lib = monkey


def _junction_map(seed, h=64, w=80, levels=None):
    rng = np.random.RandomState(seed)
    j = (rng.rand(h, w) ** 6).astype(np.float32)
    if levels:  # quantized scores: equal scores inside one NMS window
        j = np.floor(j * levels) / levels
    return j


@pytest.mark.parametrize("seed,levels,max_kp", [(0, None, 100), (1, 32, 100),
                                                (2, 8, 40)])
def test_nms_keypoints_scan_matches_reference(seed, levels, max_kp):
    j = _junction_map(seed, levels=levels)
    ref = [np.asarray(a) for a in jnms.nms_keypoints_scan(jnp.asarray(j),
                                                          max_kp=max_kp)]
    got = [a.numpy() for a in pnms.nms_keypoints_scan(torch.from_numpy(j),
                                                      max_kp=max_kp)]
    assert ref[2].sum() > 10
    for name, g, r in zip(("xy", "score", "valid"), got, ref):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    if levels is None:  # distinct scores: the fast path is the scan
        fast = [a.numpy() for a in pnms.nms_keypoints(torch.from_numpy(j),
                                                      max_kp=max_kp)]
        for g, f in zip(got, fast):
            np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_fetch_desc_strided_matches_reference(stride):
    rng = np.random.RandomState(11)
    d = rng.randn(5, 500, 256).astype(np.float32)
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    d[1, 400:] = 0.0  # padding rows
    jex = JaxExtractor(JaxCamera(**PINHOLE), desc_transfer="device")
    pex = PPGExtractor(CameraModel(**PINHOLE), desc_transfer="device",
                       device="cpu")
    ref = np.asarray(jex.fetch_desc_strided(jnp.asarray(d), stride))
    got = pex.fetch_desc_strided(torch.from_numpy(d), stride)
    assert isinstance(got, np.ndarray)
    assert got.shape == ref.shape == (len(range(0, 5, stride)), 500 * 258)
    np.testing.assert_array_equal(got, ref)


def test_warmup_extracts_what_the_reference_does(monkeypatch):
    """Both packages' warmup hand one all-ones frame of the camera's size to
    extract(), and the port's frame gives the reference's keypoints."""
    seen = {}
    jex = JaxExtractor(JaxCamera(**PINHOLE))
    pex = PPGExtractor(CameraModel(**PINHOLE), device="cpu")
    for side, ex in (("jax", jex), ("port", pex)):
        orig = ex.extract

        def spy(img, side=side, orig=orig):
            seen.setdefault(side, []).append(np.array(img))
            return orig(img)

        monkeypatch.setattr(ex, "extract", spy)
        assert ex.warmup() is None
    (jimg,), (pimg,) = seen["jax"], seen["port"]
    assert pimg.dtype == jimg.dtype == np.uint8
    np.testing.assert_array_equal(pimg, jimg)
    assert pimg.shape == (PINHOLE["height"], PINHOLE["width"])
    np.testing.assert_array_equal(pex.extract(pimg).kp_pos,
                                  jex.extract(jimg).kp_pos)
