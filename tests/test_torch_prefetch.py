"""The port's FramePrefetcher (frontend/prefetch.py): tests/test_prefetch.py's
four ordering, flush and depth cases on the port's copy, and the port's CPU
extractor through FramePrefetcher(batch=4, depth=2) against extract() one
frame at a time on 6 frames (the tail batch padded): bit-equal keypoints,
scores, edges, edge scores, colines and descriptors."""

import numpy as np
import pytest
import torch

from ppg_slam_tpu_torch.frontend import PPGExtractor
from ppg_slam_tpu_torch.frontend.prefetch import FramePrefetcher
from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under a parallel test run, torch's intra-op pool only oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeHandle:
    def __init__(self, imgs):
        self.imgs = imgs

    def result(self):
        return [int(im[0, 0]) for im in self.imgs]  # "features" = frame id


class _FakeExtractor:
    def __init__(self):
        self.batches = []

    def extract_batch_async(self, imgs):
        self.batches.append(len(imgs))
        return _FakeHandle(imgs)


def _img(i):
    return np.full((2, 2), i, np.uint8)


def test_in_order_delivery():
    ex = _FakeExtractor()
    pf = FramePrefetcher(ex, batch=4, depth=2)
    out = []
    for i in range(10):
        pf.feed(_img(i))
        if i >= 3:
            out.append(pf.get())
    while len(out) < 10:
        out.append(pf.get())
    assert out == list(range(10))
    assert all(b == 4 for b in ex.batches)


def test_flush_pads_and_trims():
    ex = _FakeExtractor()
    pf = FramePrefetcher(ex, batch=4, depth=2)
    for i in range(6):  # 1 full batch + 2 staged
        pf.feed(_img(i))
    got = [pf.get() for _ in range(6)]
    assert got == list(range(6))
    assert ex.batches == [4, 4]  # tail batch padded to 4


def test_feed_after_flush_stays_aligned():
    ex = _FakeExtractor()
    pf = FramePrefetcher(ex, batch=4, depth=2)
    for i in range(2):
        pf.feed(_img(i))
    assert [pf.get() for _ in range(2)] == [0, 1]  # forces a flush
    for i in range(2, 7):
        pf.feed(_img(i))
    assert [pf.get() for _ in range(5)] == [2, 3, 4, 5, 6]


def test_depth_bounds_inflight():
    ex = _FakeExtractor()
    pf = FramePrefetcher(ex, batch=2, depth=2)
    for i in range(20):
        pf.feed(_img(i))
    assert len(ex.batches) == 2  # window full: rest stays staged
    assert pf.get() == 0
    assert len(ex.batches) >= 3  # consuming refills the window
    with pytest.raises(RuntimeError, match="feed"):
        FramePrefetcher(ex).get()


def _frames(n, h=128, w=160, seed=4):
    """Grid, bars and noise, shifted a little each frame."""
    rng = np.random.RandomState(seed)
    base = np.full((h, w + 4 * n), 110, np.int32)
    for k in range(1, 8):
        base[:, k * 23 + 3 * k * k % 17] = 230
    for k in range(1, 5):
        base[k * 27, :] = 20
    out = []
    for i in range(n):
        img = base[:, 3 * i:3 * i + w] + rng.randint(-12, 12, (h, w))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def cpu_extractor():
    cam = CameraModel(kind=CAM_PINHOLE, fx=120.0, fy=120.0, cx=80.0,
                      cy=64.0, dist=(0.0, 0.0, 0.0, 0.0), width=160,
                      height=128)
    return PPGExtractor(cam, device="cpu")


def test_prefetched_features_equal_extract(cpu_extractor):
    frames = _frames(6)
    pf = FramePrefetcher(cpu_extractor, batch=4, depth=2)
    for f in frames:
        pf.feed(f)
    got = [pf.get() for _ in frames]
    assert pf.n_dispatches == 2  # the tail batch of 2 padded to 4
    for g, f in zip(got, frames):
        ref = cpu_extractor.extract(f)
        assert g.n_kp == ref.n_kp and ref.n_kp > 10
        for name in ("kp_pos", "kp_pos_un", "kp_score", "kp_out", "edges",
                     "edge_score", "colines", "desc"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(ref, name), err_msg=name)
        assert g.connected == ref.connected
    assert any(len(g.edges) for g in got)
