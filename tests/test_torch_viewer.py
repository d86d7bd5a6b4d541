"""The port's offline viewer (viz/render.py numpy rasterizer + viz/viewer.py)
against the JAX package's PIL viewer.

One port pipeline run (the synthetic sequence through Tracking and
LocalMapping, 48 frames, IMU init at 2 s) feeds both viewers the same
update_frame calls, so both draw the same map with the same fading
stamps. Held:
- `look_at` / `Canvas3D.project` equal to the JAX package's (f64 inputs,
  1e-12; they are copies);
- the primitives `draw_map` and `draw_frame` draw (segments, points,
  colours, widths, alphas) equal to the JAX viewer's: exactly for the map's
  canvas calls, as sets for the frame overlay's 2-D calls (the port batches
  what PIL draws one by one);
- the rasterized images against the JAX package's PIL images, text bar
  excluded: the non-background masks overlap at IoU >= MIN_IOU;
- the fading, the step gate, the top view after IMU init, and the Tracking
  hook writing PNGs.
"""

import os

import numpy as np
import pytest
import torch

import PIL.ImageDraw
import ppg_slam_tpu.viz.render as jrender
from ppg_slam_tpu.viz import Viewer as JViewer

import ppg_slam_tpu_torch.viz.render as prender
import ppg_slam_tpu_torch.viz.viewer as pviewer
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.datasets import read_gray
from ppg_slam_tpu_torch.pipeline import LocalMapping, Tracking
from ppg_slam_tpu_torch.pipeline.tracking import OK
from ppg_slam_tpu_torch.viz import Canvas3D, Viewer, look_at

N_FRAMES = 48
RENDER_EVERY = 20
# measured on this fixture: 0.797 (map), 0.831 (top view), 0.846 (frame
# overlay); the two rasterizers differ on wide lines and DDA/Bresenham ties
MIN_IOU = 0.75


@pytest.mark.parametrize("eye,target,up", [
    ((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    ((1.5, -2.0, 3.0), (0.2, 0.1, -0.3), (0.0, 0.0, 1.0)),
    ((0.0, 4.0, 0.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),  # up || forward
    ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (0.0, -1.0, 0.0)),  # eye == target
])
def test_look_at_and_project_equal_reference(eye, target, up):
    R, t = look_at(np.array(eye), np.array(target), np.array(up))
    Rj, tj = jrender.look_at(np.array(eye), np.array(target), np.array(up))
    np.testing.assert_allclose(R.astype(np.float64), Rj, atol=1e-12, rtol=0)
    np.testing.assert_allclose(t.astype(np.float64), tj, atol=1e-12, rtol=0)
    pts = np.random.RandomState(1).randn(64, 3) * 3
    c, cj = Canvas3D(320, 240, focal=200.0), jrender.Canvas3D(320, 240,
                                                              focal=200.0)
    c.set_view(np.array(eye), np.array(target), np.array(up))
    cj.set_view(np.array(eye), np.array(target), np.array(up))
    (uv, ok), (uvj, okj) = c.project(pts), cj.project(pts)
    np.testing.assert_array_equal(ok, okj)
    np.testing.assert_allclose(uv.astype(np.float64), uvj, atol=1e-12,
                               rtol=0)


def test_canvas_draws_points_and_lines():
    c = Canvas3D(128, 128, focal=100.0)
    c.set_view(np.array([0.0, 0.0, -3.0]), np.zeros(3),
               np.array([0.0, -1.0, 0.0]))
    c.lines(np.array([[-0.5, 0.0, 0.0]]), np.array([[0.5, 0.0, 0.0]]),
            (0, 0, 255), width=2)
    c.points(np.array([[0.0, 0.0, 0.0]]), (255, 0, 0), size=4)
    a = c.array()
    assert a.shape == (128, 128, 3) and (a != 255).any()
    assert tuple(a[64, 64]) == (255, 0, 0)  # the point, over the line
    assert tuple(a[64, 50]) == (0, 0, 255)  # the line


class _Tee:
    """Hands Tracking's viewer calls to both viewers."""

    def __init__(self, *viewers):
        self.viewers = viewers

    def wait_step(self):
        for v in self.viewers:
            v.wait_step()

    def update_frame(self, *a, **kw):
        for v in self.viewers:
            v.update_frame(*a, **kw)


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("renders"))
    out_j = str(tmp_path_factory.mktemp("renders_jax"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = pwm.Map.imu_ini_time
    try:
        pwm.reset_ids()
        pwm.Map.imu_ini_time = 2.0
        seq = testing.SyntheticSequence(n_frames=N_FRAMES)
        wmap = pwm.Map(pwm.Rig(testing.CAM, freq=200.0))
        tracking = Tracking(wmap, testing.SyntheticExtractor(seq),
                            device="cpu")
        lm = LocalMapping(wmap, tracking=tracking, device="cpu")
        tracking.local_mapper = lm
        viewer = Viewer(wmap, out_dir=out, render_every=RENDER_EVERY,
                        show_graph=True)
        jviewer = JViewer(wmap, out_dir=out_j, render_every=RENDER_EVERY,
                          show_graph=True)
        tracking.viewer = _Tee(viewer, jviewer)
        last_t = -1.0
        for i in range(N_FRAMES):
            t = seq.frame_times[i]
            tracking.grab_imu(seq.imu_between(last_t, t))
            last_t = t
            tracking.grab_image(np.zeros((2, 2), np.uint8), t)
    finally:
        pwm.Map.imu_ini_time = saved
        torch.set_num_threads(n)
    return tracking, wmap, viewer, jviewer, out


def _record_canvas(monkeypatch, module):
    calls = []
    cls = module.Canvas3D
    lines, points = cls.lines, cls.points

    def rec_lines(self, a, b, color, width=1, alpha=None):
        calls.append(("lines", np.asarray(a, np.float32),
                      np.asarray(b, np.float32), tuple(color), width,
                      None if alpha is None else np.asarray(alpha)))
        lines(self, a, b, color, width=width, alpha=alpha)

    def rec_points(self, pts, color, size=2, alpha=None):
        calls.append(("points", np.asarray(pts, np.float32), None,
                      tuple(color), size,
                      None if alpha is None else np.asarray(alpha)))
        points(self, pts, color, size=size, alpha=alpha)

    monkeypatch.setattr(cls, "lines", rec_lines)
    monkeypatch.setattr(cls, "points", rec_points)
    return calls


def _mask_iou(a, b, bg):
    ma = (a != np.asarray(bg, np.uint8)).any(axis=2)
    mb = (b != np.asarray(bg, np.uint8)).any(axis=2)
    return (ma & mb).sum() / max((ma | mb).sum(), 1), ma.sum()


@pytest.mark.parametrize("top_view", [False, True])
def test_draw_map_equals_reference(tracked, monkeypatch, top_view):
    tracking, wmap, viewer, jviewer, _ = tracked
    assert tracking.state == OK and wmap.imu_initialized
    imgs, calls = {}, {}
    for side, v, mod in (("port", viewer, prender), ("jax", jviewer,
                                                     jrender)):
        with monkeypatch.context() as m:
            calls[side] = _record_canvas(m, mod)
            v.top_view = top_view
            imgs[side] = v.draw_map()
            v.top_view = False
    assert len(calls["port"]) == len(calls["jax"]) > 10
    kinds = {c[0] for c in calls["port"]}
    assert kinds == {"lines", "points"}
    for got, ref in zip(calls["port"], calls["jax"]):
        assert got[0] == ref[0] and got[3:5] == ref[3:5]
        for x, y in zip((got[1], got[2], got[5]), (ref[1], ref[2], ref[5])):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
    assert imgs["port"].shape == imgs["jax"].shape == (768, 1024, 3)
    iou, n = _mask_iou(imgs["port"], imgs["jax"], (255, 255, 255))
    assert n > 500 and iou >= MIN_IOU, iou


def _pil_frame_prims(monkeypatch):
    prims = []
    line, ellipse = PIL.ImageDraw.ImageDraw.line, PIL.ImageDraw.ImageDraw.\
        ellipse

    def rec_line(self, xy, fill=None, width=0, **kw):
        (x0, y0), (x1, y1) = xy
        prims.append(("line", round(x0, 3), round(y0, 3), round(x1, 3),
                      round(y1, 3), tuple(fill), width))
        return line(self, xy, fill=fill, width=width, **kw)

    def rec_ellipse(self, xy, fill=None, outline=None, width=1):
        x0, y0, x1, y1 = xy
        prims.append(("disc", round((x0 + x1) / 2, 3),
                      round((y0 + y1) / 2, 3), (x1 - x0) / 2,
                      tuple(fill or outline), outline is not None))
        return ellipse(self, xy, fill=fill, outline=outline, width=width)

    monkeypatch.setattr(PIL.ImageDraw.ImageDraw, "line", rec_line)
    monkeypatch.setattr(PIL.ImageDraw.ImageDraw, "ellipse", rec_ellipse)
    return prims


def _port_frame_prims(monkeypatch):
    prims = []
    draw_lines, draw_discs = pviewer.draw_lines, pviewer.draw_discs

    def rec_lines(img, a, b, cols, width=1):
        for p, q, c in zip(np.asarray(a), np.asarray(b), cols):
            prims.append(("line", round(float(p[0]), 3),
                          round(float(p[1]), 3), round(float(q[0]), 3),
                          round(float(q[1]), 3), tuple(int(v) for v in c),
                          width))
        draw_lines(img, a, b, cols, width)

    def rec_discs(img, centers, r, cols, outline=False):
        for p, c in zip(np.asarray(centers), cols):
            prims.append(("disc", round(float(p[0]), 3),
                          round(float(p[1]), 3), float(r),
                          tuple(int(v) for v in c), outline))
        draw_discs(img, centers, r, cols, outline)

    monkeypatch.setattr(pviewer, "draw_lines", rec_lines)
    monkeypatch.setattr(pviewer, "draw_discs", rec_discs)
    return prims


def test_draw_frame_equals_reference(tracked, monkeypatch):
    _, _, viewer, jviewer, _ = tracked
    with monkeypatch.context() as m:
        port_prims = _port_frame_prims(m)
        img = viewer.draw_frame()
    with monkeypatch.context() as m:
        jax_prims = _pil_frame_prims(m)
        jimg = jviewer.draw_frame()
    assert sorted(port_prims) == sorted(jax_prims)
    assert len(port_prims) > 20
    assert viewer._n_tracked == jviewer._n_tracked > 10
    assert img.shape == jimg.shape
    iou, n = _mask_iou(img[:-20], jimg[:-20], (96, 96, 96))
    assert n > 500 and iou >= MIN_IOU, iou
    bar = img[-20:]  # light text on black
    assert (bar == 0).any() and (bar > 200).any()


def test_renders_written(tracked):
    *_, out = tracked
    files = sorted(os.listdir(out))
    maps = [f for f in files if f.startswith("map_")]
    frames = [f for f in files if f.startswith("frame_")]
    assert len(maps) == len(frames) == N_FRAMES // RENDER_EVERY
    for f in maps:
        assert read_gray(os.path.join(out, f)).shape == (768, 1024)


def test_fading_monotonic(tracked):
    _, wmap, viewer, jviewer, _ = tracked
    mps = [mp for mp in wmap.all_map_points() if not mp.is_bad()]
    ages = [viewer._age(mp.mnId, "mp") for mp in mps]
    assert max(ages) > 0.5
    assert ages == [jviewer._age(mp.mnId, "mp") for mp in mps]
    assert viewer._fade(0.0) == pytest.approx(1.0)
    assert viewer._fade(10.0) == pytest.approx(0.5)
    assert viewer._fade(19.0) == pytest.approx(0.1)
    viewer.unfaded = True
    assert viewer._age(mps[0].mnId, "mp") == 0.0
    viewer.unfaded = False


def test_step_gate(tracked):
    _, _, viewer, _, _ = tracked
    viewer.step_by_step = True
    hits = []

    def hook(v):
        hits.append(1)
        v.step()

    viewer.step_hook = hook
    viewer.wait_step()          # blocks until the hook steps
    assert hits == [1]
    viewer.step()
    viewer.step_hook = lambda v: pytest.fail("step already queued")
    viewer.wait_step()          # a queued step passes at once
    viewer.step_by_step = False
    viewer.step_hook = None
