"""The port's spans (utils/profiling.py `profiler.tracing`): rows only with
tracing on, nested timers in order with their depths, one id and one depth
count per thread, reset; and the async front-end's spans
(frontend.dispatch/get/finish) through a FramePrefetcher over the CPU
extractor and through a small System run with async_frontend=True."""

import threading

import numpy as np
import pytest
import torch

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.frontend import PPGExtractor
from ppg_slam_tpu_torch.frontend.prefetch import FramePrefetcher
from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel
from ppg_slam_tpu_torch.utils import profiler
from ppg_slam_tpu_torch.utils.profiling import Profiler, now_ns

SETTINGS = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 20
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
IMU.Frequency: 200.0
IMU.IniTime: 2.0
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under a parallel test run, torch's intra-op pool only oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """The process-global profiler, emptied, with tracing on."""
    profiler.reset()
    profiler.tracing = True
    try:
        yield profiler
    finally:
        profiler.tracing = False
        profiler.reset()


def _names(spans, name):
    return [r for r in spans if r[4] == name]


def test_tracing_off_records_no_span():
    p = Profiler()
    assert p.tracing is False
    with p.timer("a"):
        with p.timer("b"):
            pass
    assert p.spans == []
    assert p.stats["a"].count == p.stats["b"].count == 1


def test_nested_timers_give_ordered_rows_with_depths():
    p = Profiler()
    p.tracing = True
    t0 = now_ns()
    with p.timer("outer"):
        with p.timer("mid"):
            with p.timer("inner"):
                pass
        with p.timer("mid"):
            pass
    t1 = now_ns()
    me = threading.get_ident()
    rows = sorted(p.spans)
    assert [(r[4], r[3]) for r in rows] == [
        ("outer", 0), ("mid", 1), ("inner", 2), ("mid", 1)]
    assert all(r[2] == me for r in rows)
    assert all(t0 <= r[0] <= r[1] <= t1 for r in rows)
    outer, mid, inner, mid2 = rows
    assert outer[0] <= mid[0] <= inner[0] <= inner[1] <= mid[1] <= mid2[0]
    assert mid2[1] <= outer[1]
    # rows go in as spans end: the innermost first
    assert [r[4] for r in p.spans] == ["inner", "mid", "mid", "outer"]
    assert p.stats["mid"].count == 2


def test_a_span_that_raises_is_recorded_and_the_depth_restored():
    p = Profiler()
    p.tracing = True
    with pytest.raises(ValueError):
        with p.timer("fails"):
            raise ValueError
    with p.timer("next"):
        pass
    assert [(r[4], r[3]) for r in p.spans] == [("fails", 0), ("next", 0)]


def test_two_threads_have_their_own_ids_and_depths():
    p = Profiler()
    p.tracing = True
    inside, done = threading.Event(), threading.Event()

    def worker():
        with p.timer("w.outer"):
            inside.set()
            with p.timer("w.inner"):
                done.wait(10)

    th = threading.Thread(target=worker)
    with p.timer("main.outer"):
        th.start()
        assert inside.wait(10)
        with p.timer("main.inner"):
            pass
        done.set()
        th.join(10)
    assert not th.is_alive()
    by = {r[4]: r for r in p.spans}
    assert by["main.outer"][2] == by["main.inner"][2] == threading.get_ident()
    assert by["w.outer"][2] == by["w.inner"][2] == th.ident
    assert th.ident != threading.get_ident()
    assert [by[n][3] for n in ("main.outer", "main.inner", "w.outer",
                               "w.inner")] == [0, 1, 0, 1]


def test_reset_clears_the_spans():
    p = Profiler()
    p.tracing = True
    with p.timer("a"):
        pass
    assert len(p.spans) == 1
    p.reset()
    assert p.spans == [] and p.stats == {}


def test_prefetcher_over_the_cpu_extractor_records_the_frontend_spans(
        traced):
    cam = CameraModel(kind=CAM_PINHOLE, fx=120.0, fy=120.0, cx=80.0,
                      cy=64.0, dist=(0.0, 0.0, 0.0, 0.0), width=160,
                      height=128)
    ex = PPGExtractor(cam, device="cpu")
    rng = np.random.RandomState(3)
    frames = [rng.randint(0, 255, (128, 160)).astype(np.uint8)
              for _ in range(3)]
    pf = FramePrefetcher(ex, batch=2, depth=1)
    for f in frames:
        pf.feed(f)
    got = [pf.get() for _ in frames]
    assert len(got) == 3 and pf.n_dispatches == 2
    spans = traced.spans
    assert len(_names(spans, "frontend.dispatch")) == 2
    assert len(_names(spans, "frontend.get")) == 3
    # four frames finished: the tail batch padded to 2
    finish = _names(spans, "frontend.finish")
    assert len(finish) == 4 and all(r[3] == 1 for r in finish)
    gets = _names(spans, "frontend.get")
    assert all(any(g[0] <= f[0] and f[1] <= g[1] for g in gets)
               for f in finish)
    # no event to wait on with a CPU extractor
    assert not _names(spans, "frontend.sync")


def test_async_system_records_frontend_spans(traced, tmp_path):
    """A small CPU System with async_frontend=True: frontend.dispatch once
    a batch, frontend.get once a frame, on the tracking thread."""
    from ppg_slam_tpu_torch.pipeline import System

    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    n, ahead = 8, 8
    saved = pwm.Map.imu_ini_time
    try:
        pwm.reset_ids()
        system = System(None, settings, async_frontend=True,
                        prefetch_batch=4, prefetch_depth=2,
                        active_loop_closing=False, device="cpu")
        seq = testing.SyntheticSequence(n_frames=n)
        system.prefetcher.ex = testing.SyntheticExtractor(seq)
        last_t, fed = -1.0, 0
        for i in range(n):
            t = seq.frame_times[i]
            while fed < min(i + 1 + ahead, n):
                system.feed_frame(np.zeros((2, 2), np.uint8))
                fed += 1
            system.track_monocular(np.zeros((2, 2), np.uint8), t,
                                   seq.imu_between(last_t, t))
            last_t = t
    finally:
        pwm.Map.imu_ini_time = saved
    spans = traced.spans
    dispatch = _names(spans, "frontend.dispatch")
    gets = _names(spans, "frontend.get")
    assert len(dispatch) == system.prefetcher.n_dispatches == n // 4
    assert len(gets) == n
    assert traced.stats["frontend.get"].count == n
    me = threading.get_ident()
    assert all(r[2] == me and r[3] == 0 for r in gets)
    assert all(r[2] == me for r in dispatch)
    assert _names(spans, "tracking.track")
