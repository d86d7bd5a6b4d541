"""The traced run's readers: `attribution.attribute` on synthetic runtime
calls and device operations (each call to every span name around it on its
own thread, once; none outside every span; device time by correlation id),
the readings it makes, the metric readers on a fixed view, the attributed
run's imports, and on the card a span around N additions and one
`.item()`."""

import subprocess
import sys
import threading
import types

import numpy as np
import pytest

from slam_bench import arith, registry
from slam_bench.attribution import (LAUNCH, SYNC, TID_MASK, Calls, attribute,
                                    readings)

A = 2 ** 40 + 5            # thread ids as threading.get_ident() gives them
B = 2 ** 40 + 0xDEAD0000   # CUPTI keeps the low 32 bits, signed
B_CUPTI = int(np.array([B & TID_MASK], np.uint32).view(np.int32)[0])

SPANS = [  # (start, end, thread, depth, name), in the order spans end
    (10, 50, A, 1, "inner"),
    (60, 70, A, 1, "inner"),
    (0, 100, A, 0, "outer"),
    (0, 100, B, 0, "outer"),
]
# (thread, start, kind, correlation id); each call takes 2 ns
CALLS = [(A, 5, LAUNCH, 1), (A, 20, LAUNCH, 2), (A, 30, SYNC, 3),
         (A, 65, LAUNCH, 4), (A, 150, LAUNCH, 5),
         (B_CUPTI, 40, LAUNCH, 6), (B_CUPTI, 200, SYNC, 7)]
# (correlation id, device ns): two operations for call 2 (a graph launch),
# none for the sync, one with no call
OPS = [(1, 7), (2, 11), (2, 13), (4, 17), (5, 19), (6, 23), (99, 1000)]


def _calls(calls=CALLS, ops=OPS):
    tid, start, kind, corr = (np.asarray(c) for c in zip(*calls))
    op_corr, op_ns = zip(*ops)
    return Calls(tid, start, start + 2, kind, corr, op_corr, op_ns)


def test_calls_go_to_every_enclosing_span_of_their_thread():
    got = attribute(SPANS, _calls())
    assert sorted(got["stages"]) == ["inner", "outer"]
    assert got["stages"]["outer"] == pytest.approx(dict(
        spans=2, launches=4, syncs=1, busy_s=(7 + 24 + 17 + 23) * 1e-9))
    assert got["stages"]["inner"] == pytest.approx(dict(
        spans=2, launches=2, syncs=1, busy_s=(24 + 17) * 1e-9))
    # first call 5 ns after a span opens at the least; last call's end
    # 3 ns before a span closes (the inner span 60-70: call 65-67)
    assert got["clock_margins_ns"] == [5, 3]


def test_a_call_outside_every_span_goes_to_no_stage():
    outside = [(A, 150, LAUNCH, 5), (B_CUPTI, 200, SYNC, 7)]
    got = attribute(SPANS, _calls(outside))
    assert all(c["launches"] == c["syncs"] == 0 and c["busy_s"] == 0
               for c in got["stages"].values())
    assert got["clock_margins_ns"] is None
    # the thread's totals still hold them
    assert _calls(outside).totals(A) == pytest.approx(dict(
        launches=1, syncs=0, busy_s=19e-9))
    assert _calls(outside).totals(B)["syncs"] == 1


def test_busy_time_follows_the_correlation_id():
    # the same calls with their correlation ids swapped move the time
    swapped = [(t, s, k, {1: 4, 4: 1}.get(c, c)) for t, s, k, c in CALLS]
    got = attribute(SPANS, _calls(swapped))["stages"]
    assert got["inner"]["busy_s"] == pytest.approx((24 + 7) * 1e-9)
    assert got["outer"]["busy_s"] == pytest.approx((7 + 24 + 17 + 23) * 1e-9)
    assert _calls().totals(A) == pytest.approx(dict(
        launches=4, syncs=1, busy_s=(7 + 24 + 17 + 19) * 1e-9))


def test_a_span_inside_one_of_its_own_name_counts_once():
    spans = SPANS + [(12, 40, A, 2, "inner")]
    got = attribute(spans, _calls())["stages"]
    assert got["inner"] == pytest.approx(dict(
        spans=2, launches=2, syncs=1, busy_s=(24 + 17) * 1e-9))


def test_no_spans_gives_no_stages():
    assert attribute([], _calls()) == dict(stages={}, clock_margins_ns=None)


def test_readings_divide_by_frames_and_calls():
    stages = {"tracking.pose_inertial": dict(spans=4, launches=400, syncs=8,
                                             busy_s=0.02),
              "local_mapping.lba": dict(spans=2, launches=100, syncs=6,
                                        busy_s=0.01)}
    thread = dict(launches=1000, syncs=20, busy_s=0.5)
    assert readings(stages, thread, 10) == dict(
        frame_launches=100.0, frame_syncs=2.0, pose_inertial_launches=100.0,
        pose_inertial_syncs=2.0, pose_inertial_busy_ms=5.0,
        lba_launches=50.0, lba_syncs=3.0)
    none = readings({}, thread, 0)
    assert set(none.values()) == {None}


VIEW = types.SimpleNamespace(
    latencies=[0.5, 0.7, 1.5, 0.6], window_s=3.4, setup_s=70.5,
    frontend_wait_s=0.008, arith=arith,
    stats={"tracking.pose_inertial": (4, 2.4), "tracking.preintegrate": (4,
           0.2), "tracking.match": (4, 0.12), "tracking.keyframe": (2, 2.0),
           "local_mapping.lba": (2, 1.0), "loop_closing.detect": (2, 0.002),
           "frontend.get": (4, 0.02), "frontend.dispatch": (1, 0.006)},
    trace=dict(busy_s=0.17, window_s=3.4))

READ = {"frame_ms": 850.0, "setup_s": 70.5,
        "frame_ms_p90": arith.percentile(VIEW.latencies, 90) * 1e3,
        "pose_inertial_ms": 600.0, "preintegrate_ms": 50.0,
        "frontend_wait_ms": 2.0, "match_ms": 30.0, "keyframe_ms": 1000.0,
        "lba_ms": 500.0, "loop_detect_ms": 1.0, "device_idle": 95.0,
        "frontend_get_ms": 5.0, "frontend_issue_ms": 1.5}


def test_the_metric_readers_on_a_fixed_view():
    bench = registry.benchmark()
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in READ:
        assert name in names, name
        assert registry.reader(name)(VIEW) == pytest.approx(READ[name]), name


def test_the_frontend_span_readers_read_nothing_without_the_spans():
    view = types.SimpleNamespace(**{**vars(VIEW), "stats": {}})
    for name in ("frontend_get_ms", "frontend_issue_ms"):
        assert registry.reader(name)(view) is None


def test_the_attributed_run_loads_no_jax_and_without_a_card_prints_nothing(
        tmp_path):
    code = ("import slam_bench.attribution, slam_bench.run as r; "
            "print(','.join(r.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "", out.stderr
    out = subprocess.run([sys.executable, "-m", "slam_bench.attribution",
                          "--workload", "tumvi-cruise", "--seed", "1",
                          "--seconds", "1"],
                         cwd=registry.ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin",
                                           "HOME": str(tmp_path),
                                           "TMPDIR": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == "", out.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_reads_its_launches_and_sync_on_the_card(card):
    """N additions and one .item() inside a program span: N + 1 launches
    (N kernels, one copy) and one sync, the kernels' device time inside
    the span, each runtime call stamped with the span's thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppg_slam_tpu_torch.utils.profiling import Profiler

    n = 16
    x = torch.ones(1024, device=card)
    torch.add(x, 1.0)[0].item()  # load the kernels and the pinned buffer
    torch.cuda.synchronize()
    p = Profiler()
    p.tracing = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with p.timer("span"):
            y = x
            for _ in range(n):
                y = torch.add(y, 1.0)
            assert y[0].item() == n + 1
    (s0, s1, tid, depth, _), = p.spans
    assert tid == threading.get_ident() and depth == 0
    calls = Calls.from_profile(prof)
    got = attribute(p.spans, calls)
    print("card:", torch.cuda.get_device_name(0), "calls:",
          len(calls.start), got)
    assert got["stages"]["span"]["launches"] == n + 1
    assert got["stages"]["span"]["syncs"] == 1
    assert np.all(calls.tid == tid & TID_MASK)
    lead, tail = got["clock_margins_ns"]
    assert lead >= 0 and tail >= 0
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    assert len(ops) == n + 1
    assert s0 <= min(o[0] for o in ops) and max(o[1] for o in ops) <= s1
    assert got["stages"]["span"]["busy_s"] == pytest.approx(
        sum(o[1] - o[0] for o in ops) * 1e-9)
