"""The benchmark's arithmetic on hand-made cases."""

import types

import numpy as np
import pytest

from slam_bench import arith, registry


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def view(latencies, window_s=None):
    return types.SimpleNamespace(
        latencies=list(latencies),
        window_s=sum(latencies) if window_s is None else window_s,
        arith=arith, stats={}, setup_s=1.0)


def test_percentile_interpolates_between_ranks():
    assert arith.percentile([1, 2, 3, 4], 50) == 2.5
    assert arith.percentile(range(11), 90) == pytest.approx(9.0)
    assert arith.percentile([5.0], 90) == 5.0


def test_a_stall_in_the_window_moves_frame_ms_and_its_tail():
    frame_ms = registry.reader("frame_ms")
    p90 = registry.reader("frame_ms_p90")
    steady = [1.0] * 40
    stalled = [1.0] * 35 + [3.0] * 5
    assert frame_ms(view(steady)) == pytest.approx(1000.0)
    assert p90(view(steady)) == pytest.approx(1000.0)
    assert frame_ms(view(stalled)) == pytest.approx(1250.0)
    assert p90(view(stalled)) > 2000.0
    # one stall of 4 s among 40 frames moves the mean by 10 %; the 90th
    # percentile, with 4 frames beyond it, not at all
    one = [1.0] * 39 + [5.0]
    assert frame_ms(view(one)) == pytest.approx(1100.0)
    assert p90(view(one)) == pytest.approx(1000.0)
    assert frame_ms(view([])) is None


def test_align_ate_removes_a_similarity():
    rng = np.random.RandomState(1)
    gt = rng.randn(40, 3)
    est = gt @ rot_z(0.7).T + np.array([3.0, -1.0, 2.0])
    assert arith.align_ate(est, gt) < 1e-9
    assert arith.align_ate(1.5 * est, gt) < 1e-9
    assert arith.align_ate(1.5 * est, gt, with_scale=False) > 0.1
    noisy = est + 0.01 * rng.randn(40, 3)
    assert arith.align_ate(noisy, gt) == pytest.approx(0.01 * np.sqrt(3),
                                                       rel=0.3)
    # a trajectory that stands still while the truth moves reads the spread
    still = np.zeros_like(gt)
    assert arith.align_ate(still, gt) == pytest.approx(
        np.sqrt((gt - gt.mean(0)).var(0).sum()))
