"""Pose-inertial's eager linear algebra timed and its prior guarded (CPU):
pose_inertial_optimization records pose_inertial.prior_sqrt (the prior's
eigh) and pose_inertial.marginal (the marginalization's svd and eigh),
called alone and through Tracking's pose-inertial step, where the spans lie
inside tracking.pose_inertial; and the step counts a returned prior H with
a non-finite entry under pose_inertial.prior_nonfinite (0 on a sound call,
1 with a NaN planted in the fetched H).

The tracking step runs on a Tracking built without its constructor, on
frames that carry testing.pose_inertial_case's states, preintegration and
observations: the step reads nothing else."""

import os
import types

import numpy as np
import pytest
import torch

import ppg_slam_tpu_torch.pipeline.tracking as ptr
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.estimator import pose_opt as P
from ppg_slam_tpu_torch.geometry.cameras import CAM_FISHEYE, CameraModel
from ppg_slam_tpu_torch.pipeline.system import (camera_from_settings,
                                                load_settings)
from ppg_slam_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = {
    "euroc_radtan": camera_from_settings(load_settings(
        os.path.join(ROOT, "configs", "euroc.yaml"))),
    "tumvi_kb8": CameraModel(kind=CAM_FISHEYE, **testing.TUMVI_CAM_KW),
}
SPANS = ("pose_inertial.prior_sqrt", "pose_inertial.marginal")
NONFINITE = "pose_inertial.prior_nonfinite"


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


class _Frame:
    """What Tracking's pose-inertial step reads of a frame and writes."""

    def __init__(self, state, preint=None, matched=(), kp=None):
        self.R, self.t, self.v, bg, ba = state
        self.velocity = self.v
        self.bias = np.concatenate([bg, ba])
        self.preint_frame = preint
        self.prior = None
        self.map_points = list(matched)
        self.kp = kp
        self.outlier = [False] * len(self.map_points)

    def imu_rotation(self):
        return self.R

    def imu_position(self):
        return self.t

    def set_imu_pose_velocity(self, R, t, v):
        self.R, self.t, self.v = R, t, v
        self.velocity = v


def _preint(case):
    """A Preintegrated stand-in whose covariance whitens to the case's
    square-root informations."""
    dR, dV, dP, JRg, JVg, JVa, JPg, JPa, b, sqi, sqig, sqia, dT = \
        case["preint"]
    C = np.zeros((15, 15))
    for sl, sq in ((slice(0, 9), sqi), (slice(9, 12), sqig),
                   (slice(12, 15), sqia)):
        C[sl, sl] = np.linalg.inv(np.asarray(sq, np.float64) ** 2)
    state = types.SimpleNamespace(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg,
                                  JVa=JVa, JPg=JPg, JPa=JPa, C=C, dT=dT)
    return types.SimpleNamespace(state=state, dT=float(dT), b=b)


def _tracking(case, cam, fix_prev):
    """(Tracking, current frame) at the case's pose-inertial call."""
    tr = ptr.Tracking.__new__(ptr.Tracking)
    tr.device = torch.device("cpu")
    tr.rig = types.SimpleNamespace(cam=cam, Rcb=case["Rcb"], tcb=case["tcb"])
    tr._pose_replay = None
    pre = _preint(case)
    src = _Frame(case["prev"])
    if fix_prev:
        tr.last_kf, tr.preint_from_kf = src, pre
    else:
        R, t, v, bg, ba, H = case["prior"]
        src.prior = dict(R=R, t=t, v=v, bg=bg, ba=ba, H=H)
        tr.last_frame = src
    points = [types.SimpleNamespace(pos=x, track_depth=5.0)
              for x in case["X"]]
    frame = _Frame(case["curr"], None if fix_prev else pre, points,
                   case["uv"])
    return tr, frame


def test_an_eager_call_records_both_spans(traced):
    case = testing.pose_inertial_case(120, False, seed=5)
    t = lambda arrays: [torch.from_numpy(np.asarray(a)) for a in arrays]
    P.pose_inertial_optimization(
        P.FrameVIState(*t(case["curr"])), P.FrameVIState(*t(case["prev"])),
        P.PreintData(*t(case["preint"])),
        P.Prior15(*t(case["prior"]), valid=torch.tensor(True)),
        *t([case[k] for k in ("X", "uv", "valid", "close", "Rcb", "tcb")]),
        CAMS["tumvi_kb8"])
    assert {k: traced.stats[k].count for k in SPANS} == {k: 1 for k in SPANS}
    assert [r[4] for r in traced.spans] == list(SPANS)
    # the prior's root is taken before the marginalization starts
    assert traced.spans[0][1] <= traced.spans[1][0]


@pytest.mark.parametrize("fix_prev", [False, True],
                         ids=["last_frame", "last_keyframe"])
@pytest.mark.parametrize("cam", sorted(CAMS))
def test_the_tracking_step_records_the_spans_and_no_nonfinite_prior(
        traced, cam, fix_prev):
    case = testing.pose_inertial_case(150, fix_prev, seed=11,
                                      cam=CAMS[cam])
    tr, frame = _tracking(case, CAMS[cam], fix_prev)
    n_in = tr._run_pose_inertial(frame, fix_prev=fix_prev)
    assert n_in > 100 and frame.has_pose
    assert np.isfinite(frame.prior["H"]).all()
    assert traced.counters[NONFINITE] == 0
    assert {k: traced.stats[k].count for k in
            ("tracking.pose_inertial", *SPANS)} == {
        "tracking.pose_inertial": 1, **{k: 1 for k in SPANS}}
    outer = next(r for r in traced.spans if r[4] == "tracking.pose_inertial")
    for name in SPANS:
        span = next(r for r in traced.spans if r[4] == name)
        assert outer[0] <= span[0] <= span[1] <= outer[1]
        assert span[3] == outer[3] + 1 and span[2] == outer[2]


@pytest.mark.parametrize("cam", sorted(CAMS))
def test_a_nan_in_the_fetched_prior_is_counted(traced, cam, monkeypatch):
    fetch = ptr._fetch

    def planted(*tensors):
        out = fetch(*tensors)
        H = out[-1].copy()
        H[3, 7] = np.nan
        return out[:-1] + [H]

    case = testing.pose_inertial_case(150, False, seed=12, cam=CAMS[cam])
    tr, frame = _tracking(case, CAMS[cam], False)
    tr._run_pose_inertial(frame, fix_prev=False)
    assert traced.counters[NONFINITE] == 0
    monkeypatch.setattr(ptr, "_fetch", planted)
    tr._run_pose_inertial(frame, fix_prev=False)
    assert traced.counters[NONFINITE] == 1
    assert not np.isfinite(frame.prior["H"]).all()
    monkeypatch.setattr(ptr, "_fetch", fetch)
    tr._run_pose_inertial(frame, fix_prev=False)
    assert traced.counters[NONFINITE] == 1
    assert traced.stats["tracking.pose_inertial"].count == 3
