"""pose_inertial_optimization replayed from a CUDA graph (estimator.pose_opt.
PoseInertialReplay) against the eager call on the same inputs, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor ppg_slam_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pose_replay_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.estimator import pose_opt as P
from ppg_slam_tpu_torch.estimator.ba_core import DOF
from ppg_slam_tpu_torch.geometry.cameras import CAM_FISHEYE, CameraModel
from ppg_slam_tpu_torch.pipeline.system import (camera_from_settings,
                                                load_settings)
from ppg_slam_tpu_torch.utils import profiler

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each camera is its own graph: the pinhole projects without distortion
# (its observations are undistorted pixels), Kannala-Brandt through KB8
CAMS = {
    "tumvi_kb8": CameraModel(kind=CAM_FISHEYE, **testing.TUMVI_CAM_KW),
    "euroc_radtan": camera_from_settings(load_settings(
        os.path.join(ROOT, "configs", "euroc.yaml"))),
}
CAPACITY = 500
# (observations, fix_prev) of successive calls: both variants, at and far
# below the capacity, and few enough inliers for the recovery pass
CALLS = [(300, False), (180, True), (420, False), (60, True), (500, False),
         (250, True), (33, False), (470, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(params=sorted(CAMS))
def cam(request):
    return CAMS[request.param]


def eager(case, device, fix_prev, cam):
    t = lambda arrays: [torch.from_numpy(np.asarray(a)).to(device)
                        for a in arrays]
    return P.pose_inertial_optimization(
        P.FrameVIState(*t(case["curr"])), P.FrameVIState(*t(case["prev"])),
        P.PreintData(*t(case["preint"])),
        P.Prior15(*t(case["prior"]),
                  valid=torch.tensor(case["prior_valid"], device=device)),
        *t([case[k] for k in ("X", "uv", "valid", "close", "Rcb", "tcb")]),
        cam, fix_prev=fix_prev)


def near_threshold(case, state, close, cam, tol=1e-3):
    """Rows whose chi2 at `state` lies within tol of a threshold that
    classifies them (5.991, 1.5 x 5.991 when close, the recovery's 18)."""
    t = lambda a: torch.from_numpy(np.asarray(a))
    r, _, _ = P._mono_batch(t(state[0]), t(state[1]), t(case["X"]),
                            t(case["uv"]), t(case["Rcb"]), t(case["tcb"]),
                            cam, False)
    chi2 = torch.sum(r * r, dim=1).numpy()
    th = np.where(close, 1.5 * P.CHI2_MONO, P.CHI2_MONO)
    return (np.abs(chi2 - th) < tol) | (np.abs(chi2 - 18.0) < tol)


def test_replay_matches_eager_and_captures_once_per_key(cuda_device, cam):
    """Each call against the eager call on its inputs: states within 1e-4,
    the same inliers (rows within 1e-3 of a chi2 threshold excepted), the
    new prior's H within 1e-3 of its largest entry; one capture per
    fix_prev, every later call a replay."""
    replay = P.PoseInertialReplay(cam, CAPACITY, cuda_device)
    before = {k: profiler.stats[k].count if k in profiler.stats else 0
              for k in ("pose_inertial.capture", "pose_inertial.replay")}
    worst = dict(state=0.0, H=0.0, flips=0)
    for k, (n, fix_prev) in enumerate(CALLS):
        case = testing.pose_inertial_case(n, fix_prev, seed=40 + k, cam=cam,
                                          outliers=0.1 if n > 40 else 0.5)
        c, inl, n_in, prior = replay(
            *[case[key] for key in ("curr", "prev", "preint", "prior",
                                    "prior_valid", "X", "uv", "valid",
                                    "close", "Rcb", "tcb")],
            fix_prev=fix_prev)
        got = ([x.cpu().numpy() for x in c], inl.cpu().numpy(),
               int(n_in), prior.H.cpu().numpy())
        c, inl, n_in, prior = eager(case, cuda_device, fix_prev, cam)
        ref = ([x.cpu().numpy() for x in c], inl.cpu().numpy(),
               int(n_in), prior.H.cpu().numpy())
        for name, g, r in zip(("R", "t", "v", "bg", "ba"), got[0], ref[0]):
            np.testing.assert_allclose(g, r, atol=1e-4,
                                       err_msg=f"call {k}: {name}")
            worst["state"] = max(worst["state"], float(np.abs(g - r).max()))
        assert got[1].shape == (CAPACITY,) and not got[1][n:].any()
        differ = got[1][:n] != ref[1]
        assert not (differ & ~near_threshold(case, ref[0], case["close"],
                                             cam)).any(), \
            f"call {k}: inliers differ"
        assert abs(got[2] - ref[2]) <= differ.sum()
        assert got[3].shape == (DOF, DOF) and np.isfinite(got[3]).all()
        assert np.abs(got[3] - ref[3]).max() <= 1e-3 * np.abs(ref[3]).max()
        worst["H"] = max(worst["H"], float(np.abs(got[3] - ref[3]).max()
                                           / np.abs(ref[3]).max()))
        worst["flips"] += int(differ.sum())
    print(f"replay against eager, {cam.kind=}: {worst}")
    counts = {k: profiler.stats[k].count - before[k] for k in before}
    assert counts == {"pose_inertial.capture": 2,
                      "pose_inertial.replay": len(CALLS)}, counts
    assert sorted(replay._graphs) == [(False, False), (True, False)]


def test_replay_rejects_more_rows_than_its_capacity(cuda_device, cam):
    replay = P.PoseInertialReplay(cam, 16, cuda_device)
    case = testing.pose_inertial_case(17, False, cam=cam)
    with pytest.raises(ValueError):
        replay(*[case[key] for key in ("curr", "prev", "preint", "prior",
                                       "prior_valid", "X", "uv", "valid",
                                       "close", "Rcb", "tcb")],
               fix_prev=False)
    assert not replay._graphs


def test_eager_calls_stay_finite_with_an_invalid_prior(cuda_device, cam):
    """Successive eager calls on the same inputs, the LastKeyFrame variant's
    zero prior among them, stay finite and equal: on the H100 the eigh of
    that all-zero prior returned NaN eigenvalues from the second such call
    on (with no error), and the NaN went through the prior rows into the
    marginal, until the prior's square root took its eigh on the identity
    instead."""
    for n, fix_prev, seed in ((320, False, 70), (320, True, 73),
                              (320, True, 71)):
        case = testing.pose_inertial_case(n, fix_prev, seed=seed, cam=cam)
        first = None
        for _ in range(4):
            c, inl, n_in, prior = eager(case, cuda_device, fix_prev, cam)
            out = np.concatenate([x.cpu().numpy().ravel() for x in
                                  (*c, prior.H)])
            assert np.isfinite(out).all()
            if first is None:
                first = out
            np.testing.assert_array_equal(out, first)
    zero = P.Prior15(*[torch.zeros(s, device=cuda_device) for s in
                       ((3, 3), 3, 3, 3, 3, (15, 15))],
                     valid=torch.tensor(False, device=cuda_device))
    for _ in range(4):
        assert torch.equal(P._prior_sqrt(zero),
                           torch.zeros(15, 15, device=cuda_device))
