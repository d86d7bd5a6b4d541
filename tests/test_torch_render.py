"""The rendered corridor of ppg_slam_tpu_torch.testing (the numpy port of
bench.py's wireframe corridor that chip_smoke.py's System phase tracks):
seeded, and its IMU consistent with its poses."""

import os

import numpy as np
import pytest

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.imu import Preintegrated
from ppg_slam_tpu_torch.pipeline.system import load_settings
from ppg_slam_tpu_torch.worldmap import Rig


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TBC = load_settings(os.path.join(ROOT, "configs", "euroc.yaml"))["Tbc"]


def test_same_seed_renders_the_same_frames():
    a = testing.render_corridor(n_frames=4, seed=7, Tbc=TBC)
    b = testing.render_corridor(n_frames=4, seed=7, Tbc=TBC)
    c = testing.render_corridor(n_frames=4, seed=8, Tbc=TBC)
    for fa, fb in zip(a.frames, b.frames):
        assert fa.shape == (480, 752) and fa.dtype == np.uint8
        np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(a.imu, b.imu)
    assert not np.array_equal(a.frames[0], c.frames[0])
    # texture, bars and noise: a busy image around the wall's grey
    assert 60 < a.frames[0].mean() < 170 and a.frames[0].std() > 15


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_preintegrated_imu_reproduces_the_poses(noisy):
    """Each frame-to-frame link of the rendered IMU, preintegrated by the
    port, carries the body from one rendered pose to the next: within
    2e-5 rad / 2e-5 m / 2e-4 m/s on the clean signal, and within
    2e-3 rad / 1e-3 m / 2e-2 m/s with the consumer-grade noise."""
    kw = {} if noisy else dict(noise_gyro=0.0, noise_acc=0.0)
    r = testing.render_corridor(n_frames=12, seed=3, Tbc=TBC, **kw)
    rig = Rig(testing.EUROC_CAM, Tbc=TBC)
    tol = (2e-3, 1e-3, 2e-2) if noisy else (2e-5, 2e-5, 2e-4)
    g = r.gravity.astype(np.float64)
    for k in range(len(r.times) - 1):
        t0, t1 = r.times[k], r.times[k + 1]
        m = r.imu[(r.imu[:, 6] > t0 + 1e-9) & (r.imu[:, 6] <= t1 + 1e-9)]
        assert len(m) == 10
        p = Preintegrated(np.zeros(6), rig.nga, rig.nga_walk, device="cpu")
        p.integrate_measurements(m[:, :3], m[:, 3:6],
                                 np.diff(np.concatenate([[t0], m[:, 6]])))
        (R1, t1_), (R2, t2) = r.body_poses[k], r.body_poses[k + 1]
        v1, v2 = r.body_vels[k], r.body_vels[k + 1]
        T = p.dT
        R_pred = R1 @ p.delta_rotation()
        t_pred = t1_ + v1 * T + 0.5 * g * T * T + R1 @ p.delta_position()
        v_pred = v1 + g * T + R1 @ p.delta_velocity()
        dR = R_pred.T @ R2
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < tol[0], (k, ang)
        assert np.abs(t_pred - t2).max() < tol[1], k
        assert np.abs(v_pred - v2).max() < tol[2], k


def test_camera_rides_the_body_by_tbc():
    r = testing.render_corridor(n_frames=3, Tbc=TBC)
    Rcw0, tcw0 = r.cam_poses[0]
    np.testing.assert_allclose(Rcw0, np.eye(3), atol=1e-6)
    np.testing.assert_allclose(tcw0, 0, atol=1e-6)
    for (Rcw, tcw), (Rwb, twb) in zip(r.cam_poses, r.body_poses):
        Rwc = Rwb @ TBC[:3, :3]
        np.testing.assert_allclose(Rcw, Rwc.T, atol=1e-5)
        np.testing.assert_allclose(-Rcw.T @ tcw, Rwb @ TBC[:3, 3] + twb,
                                   atol=1e-5)
