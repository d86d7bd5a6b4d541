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


# ---------------------------------------------------------------------------
# distorted renders (testing.distort_frames) and the UMA-VI folder writer
# ---------------------------------------------------------------------------

def _settings_camera(name):
    from ppg_slam_tpu_torch.pipeline.system import camera_from_settings

    return camera_from_settings(load_settings(os.path.join(ROOT, "configs",
                                                           name)))


def _cv2_source_points(cam, canvas):
    """Each pixel's source point by OpenCV: cv2.undistortPoints (radtan,
    P = K) or cv2.fisheye.undistortPoints (KB8, P = the canvas's K)."""
    cv2 = pytest.importorskip("cv2")
    vv, uu = np.mgrid[0:cam.height, 0:cam.width].astype(np.float64)
    pts = np.stack([uu.ravel(), vv.ravel()], 1)[:, None, :]
    K = cam.K().astype(np.float64)
    D = np.asarray(cam.dist, np.float64)
    if cam.is_fisheye:
        out = cv2.fisheye.undistortPoints(pts, K, D, P=canvas.K().astype(
            np.float64))
    else:
        out = cv2.undistortPoints(pts, K, D, P=K)
    return out.reshape(cam.height, cam.width, 2)


# radtan: both sides run 5 compensation steps (f32 here, f64 in OpenCV;
# measured 1.7e-4 px); KB8: 10 Newton steps in f32 against OpenCV's f64
# iteration, up to 1.2 rad off the axis (measured 4.7e-4 and 5.9e-4 px)
SOURCE_ATOL_PX = {"euroc.yaml": 1e-3, "tumvi.yaml": 2e-3, "uma.yaml": 2e-3}


@pytest.mark.parametrize("name", sorted(SOURCE_ATOL_PX))
def test_distortion_source_map_matches_opencv(name):
    cam = _settings_camera(name)
    canvas = testing.fisheye_canvas(cam) if cam.is_fisheye else None
    got = testing.distortion_source_map(cam, canvas)
    ref = _cv2_source_points(cam, canvas)
    ok = np.isfinite(got).all(-1)
    assert ok.mean() > (0.5 if cam.is_fisheye else 0.99)
    err = np.abs(got[ok] - ref[ok]).max()
    assert err < SOURCE_ATOL_PX[name], err
    if cam.is_fisheye:  # the canvas holds every ray the map keeps
        inside = ((got[ok] >= 0) & (got[ok] <= [canvas.width - 1,
                                                canvas.height - 1]))
        assert inside.all()


@pytest.mark.parametrize("name", ["euroc.yaml", "tumvi.yaml"])
def test_distort_frames_samples_the_render_where_opencv_says(name):
    """A linear ramp through distort_frames equals the ramp at OpenCV's
    source point wherever that point lies inside the render (bilinear
    sampling is exact on a linear image); elsewhere the border grey."""
    cam = _settings_camera(name)
    canvas = testing.fisheye_canvas(cam) if cam.is_fisheye else None
    src_cam = canvas or cam
    vv, uu = np.mgrid[0:src_cam.height, 0:src_cam.width].astype(np.float64)
    ramp = (0.05 * uu + 0.03 * vv + 7.0).astype(np.float32)
    out, = testing.distort_frames([ramp], cam, canvas=canvas)
    assert out.shape == (cam.height, cam.width) and out.dtype == np.float32
    ref = _cv2_source_points(cam, canvas)
    want = 0.05 * ref[..., 0] + 0.03 * ref[..., 1] + 7.0
    got_src = testing.distortion_source_map(cam, canvas)
    inside = (np.isfinite(got_src).all(-1)
              & (ref[..., 0] >= 0) & (ref[..., 0] <= src_cam.width - 1)
              & (ref[..., 1] >= 0) & (ref[..., 1] <= src_cam.height - 1))
    assert inside.mean() > 0.5
    np.testing.assert_allclose(out[inside], want[inside], atol=2e-3)
    assert (out[~np.isfinite(got_src).all(-1)]
            == testing.CORRIDOR_BORDER).all()
    u8, = testing.distort_frames([np.clip(ramp, 0, 255).astype(np.uint8)],
                                 cam, canvas=canvas)
    assert u8.dtype == np.uint8 and u8.shape == out.shape


def test_fractional_frame_times_keep_the_imu_consistent():
    """UMA-VI's 12 fps against a 250 Hz IMU: frames fall between ticks.
    Each frame-to-frame link, preintegrated from the rows that cover it
    (the first and last cut at the frame times), carries the body from one
    rendered pose to the next on the clean signal."""
    r = testing.render_corridor(n_frames=8, seed=3, Tbc=TBC, fps=12.0,
                                imu_hz=250.0, noise_gyro=0.0, noise_acc=0.0)
    rig = Rig(testing.EUROC_CAM, Tbc=TBC)
    g = r.gravity.astype(np.float64)
    dt = 1.0 / 250.0
    assert np.allclose(r.times, np.arange(8) / 12.0)
    for k in range(len(r.times) - 1):
        t0, t1 = r.times[k], r.times[k + 1]
        end = r.imu[:, 6]
        m = r.imu[(end > t0 + 1e-9) & (end - dt < t1 - 1e-9)]
        if end[-1] < t1 - 1e-9:  # the last frame's tail: no tick after it
            assert k == len(r.times) - 2
            continue
        dts = np.minimum(m[:, 6], t1) - np.maximum(m[:, 6] - dt, t0)
        assert abs(dts.sum() - (t1 - t0)) < 1e-9
        p = Preintegrated(np.zeros(6), rig.nga, rig.nga_walk, device="cpu")
        p.integrate_measurements(m[:, :3], m[:, 3:6], dts)
        (R1, t1_), (R2, t2) = r.body_poses[k], r.body_poses[k + 1]
        v1, v2 = r.body_vels[k], r.body_vels[k + 1]
        T = p.dT
        R_pred = R1 @ p.delta_rotation()
        t_pred = t1_ + v1 * T + 0.5 * g * T * T + R1 @ p.delta_position()
        v_pred = v1 + g * T + R1 @ p.delta_velocity()
        dR = R_pred.T @ R2
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 2e-5 and np.abs(t_pred - t2).max() < 2e-5, k
        assert np.abs(v_pred - v2).max() < 2e-4, k


def test_integral_rates_render_as_before():
    """fps and imu_hz at their defaults give the 20 fps / 200 Hz corridor:
    10 IMU rows a frame, frames on the ticks."""
    a = testing.render_corridor(n_frames=3, seed=7, Tbc=TBC)
    b = testing.render_corridor(n_frames=3, seed=7, Tbc=TBC, fps=20.0,
                                imu_hz=200.0, reach=0.0)
    assert len(a.imu) == 20
    np.testing.assert_allclose(a.imu[:, 6], np.arange(1, 21) * 0.005)
    for fa, fb in zip(a.frames, b.frames):
        np.testing.assert_array_equal(fa, fb)


def test_uma_folder_reads_back_through_load_uma(tmp_path):
    from ppg_slam_tpu_torch.datasets import load_uma, read_gray

    r = testing.render_corridor(n_frames=4, seed=5, Tbc=TBC, fps=12.0,
                                imu_hz=250.0)
    gt = testing.write_uma_folder(r, str(tmp_path), frames=range(1, 4))
    assert os.path.isdir(tmp_path / "cam0") and not os.path.exists(
        tmp_path / "mav0")
    images, stamps, imu = load_uma(str(tmp_path))
    np.testing.assert_allclose(stamps - 1.0, r.times[1:], atol=1e-9)
    for path, k in zip(images, range(1, 4)):
        np.testing.assert_array_equal(read_gray(path), r.frames[k])
    np.testing.assert_allclose(imu[:, 6] - 1.0, r.imu[:, 6], atol=1e-9)
    np.testing.assert_allclose(imu[:, :6], r.imu[:, :6], rtol=1e-12)
    assert len(np.loadtxt(gt, ndmin=2)) == 3
