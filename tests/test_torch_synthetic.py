"""ppg_slam_tpu_torch.testing's synthetic scene, mono-inertial sequence and
PreintData builder against the repository's test harness
(tests/synthetic_world.py, tests/synthetic_sequence.py and
pipeline/tracking.py's _sqrtm_psd_inv) on the same seeds."""

import numpy as np
import pytest
import torch

import synthetic_sequence as SS
import synthetic_world as SW
from ppg_slam_tpu.pipeline.tracking import _sqrtm_psd_inv

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.imu import Preintegrated


def _assert_features_equal(got, ref):
    for key in ("kp_pos", "kp_pos_un", "kp_score", "kp_out", "edges",
                "edge_score", "colines", "desc"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)
    assert got.connected == ref.connected


@pytest.mark.parametrize("seed", [7, 13])
def test_scene_matches_harness(seed):
    """The same points, lines, triplets and descriptors; the same rendered
    frames, with and without pixel noise (both draw it from the scene's
    generator in the same order). Poses agree to 1e-6 (so3.exp in f32 on
    either side)."""
    ref, got = SW.SyntheticScene(seed=seed), testing.SyntheticScene(seed=seed)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.descs, ref.descs)
    assert got.triplets == ref.triplets and got.segments == ref.segments
    for k in (0, 5, 17):
        Rr, tr = ref.pose(k)
        Rg, tg = got.pose(k)
        np.testing.assert_allclose(Rg, Rr, atol=1e-6)
        np.testing.assert_allclose(tg, tr, atol=1e-6)
        for noise in (0.0, 0.5):
            (fr, ir), (fg, ig) = (s.render(Rr, tr, noise=noise)
                                  for s in (ref, got))
            np.testing.assert_array_equal(ig, ir)
            _assert_features_equal(fg, fr)


def test_sequence_matches_harness():
    """The same frame times, scene and IMU timestamps; poses, velocities
    and IMU samples integrated alike. Measured after 30 frames: rotations
    within 1.0e-6 and IMU samples within 1.1e-5 of the harness's
    (so3.exp in f32 on either side), positions and velocities equal; held
    to 1e-4."""
    ref = SS.SyntheticSequence(n_frames=30, seed=3, imu_noise=(1e-3, 1e-2))
    got = testing.SyntheticSequence(n_frames=30, seed=3,
                                    imu_noise=(1e-3, 1e-2))
    np.testing.assert_array_equal(got.scene.points, ref.scene.points)
    np.testing.assert_array_equal(got.frame_times, ref.frame_times)
    np.testing.assert_array_equal(got.imu[:, 6], ref.imu[:, 6])
    np.testing.assert_allclose(got.imu, ref.imu, atol=1e-4)
    for (Rg, tg), (Rr, tr) in zip(got.frame_poses, ref.frame_poses):
        np.testing.assert_allclose(Rg, Rr, atol=1e-4)
        np.testing.assert_allclose(tg, tr, atol=1e-4)
    np.testing.assert_allclose(np.stack(got.frame_vels),
                               np.stack(ref.frame_vels), atol=1e-4)
    for i in (0, 12, 29):
        for a, b in zip(got.frame_tcw(i), ref.frame_tcw(i)):
            np.testing.assert_allclose(a, b, atol=1e-4)
    m_g, m_r = got.imu_between(0.1, 0.6), ref.imu_between(0.1, 0.6)
    np.testing.assert_array_equal(m_g[:, 6], m_r[:, 6])


def test_preint_data_builds_as_the_tracker_does():
    """sqrtm_psd_inv equals the tracker's whitening factor, and preint_data
    carries a Preintegrated's deltas, Jacobians and bias with the three
    whitening blocks of its covariance."""
    rng = np.random.RandomState(3)
    A = rng.randn(15, 15)
    C = A @ A.T * 1e-6
    for block in (slice(0, 9), slice(9, 12), slice(12, 15)):
        np.testing.assert_array_equal(testing.sqrtm_psd_inv(C[block, block]),
                                      _sqrtm_psd_inv(C[block, block]))
    seq = testing.SyntheticSequence(n_frames=6, seed=3)
    m = seq.imu_between(0.0, seq.frame_times[-1])
    p = Preintegrated(np.float32([0.01, 0, 0, 0, 0.02, 0]),
                      np.full(6, 1e-4, np.float32),
                      np.full(6, 1e-8, np.float32), device="cpu")
    p.integrate_measurements(m[:, :3], m[:, 3:6], np.full(len(m), 0.005))
    pd = testing.preint_data(p, "cpu")
    st = p.state
    for key in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        np.testing.assert_array_equal(getattr(pd, key).numpy(),
                                      getattr(st, key))
    np.testing.assert_array_equal(pd.b0.numpy(), p.b)
    C = np.asarray(st.C, np.float64)
    np.testing.assert_array_equal(pd.sqi.numpy(), _sqrtm_psd_inv(C[:9, :9]))
    np.testing.assert_array_equal(pd.sqig.numpy(),
                                  _sqrtm_psd_inv(C[9:12, 9:12]))
    np.testing.assert_array_equal(pd.sqia.numpy(),
                                  _sqrtm_psd_inv(C[12:15, 12:15]))
    assert float(pd.dt) == pytest.approx(float(st.dT))
    assert all(x.dtype == torch.float32 for x in pd)
