"""ppg_slam_tpu_torch.imu against ppg_slam_tpu.imu on the fixtures of
tests/test_imu.py: the preintegrated deltas, the five bias Jacobians, the
15x15 covariance, bias-corrected deltas, and the host Preintegrated's
merge/reintegrate."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ppg_slam_tpu import imu as jimu

from ppg_slam_tpu_torch import imu
from test_imu import NGA, NGAW, numpy_preintegrate

RNG = np.random.RandomState(3)
FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C", "dT",
          "avgA", "avgW")


def make_meas(n=50):
    acc = (RNG.randn(n, 3) * 0.5 + [0, 0, 9.81]).astype(np.float32)
    gyr = (RNG.randn(n, 3) * 0.2).astype(np.float32)
    dt = np.full(n, 0.005, np.float32)
    return acc, gyr, dt


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _assert_state_close(got, ref):
    """Each field within 2e-5 of its largest entry. Measured on the
    50-sample fixture: the bias Jacobians 1.6e-6, avgW 4.5e-7, the
    covariance 1.0e-7, the deltas below 2e-9 (f32 products summed in
    another order)."""
    for k in FIELDS:
        g = np.asarray(getattr(got, k), np.float64)
        r = np.asarray(getattr(ref, k), np.float64)
        scale = max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(g, r, atol=2e-5 * scale, rtol=0, err_msg=k)


def test_integrate_matches_reference_and_spec():
    acc, gyr, dt = make_meas(50)
    bias = np.array([0.01, -0.02, 0.005, 0.1, -0.05, 0.2], np.float32)
    args = (acc, gyr, dt, np.ones(50, bool), bias, NGA, NGAW)
    ref = jimu.integrate(*(jnp.asarray(a) for a in args))
    got = imu.integrate(*_t(*args))
    _assert_state_close(got, ref)
    spec = numpy_preintegrate(*(np.asarray(a, np.float64) for a in
                                (acc, gyr, dt, bias, NGA, NGAW)))
    np.testing.assert_allclose(got.dR.numpy(), spec["dR"], atol=1e-5)
    np.testing.assert_allclose(got.dP.numpy(), spec["dP"], atol=1e-4)
    np.testing.assert_allclose(got.C.numpy(), spec["C"], atol=1e-9, rtol=1e-3)


def test_padding_is_noop():
    acc, gyr, dt = make_meas(20)
    bias = np.zeros(6, np.float32)
    pad = 12
    accp = np.concatenate([acc, RNG.randn(pad, 3).astype(np.float32)])
    gyrp = np.concatenate([gyr, RNG.randn(pad, 3).astype(np.float32)])
    dtp = np.concatenate([dt, np.full(pad, 0.005, np.float32)])
    validp = np.concatenate([np.ones(20, bool), np.zeros(pad, bool)])
    st1 = imu.integrate(*_t(acc, gyr, dt, np.ones(20, bool), bias, NGA, NGAW))
    st2 = imu.integrate(*_t(accp, gyrp, dtp, validp, bias, NGA, NGAW))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(st2, k).numpy(),
                                      getattr(st1, k).numpy(), err_msg=k)
    ref = jimu.integrate(*(jnp.asarray(a) for a in
                           (accp, gyrp, dtp, validp, bias, NGA, NGAW)))
    _assert_state_close(st2, ref)


def test_corrected_deltas_match_reference():
    acc, gyr, dt = make_meas(80)
    b0 = np.zeros(6, np.float32)
    db = np.array([2e-3, -1e-3, 1e-3, 5e-3, -3e-3, 4e-3], np.float32)
    args = (acc, gyr, dt, np.ones(80, bool), b0, NGA, NGAW)
    ref_st = jimu.integrate(*(jnp.asarray(a) for a in args))
    st = imu.integrate(*_t(*args))
    ref = jimu.corrected_deltas(ref_st, jnp.asarray(b0), jnp.asarray(b0 + db))
    got = imu.corrected_deltas(st, torch.from_numpy(b0),
                               torch.from_numpy(b0 + db))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6)
    # numpy state and biases take the numpy path (SVD normalize), as the
    # reference's host getters do
    host = imu.corrected_deltas(st.numpy(), b0, b0 + db)
    assert all(isinstance(x, np.ndarray) for x in host)
    for g, r in zip(host, got):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-6)


def test_preintegrated_merge_and_reintegrate_match_reference():
    acc, gyr, dt = make_meas(40)

    def run(cls, **kw):
        p1 = cls(np.zeros(6), NGA, NGAW, **kw)
        p1.integrate_measurements(acc[:25], gyr[:25], dt[:25])
        p2 = cls(np.zeros(6), NGA, NGAW, **kw)
        p2.integrate_measurements(acc[25:], gyr[25:], dt[25:])
        p2.merge_previous(p1)
        p3 = cls(np.zeros(6), NGA, NGAW, **kw)
        p3.integrate_measurements(acc, gyr, dt)
        p3.set_new_bias(np.array([0.01, 0, 0, 0.05, 0, 0], np.float32))
        p3.reintegrate()
        return p2, p3

    ref2, ref3 = run(jimu.Preintegrated)
    got2, got3 = run(imu.Preintegrated, device="cpu")
    assert isinstance(got2.state.dR, np.ndarray)
    _assert_state_close(got2.state, ref2.state)
    _assert_state_close(got3.state, ref3.state)
    np.testing.assert_allclose(got3.delta_velocity(), ref3.delta_velocity(),
                               atol=1e-6)
    np.testing.assert_allclose(got2.delta_rotation(
        np.float32([1e-3, 0, 0, 0, 0, 0])), ref2.delta_rotation(
        np.float32([1e-3, 0, 0, 0, 0, 0])), atol=1e-6)
    assert abs(got2.dT - ref2.dT) < 1e-6
    cp = got2.copy()
    assert cp.device == got2.device and cp.state is got2.state


def test_preintegrated_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        imu.Preintegrated(np.zeros(6), NGA, NGAW)
