"""The port's Sim3 and Sim3 RANSAC against ppg_slam_tpu's.

* geometry.Sim3: exp, log, compose and inverse on a seeded batch that
  covers the four branches of exp/log (small/generic angle x small/generic
  log-scale), against ppg_slam_tpu.geometry.Sim3 in float32. Measured:
  within 1.2e-7 (exp), 1.5e-7 (log), 2.4e-7 (compose, inverse); held to
  1e-6.
* matching.horn_sim3 and Sim3Solver: the same host code on the same seed, so
  the same hypothesis order, R, t and s (bit-equal), and the same inlier
  masks for every hypothesis (the projection scoring is the only part
  that runs in torch), with the scale free and fixed; the port alone
  recovers the relative Sim3 of seeded matches with 30 % outliers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ppg_slam_tpu.geometry import Sim3 as JSim3
from ppg_slam_tpu.geometry.cameras import CameraModel as JCam
from ppg_slam_tpu.matching import Sim3Solver as JSolver
from ppg_slam_tpu.matching import horn_sim3 as j_horn

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.geometry import Sim3
from ppg_slam_tpu_torch.matching import Sim3Solver, horn_sim3

TOL = 1e-6
CAM_KW = {k: getattr(testing.CAM, k) for k in
          ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")}


def _tangents():
    """(16, 7) seeded tangents, four per branch of exp/log."""
    rng = np.random.RandomState(17)
    xi = (rng.randn(16, 7) * 0.4).astype(np.float32)
    xi[0:4, 3:6] *= 1e-6 / np.linalg.norm(xi[0:4, 3:6], axis=1,
                                          keepdims=True)   # theta small
    xi[0:4, 6] = rng.uniform(-5e-6, 5e-6, 4)               # sigma small
    xi[4:8, 3:6] *= 3e-6 / np.linalg.norm(xi[4:8, 3:6], axis=1,
                                          keepdims=True)   # theta small
    xi[8:12, 6] = rng.uniform(-5e-6, 5e-6, 4)              # sigma small
    return xi                                              # 12:16 generic


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _assert_sim3(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


def test_branches_are_covered():
    xi = _tangents()
    theta = np.linalg.norm(xi[:, 3:6], axis=1)
    sig = np.abs(xi[:, 6])
    cases = {(bool(t < 1e-5), bool(s < 1e-5)) for t, s in zip(theta, sig)}
    assert cases == {(True, True), (True, False), (False, True),
                     (False, False)}


def test_exp_log_match_reference():
    xi = _tangents()
    ref, got = JSim3.exp(_j(xi)), Sim3.exp(_t(xi))
    _assert_sim3(got, ref)
    np.testing.assert_allclose(got.log().numpy(), np.asarray(ref.log()),
                               atol=TOL)
    np.testing.assert_allclose(got.log().numpy(), xi, atol=1e-5)


def test_compose_inverse_apply_match_reference():
    xi = _tangents()
    a, b = xi, np.roll(xi, 5, axis=0)
    Ja, Jb = JSim3.exp(_j(a)), JSim3.exp(_j(b))
    Pa, Pb = Sim3.exp(_t(a)), Sim3.exp(_t(b))
    _assert_sim3(Pa @ Pb, Ja @ Jb)
    _assert_sim3(Pa.inverse(), Ja.inverse())
    _assert_sim3(Pa @ Pa.inverse(), Sim3.identity(batch=(16,)))
    x = np.random.RandomState(3).randn(16, 3).astype(np.float32)
    np.testing.assert_allclose(Pa.apply(_t(x)).numpy(),
                               np.asarray(Ja.apply(_j(x))), atol=TOL)
    se3 = Pa.to_se3()
    np.testing.assert_allclose(se3.t.numpy(),
                               np.asarray(Ja.to_se3().t), atol=TOL)
    back = Sim3.from_se3(se3)
    _assert_sim3(back, JSim3.from_se3(Ja.to_se3()))


def _matches(n=200, s=1.2):
    return testing.sim3_matches(n=n, s=s)


def test_horn_matches_reference():
    X1, X2, *_ = _matches()
    for fix_scale in (False, True):
        ref = j_horn(X1[:6].T, X2[:6].T, fix_scale)
        got = horn_sim3(X1[:6].T, X2[:6].T, fix_scale)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


@pytest.mark.parametrize("fix_scale", [False, True])
def test_solver_matches_reference(fix_scale):
    """Every hypothesis (same RandomState order) equal, every inlier mask
    equal, and the same incremental result."""
    X1, X2, uv1, uv2, _, _ = _matches(s=1.0 if fix_scale else 1.2)
    ref = JSolver(X1, X2, uv1, uv2, JCam(**CAM_KW), fix_scale=fix_scale,
                  min_inliers=15)
    got = Sim3Solver(X1, X2, uv1, uv2, testing.CAM, fix_scale=fix_scale,
                     min_inliers=15, device="cpu")
    res_r, res_g = ref.iterate(300), got.iterate(300)
    assert got.max_iterations == ref.max_iterations
    for a, b in zip(got._hyp, ref._hyp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_g[0], res_r[0])
    np.testing.assert_array_equal(res_g[1], res_r[1])
    assert res_g[2:] == res_r[2:] and res_g[2] >= 100
    assert got.iterations_done == ref.iterations_done
    for a, b in zip(got.get_estimates(), ref.get_estimates()):
        np.testing.assert_allclose(a, b, atol=TOL)


def test_solver_recovers_sim3():
    X1, X2, uv1, uv2, (R, t, s), bad = _matches()
    solver = Sim3Solver(X1, X2, uv1, uv2, testing.CAM, fix_scale=False,
                        min_inliers=15, device="cpu")
    T, inliers, n_in, _ = solver.iterate(300)
    assert T is not None
    Rg, tg, sg = solver.get_estimates()
    np.testing.assert_allclose(Rg, R, atol=0.02)
    np.testing.assert_allclose(tg, t, atol=0.1)
    assert abs(sg - s) < 0.03
    assert n_in >= 100 and inliers[bad].mean() < 0.2


def test_solver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    X1, X2, uv1, uv2, _, _ = _matches(n=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        Sim3Solver(X1, X2, uv1, uv2, testing.CAM, fix_scale=False)
