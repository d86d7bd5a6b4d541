"""ppg_slam_tpu_torch.geometry.so3/se3 and the new camera functions against
ppg_slam_tpu's, on the same seeded inputs; and the numpy-vs-tensor split of
so3.normalize (SVD polar factor vs two Newton-Schulz steps)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ppg_slam_tpu.geometry import SE3 as JSE3
from ppg_slam_tpu.geometry import cameras as jcams
from ppg_slam_tpu.geometry import so3 as jso3

from ppg_slam_tpu_torch.geometry import SE3, cameras, so3

RNG = np.random.RandomState(41)
# f32 transcendental functions of XLA:CPU and PyTorch differ by an ulp or
# two; the largest difference measured over these inputs is 2.4e-7
ATOL = 2e-6


def _vectors():
    """(64, 3) tangents: generic angles, tiny ones on both sides of the
    1e-5 series switch, zero, and angles within 1e-3 of pi."""
    w = RNG.randn(64, 3).astype(np.float32)
    w[:16] *= 0.5
    w[16:24] *= 1e-6
    w[24] = 0.0
    axis = w[32:40] / np.linalg.norm(w[32:40], axis=1, keepdims=True)
    w[32:40] = axis * (np.pi - RNG.uniform(0, 1e-3, (8, 1)))
    return w.astype(np.float32)


@pytest.mark.parametrize("name", ["hat", "exp", "right_jacobian",
                                  "inverse_right_jacobian"])
def test_vector_functions_match_reference(name):
    w = _vectors()
    if name == "inverse_right_jacobian":
        w = w[np.linalg.norm(w, axis=1) < 3.0]  # singular at |w| = 2 pi
    ref = np.asarray(getattr(jso3, name)(jnp.asarray(w)))
    got = getattr(so3, name)(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL * np.abs(ref).max(), rtol=0)
    # the numpy path gives numpy, and the same values
    host = getattr(so3, name)(w)
    assert isinstance(host, np.ndarray) and host.dtype == np.float32
    np.testing.assert_allclose(host, got, atol=ATOL, rtol=0)


def test_log_vee_and_quaternions_match_reference():
    w = _vectors()
    R = np.array(jso3.exp(jnp.asarray(w)))
    Rt = torch.from_numpy(R)
    # log: near pi the axis comes from the symmetric part; the angle is
    # resolved to ~1e-4 there in f32 (arccos near -1), in both packages
    ref = np.asarray(jso3.log(jnp.asarray(R)))
    got = so3.log(Rt).numpy()
    near_pi = np.abs(np.linalg.norm(w, axis=1) - np.pi) < 1e-2
    np.testing.assert_allclose(got[~near_pi], ref[~near_pi], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[near_pi], ref[near_pi], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(so3.vee(so3.hat(Rt)).numpy(),
                                  np.asarray(jso3.vee(jso3.hat(jnp.asarray(R)))))
    q_ref = np.asarray(jso3.matrix_to_quat(jnp.asarray(R)))
    q = so3.matrix_to_quat(Rt)
    np.testing.assert_allclose(q.numpy(), q_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        so3.quat_to_matrix(q).numpy(),
        np.asarray(jso3.quat_to_matrix(jnp.asarray(q_ref))), atol=ATOL, rtol=0)


def test_normalize_splits_by_input_type():
    """numpy in: exact SVD polar factor (repairs a reflection); tensor in:
    Newton-Schulz, as the reference's traced path; exact=True: SVD."""
    R = np.array(jso3.exp(jnp.asarray(_vectors()[:16])))
    noisy = (R + RNG.randn(*R.shape).astype(np.float32) * 1e-3).astype(
        np.float32)
    ref_np = jso3.normalize(noisy)
    got_np = so3.normalize(noisy)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, ref_np, atol=1e-6, rtol=0)

    ref_ns = np.asarray(jso3.normalize(jnp.asarray(noisy)))
    got_ns = so3.normalize(torch.from_numpy(noisy)).numpy()
    np.testing.assert_allclose(got_ns, ref_ns, atol=1e-6, rtol=0)
    # exact=True takes the SVD polar factor on a tensor too
    got_exact = so3.normalize(torch.from_numpy(noisy), exact=True).numpy()
    np.testing.assert_allclose(
        got_exact, np.asarray(jso3.normalize(jnp.asarray(noisy), exact=True)),
        atol=1e-6, rtol=0)

    # a reflection with distinct singular values (det < 0): the repaired
    # polar factor is unique, so both SVDs agree on it
    flip = (R[0] * np.float32([1.2, 1.0, -0.8])).astype(np.float32)
    fixed = so3.normalize(flip)
    np.testing.assert_allclose(fixed, jso3.normalize(flip), atol=1e-6)
    assert np.linalg.det(fixed) > 0.99


def test_se3_matches_reference():
    xi = RNG.randn(8, 6).astype(np.float32) * 0.7
    pts = RNG.randn(8, 3).astype(np.float32)
    ref = JSE3.exp(jnp.asarray(xi))
    got = SE3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-5)
    np.testing.assert_allclose(got.log().numpy(), np.asarray(ref.log()),
                               atol=2e-5)
    inv = got.inverse()
    np.testing.assert_allclose((got @ inv).apply(torch.from_numpy(pts)).numpy(),
                               pts, atol=1e-5)
    np.testing.assert_allclose(got.apply(torch.from_numpy(pts)).numpy(),
                               np.asarray(ref.apply(jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(got.matrix().numpy(), np.asarray(ref.matrix()),
                               atol=1e-5)
    np.testing.assert_allclose(got.normalized().R.numpy(),
                               np.asarray(ref.normalized().R), atol=ATOL)


KB8 = dict(kind=cameras.CAM_FISHEYE, fx=190.0, fy=191.0, cx=254.0, cy=256.0,
           dist=(0.0035, 0.0007, -0.0021, 0.0002), width=512, height=512)
PIN = dict(kind=cameras.CAM_PINHOLE, fx=458.654, fy=457.296, cx=367.215,
           cy=248.375, dist=(-0.28, 0.07, 0.0002, 1.8e-5), width=752,
           height=480)


@pytest.mark.parametrize("kw", [PIN, KB8], ids=["pinhole", "kb8"])
def test_camera_jacobians_and_numpy_twins(kw):
    cam, jcam = cameras.CameraModel(**kw), jcams.CameraModel(**kw)
    xyz = np.stack([RNG.uniform(-2, 2, 50), RNG.uniform(-1.5, 1.5, 50),
                    RNG.uniform(2, 8, 50)], 1).astype(np.float32)
    ref = np.asarray(jcam.project_jac(jnp.asarray(xyz)))
    got = cam.project_jac(torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # and the analytic Jacobian is the derivative of project
    auto = torch.func.vmap(torch.func.jacfwd(cam.project))(
        torch.from_numpy(xyz).double())
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-3)
    uv = jcam.project_np(xyz)
    np.testing.assert_array_equal(cam.project_np(xyz), uv)
    np.testing.assert_array_equal(cam.unproject_np(uv), jcam.unproject_np(uv))


def test_epipolar_distance_matches_reference():
    kp1 = RNG.uniform(0, 640, (30, 2)).astype(np.float32)
    kp2 = RNG.uniform(0, 480, (30, 2)).astype(np.float32)
    R = np.array(jso3.exp(jnp.asarray([0.01, -0.03, 0.02], jnp.float32)))
    t = np.float32([0.3, -0.05, 0.02])
    K = cameras.CameraModel(**PIN).K()
    ref = np.asarray(jcams.epipolar_sq_dist(
        jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(R), jnp.asarray(t),
        jnp.asarray(K)))
    got = cameras.epipolar_sq_dist(*(torch.from_numpy(a) for a in
                                     (kp1, kp2, R, t, K))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
