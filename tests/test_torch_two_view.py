"""Two-view reconstruction: the port against ppg_slam_tpu.geometry.two_view.

The four fixtures of tests/test_two_view.py (general scene, tilted plane,
outliers, pure rotation), drawn from a seed with numpy, go through both
packages with the same RANSAC sets, with NOISE_PX of pixel noise. Asserted: `ok` and the triangulated
mask equal; where ok, R21 and t21 within 1e-4 and the triangulated points
within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ppg_slam_tpu.geometry import so3
from ppg_slam_tpu.geometry import two_view as jtv
from ppg_slam_tpu_torch.geometry import two_view as ttv

K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
POSE_TOL = 1e-4
POINT_RTOL = 1e-4
NOISE_PX = 0.05


def _project(X, R, t):
    Xc = X @ R.T + t
    return np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                     400 * Xc[:, 1] / Xc[:, 2] + 240], 1).astype(np.float32)


def _rot(w):
    return np.asarray(so3.exp(jnp.asarray(w, jnp.float32)), np.float32)


def _fixture(name):
    rng = np.random.RandomState({"general": 2, "planar": 3, "outliers": 4,
                                 "rotation": 5}[name])
    if name == "planar":
        xy = np.stack([rng.uniform(-2, 2, 150), rng.uniform(-1.5, 1.5, 150)],
                      1)
        X = np.concatenate([xy, 4 + 1.0 * xy[:, :1] + 0.4 * xy[:, 1:2]], 1)
        R, t = _rot([0.05, -0.35, 0.02]), np.float32([1.8, -0.1, 0.4])
    else:
        n = 200 if name == "outliers" else 150
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 10, n)], 1)
        R, t = {"general": (_rot([0.02, -0.15, 0.01]),
                            np.float32([0.8, 0.05, 0.1])),
                "outliers": (_rot([0.0, -0.12, 0.02]),
                             np.float32([0.7, 0.0, 0.05])),
                "rotation": (_rot([0.02, -0.1, 0.01]),
                             np.zeros(3, np.float32))}[name]
    X = X.astype(np.float32)
    # pixel noise: on exact data every all-inlier sample scores the same up
    # to f32 rounding, and the RANSAC argmax would pick among ties
    p1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    p2 = _project(X, R, t)
    p1 += rng.randn(*p1.shape).astype(np.float32) * NOISE_PX
    p2 += rng.randn(*p2.shape).astype(np.float32) * NOISE_PX
    if name == "outliers":
        bad = rng.choice(len(X), 40, replace=False)
        p2[bad] += rng.randn(40, 2).astype(np.float32) * 40 + 15
    pad, n = 256, len(X)
    P1 = np.zeros((pad, 2), np.float32)
    P2 = np.zeros((pad, 2), np.float32)
    valid = np.zeros(pad, bool)
    P1[:n], P2[:n], valid[:n] = p1, p2, True
    return P1, P2, valid, jtv.make_ransac_sets(np.arange(n)), R, t


def test_make_ransac_sets_is_the_reference():
    idx = np.arange(3, 97)
    for seed in (0, 1, 7):
        np.testing.assert_array_equal(ttv.make_ransac_sets(idx, seed=seed),
                                      jtv.make_ransac_sets(idx, seed=seed))
    # fewer matches than a sample: drawn with replacement in both
    np.testing.assert_array_equal(ttv.make_ransac_sets(np.arange(5)),
                                  jtv.make_ransac_sets(np.arange(5)))


@pytest.mark.parametrize("name", ["general", "planar", "outliers",
                                  "rotation"])
def test_two_view_matches_reference(name):
    P1, P2, valid, sets, R_true, t_true = _fixture(name)
    ref = jtv.two_view_reconstruct(jnp.asarray(P1), jnp.asarray(P2),
                                   jnp.asarray(valid), jnp.asarray(sets),
                                   jnp.asarray(K))
    out = ttv.two_view_reconstruct(torch.from_numpy(P1), torch.from_numpy(P2),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(sets), torch.from_numpy(K))
    assert bool(out.ok) == bool(ref.ok)
    np.testing.assert_array_equal(out.triangulated.numpy(),
                                  np.asarray(ref.triangulated))
    if name == "rotation":
        assert not bool(out.ok)  # no parallax: initialization deferred
        return
    if name != "planar":
        assert bool(out.ok)
    if bool(out.ok):
        np.testing.assert_allclose(out.R21.numpy(), np.asarray(ref.R21),
                                   atol=POSE_TOL)
        np.testing.assert_allclose(out.t21.numpy(), np.asarray(ref.t21),
                                   atol=POSE_TOL)
        tri = out.triangulated.numpy()
        assert tri.sum() > 100
        Xo, Xr = out.points3d.numpy()[tri], np.asarray(ref.points3d)[tri]
        err = np.linalg.norm(Xo - Xr, axis=1) / np.linalg.norm(Xr, axis=1)
        assert err.max() < POINT_RTOL, err.max()
        # and the motion is the true one, up to the translation's scale
        np.testing.assert_allclose(out.R21.numpy(), R_true, atol=5e-3)
        t = out.t21.numpy()
        assert t @ t_true / np.linalg.norm(t) / np.linalg.norm(t_true) > 0.995
