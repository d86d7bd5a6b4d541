"""The benchmark's arithmetic, frozen: percentiles and alignment.

`aligned_errors` follows ppg_slam_tpu_torch/utils/evaluation.py `align_and_ate`
(Umeyama, with or without the scale). Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def aligned_errors(est: np.ndarray, gt: np.ndarray,
                   with_scale: bool = True) -> np.ndarray:
    """(N,) position errors after the similarity (rotation, translation
    and, with_scale, scale) that best aligns est (N, 3) onto gt (N, 3)
    (Umeyama)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    me, mg = est.mean(0), gt.mean(0)
    E, G = est - me, gt - mg
    U, d, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (E * E).sum() / len(est)
    c = float(np.trace(np.diag(d) @ S) / var) if with_scale and var > 0 \
        else 1.0
    return np.linalg.norm(G - c * E @ R.T, axis=1)


def align_ate(est: np.ndarray, gt: np.ndarray, with_scale: bool = True
              ) -> float:
    """RMS of aligned_errors."""
    e = aligned_errors(est, gt, with_scale)
    return float(np.sqrt((e * e).mean()))


def camera_center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
