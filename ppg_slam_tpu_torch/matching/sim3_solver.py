"""Sim3Solver: RANSAC + Horn closed-form similarity between two keyframes.

Port of ppg_slam_tpu/matching/sim3_solver.py (the reference's
matching/Sim3Solver.*, an ORB-SLAM3 port): given matched MapPoints of two
KFs (expressed in each camera frame), find the relative Sim3 (optionally
fixed scale) with Horn's 1987 quaternion method on random 3-point sets,
scoring by reprojection error in both images (th2 = 9.210 px^2 per point).

The hypotheses are drawn and solved on the host as in the reference package
(the same RandomState order, f64 batched eigh); all of them are scored in
one batched projection on the solver's device, at the exact point count;
iterate() replays the reference's incremental accept over the masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.cameras import CameraModel
from ..utils import profiler


def horn_sim3(P1: np.ndarray, P2: np.ndarray, fix_scale: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Closed-form Sim3 aligning P2 -> P1 (3xN each): returns (R12, t12, s12).

    Horn, 'Closed-form solution of absolute orientation using unit
    quaternions' (Sim3Solver::ComputeSim3, Sim3Solver.cpp)."""
    c1 = P1.mean(axis=1, keepdims=True)
    c2 = P2.mean(axis=1, keepdims=True)
    Pr1 = P1 - c1
    Pr2 = P2 - c2
    M = Pr2 @ Pr1.T  # note: maps 2 into 1
    Sxx, Sxy, Sxz = M[0]
    Syx, Syy, Syz = M[1]
    Szx, Szy, Szz = M[2]
    N = np.array([
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ])
    w, v = np.linalg.eigh(N)
    q = v[:, -1]  # (w, x, y, z)
    qw, qx, qy, qz = q
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    if fix_scale:
        s = 1.0
    else:
        # ORB-SLAM3: s = trace(Pr1^T R Pr2) / |Pr2|^2
        num = float(np.sum(Pr1 * (R @ Pr2)))
        den = float(np.sum(Pr2 * Pr2))
        s = num / max(den, 1e-12)
    t = (c1 - s * R @ c2)[:, 0]
    return R.astype(np.float32), t.astype(np.float32), float(s)


class Sim3Solver:
    def __init__(self, X1: np.ndarray, X2: np.ndarray,
                 uv1: np.ndarray, uv2: np.ndarray,
                 cam: CameraModel, fix_scale: bool,
                 probability: float = 0.99, min_inliers: int = 6,
                 max_iterations: int = 300, seed: int = 0, device=None):
        """X1/X2: (N, 3) matched points in camera-1 / camera-2 frames;
        uv1/uv2: their pixel observations in image 1 / image 2. The
        hypotheses are scored on `device` (CUDA unless the caller names
        another)."""
        self.device = resolve_device(device)
        self.X1 = np.asarray(X1, np.float32)
        self.X2 = np.asarray(X2, np.float32)
        self.uv1 = np.asarray(uv1, np.float32)
        self.uv2 = np.asarray(uv2, np.float32)
        self.cam = cam
        self.fix_scale = fix_scale
        self.n = len(X1)
        self.max_error = 9.210  # Sim3Solver.cpp mvnMaxError (chi2 2dof 99%)
        self.min_inliers = min_inliers
        self.rng = np.random.RandomState(seed)
        self.iterations_done = 0
        # adaptive iteration count like SetRansacParameters
        eps = min_inliers / max(self.n, 1)
        if self.n >= min_inliers and eps > 0:
            n_iter = int(np.ceil(np.log(1 - probability)
                                 / np.log(max(1 - eps ** 3, 1e-9))))
            self.max_iterations = int(np.clip(n_iter, 1, max_iterations))
        else:
            self.max_iterations = 1
        self.best_inliers = np.zeros(self.n, bool)
        self.best_n = 0
        self.best_R: Optional[np.ndarray] = None
        self.best_t: Optional[np.ndarray] = None
        self.best_s = 1.0
        self._hyp = None  # precomputed vectorized hypotheses (lazy)

    def _score_all(self, X2in1, X1in2, ok_z):
        """Score every hypothesis x point in one batched projection on the
        device: project both directions, threshold (strictly below
        max_error), fetch the (H, n) boolean inlier mask."""
        dev = self.device
        f32 = torch.float32
        cam = self.cam
        uv1 = torch.as_tensor(self.uv1, dtype=f32, device=dev)
        uv2 = torch.as_tensor(self.uv2, dtype=f32, device=dev)
        uv1p = cam.project(torch.as_tensor(X2in1, dtype=f32, device=dev))
        uv2p = cam.project(torch.as_tensor(X1in2, dtype=f32, device=dev))
        th = torch.tensor(self.max_error, dtype=f32, device=dev)
        e1 = torch.sum((uv1p - uv1[None]) ** 2, -1)
        e2 = torch.sum((uv2p - uv2[None]) ** 2, -1)
        okz = torch.as_tensor(ok_z, device=dev)
        profiler.count_device("sim3_score", okz)
        return (okz & (e1 < th) & (e2 < th)).cpu().numpy()

    def _precompute(self) -> None:
        """Compute and score ALL max_iterations hypotheses in one
        vectorized pass: batched Horn (numpy eigh over (H,4,4)) + one
        batched projection; iterate() then replays the reference's
        incremental accept logic over the precomputed inlier masks."""
        H = self.max_iterations
        idx = np.stack([self.rng.choice(self.n, 3, replace=False)
                        for _ in range(H)])                      # (H, 3)
        P1 = self.X1[idx]                                        # (H, 3, 3)
        P2 = self.X2[idx]
        c1 = P1.mean(axis=1, keepdims=True)
        c2 = P2.mean(axis=1, keepdims=True)
        Pr1 = (P1 - c1).astype(np.float64)
        Pr2 = (P2 - c2).astype(np.float64)
        M = np.einsum("hni,hnj->hij", Pr2, Pr1)  # rows of P are points
        Sxx, Sxy, Sxz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
        Syx, Syy, Syz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
        Szx, Szy, Szz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
        N = np.empty((H, 4, 4), np.float64)
        N[:, 0] = np.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz,
                            Sxy - Syx], 1)
        N[:, 1] = np.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx,
                            Szx + Sxz], 1)
        N[:, 2] = np.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz,
                            Syz + Szy], 1)
        N[:, 3] = np.stack([Sxy - Syx, Szx + Sxz, Syz + Szy,
                            -Sxx - Syy + Szz], 1)
        w, v = np.linalg.eigh(N)
        q = v[:, :, -1]                                          # (H, 4)
        qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        R = np.empty((H, 3, 3), np.float64)
        R[:, 0, 0] = 1 - 2 * (qy * qy + qz * qz)
        R[:, 0, 1] = 2 * (qx * qy - qw * qz)
        R[:, 0, 2] = 2 * (qx * qz + qw * qy)
        R[:, 1, 0] = 2 * (qx * qy + qw * qz)
        R[:, 1, 1] = 1 - 2 * (qx * qx + qz * qz)
        R[:, 1, 2] = 2 * (qy * qz - qw * qx)
        R[:, 2, 0] = 2 * (qx * qz - qw * qy)
        R[:, 2, 1] = 2 * (qy * qz + qw * qx)
        R[:, 2, 2] = 1 - 2 * (qx * qx + qy * qy)
        if self.fix_scale:
            s = np.ones(H)
        else:
            num = np.einsum("hni,hni->h", Pr1,
                            np.einsum("hij,hnj->hni", R, Pr2))
            den = np.maximum(np.einsum("hni,hni->h", Pr2, Pr2), 1e-12)
            s = num / den
        t = c1[:, 0] - s[:, None] * np.einsum("hij,hj->hi", R, c2[:, 0])
        R = R.astype(np.float32)
        t = t.astype(np.float32)
        s = s.astype(np.float32)

        # score every hypothesis against every point (reference _check)
        X2in1 = s[:, None, None] * np.einsum("hij,nj->hni", R, self.X2) \
            + t[:, None, :]
        X1in2 = (1.0 / s)[:, None, None] * np.einsum(
            "hji,hnj->hni", R, self.X1[None] - t[:, None, :])
        ok_z = (X2in1[..., 2] > 0) & (X1in2[..., 2] > 0)
        inl = self._score_all(np.where(ok_z[..., None], X2in1, 1.0),
                              np.where(ok_z[..., None], X1in2, 1.0), ok_z)
        self._hyp = (R, t, s, inl)

    def iterate(self, n_iterations: int
                ) -> Tuple[Optional[np.ndarray], np.ndarray, int, bool]:
        """Run up to n_iterations; returns (T12 4x4 or None, inliers, n, no_more).

        Matches Sim3Solver::iterate semantics (same rng hypothesis order,
        same incremental best/early-return) over the precomputed vectorized
        scores: returns a transform as soon as a hypothesis reaches
        min_inliers; no_more=True when the budget is exhausted."""
        if self.n < 3 or self.n < self.min_inliers:
            return None, np.zeros(self.n, bool), 0, True
        if self._hyp is None:
            self._precompute()
        R_all, t_all, s_all, inl_all = self._hyp
        it = 0
        while it < n_iterations and \
                self.iterations_done < self.max_iterations:
            h = self.iterations_done
            it += 1
            self.iterations_done += 1
            inl = inl_all[h]
            n_in = int(inl.sum())
            if n_in > self.best_n:
                self.best_n = n_in
                self.best_inliers = inl
                self.best_R, self.best_t, self.best_s = \
                    R_all[h], t_all[h], float(s_all[h])
                if n_in >= self.min_inliers:
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :3] = self.best_s * self.best_R
                    T[:3, 3] = self.best_t
                    return T, inl, n_in, False
        no_more = self.iterations_done >= self.max_iterations
        return None, self.best_inliers, self.best_n, no_more

    def get_estimates(self):
        return self.best_R, self.best_t, self.best_s
