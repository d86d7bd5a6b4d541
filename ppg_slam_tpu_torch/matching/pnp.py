"""Copy of ppg_slam_tpu/matching/pnp.py, its so3 calls on the port's so3.

Maximum-Likelihood PnP for relocalization (the reference MLPnPsolver).

Implements the ML bearing-vector nullspace formulation of
the reference's matching/src/MLPnPsolver.cpp inside RANSAC, invoked only
from Relocalization (Tracking.cpp:1227):

  * bearing vectors from camera unprojection (MLPnPsolver.cpp:54-56; works
    for pinhole and fisheye through the camera model);
  * per-bearing 3x2 nullspace bases r,s with residual
    [r s]^T normalized(R p + t)   (computePose :339-353);
  * planar-scene detection via rank(P P^T) with eigen-frame rotation
    (:359-378), 9-column design matrix in the planar branch, 12-column
    otherwise (:407-500), smallest singular vector of A^T A (:505-510);
  * rotation recovery + Frobenius-nearest orthonormalization + 4-fold /
    2-fold sign disambiguation by bearing alignment on the first 6
    correspondences (:520-630);
  * Gauss-Newton polish on the nullspace residuals (mlpnp_gn :687-755,
    vectorized here with a left-perturbation Jacobian instead of the
    reference's global-rodrigues analytic one);
  * RANSAC loop with adaptive iteration count, pixel-reprojection inlier
    check (CheckInliers :246-277, chi2 threshold th2), and Refine on the
    best inlier set (:279-331).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..geometry.cameras import CameraModel


def _dlt_pose(Xw: np.ndarray, uv_n: np.ndarray
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """6+ point DLT for [R|t] from world points and normalized image coords,
    followed by orthonormalization."""
    n = len(Xw)
    A = np.zeros((2 * n, 12))
    for i in range(n):
        X = np.append(Xw[i], 1.0)
        A[2 * i, 0:4] = X
        A[2 * i, 8:12] = -uv_n[i, 0] * X
        A[2 * i + 1, 4:8] = X
        A[2 * i + 1, 8:12] = -uv_n[i, 1] * X
    _, _, vt = np.linalg.svd(A)
    P = vt[-1].reshape(3, 4)
    R_raw = P[:, :3]
    # orthonormalize with sign fix (points must be in front)
    u, s, vt2 = np.linalg.svd(R_raw)
    det = np.linalg.det(u @ vt2)
    D = np.diag([1.0, 1.0, np.sign(det)])
    R = u @ D @ vt2
    scale = np.mean(s) * np.sign(det) if det != 0 else np.mean(s)
    if abs(scale) < 1e-12:
        return None
    t = P[:, 3] / scale
    # cheirality: majority of points must have positive depth
    z = Xw @ R[2] + t[2]
    if np.median(z) < 0:
        R = -R if np.linalg.det(-R) > 0 else R
        t = -t
        z = Xw @ R[2] + t[2]
        if np.median(z) < 0:
            return None
    return R.astype(np.float32), t.astype(np.float32)


def _nullspaces(f: np.ndarray) -> np.ndarray:
    """(N,3,2) orthonormal bases of the orthogonal complement of each unit
    bearing (reference computePose :348-352, SVD nullspace)."""
    n = len(f)
    # pick the axis least aligned with f, build r = norm(f x e), s = f x r
    e = np.zeros((n, 3))
    e[np.arange(n), np.argmin(np.abs(f), axis=1)] = 1.0
    r = np.cross(f, e)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    s = np.cross(f, r)
    return np.stack([r, s], axis=2)  # (N, 3, 2)


def _mlpnp_pose(Xw: np.ndarray, f: np.ndarray):
    """Core MLPnP (reference computePose :332-651): returns (Rcw, tcw) or
    None. Xw (N,3) world points, f (N,3) unit bearings, N >= 6."""
    n = len(Xw)
    if n < 6:
        return None
    ns = _nullspaces(f)                       # (N,3,2)
    P3 = Xw.T.astype(np.float64)              # (3,N)

    # planar test (reference :359-378)
    M = P3 @ P3.T
    ev, evec = np.linalg.eigh(M)
    planar = ev[0] < 1e-10 * max(ev[2], 1.0)
    eigen_rot = np.eye(3)
    pts = P3.T.copy()
    if planar:
        eigen_rot = evec.T                    # rows = eigenvectors
        pts = pts @ eigen_rot.T

    r = ns[:, :, 0]                           # (N,3)
    s = ns[:, :, 1]
    if planar:
        # unknowns: r12 r13 r22 r23 r32 r33 t1 t2 t3 (reference :421-447)
        A = np.zeros((2 * n, 9))
        A[0::2, 0] = r[:, 0] * pts[:, 1]
        A[1::2, 0] = s[:, 0] * pts[:, 1]
        A[0::2, 1] = r[:, 0] * pts[:, 2]
        A[1::2, 1] = s[:, 0] * pts[:, 2]
        A[0::2, 2] = r[:, 1] * pts[:, 1]
        A[1::2, 2] = s[:, 1] * pts[:, 1]
        A[0::2, 3] = r[:, 1] * pts[:, 2]
        A[1::2, 3] = s[:, 1] * pts[:, 2]
        A[0::2, 4] = r[:, 2] * pts[:, 1]
        A[1::2, 4] = s[:, 2] * pts[:, 1]
        A[0::2, 5] = r[:, 2] * pts[:, 2]
        A[1::2, 5] = s[:, 2] * pts[:, 2]
        A[0::2, 6] = r[:, 0]
        A[1::2, 6] = s[:, 0]
        A[0::2, 7] = r[:, 1]
        A[1::2, 7] = s[:, 1]
        A[0::2, 8] = r[:, 2]
        A[1::2, 8] = s[:, 2]
    else:
        # unknowns: full row-major R^T stacking + t (reference :457-500)
        A = np.zeros((2 * n, 12))
        for k in range(3):        # world coordinate index
            for m in range(3):    # nullspace row index
                A[0::2, 3 * m + k] = r[:, m] * pts[:, k]
                A[1::2, 3 * m + k] = s[:, m] * pts[:, k]
        A[0::2, 9] = r[:, 0]
        A[1::2, 9] = s[:, 0]
        A[0::2, 10] = r[:, 1]
        A[1::2, 10] = s[:, 1]
        A[0::2, 11] = r[:, 2]
        A[1::2, 11] = s[:, 2]

    AtA = A.T @ A
    try:
        _, _, vt = np.linalg.svd(AtA)
    except np.linalg.LinAlgError:
        return None
    x = vt[-1]

    def frobenius_rot(tmp):
        u, _, vt2 = np.linalg.svd(tmp)
        Rf = u @ vt2
        if np.linalg.det(Rf) < 0:
            Rf = -Rf
        return Rf

    f6 = f[:min(6, n)]
    p6 = Xw[:min(6, n)].astype(np.float64)

    def bearing_error(R, t):
        v = p6 @ R.T + t
        nv = np.linalg.norm(v, axis=1)
        nv = np.where(nv < 1e-12, 1.0, nv)
        return float(np.sum(1.0 - np.sum(v / nv[:, None] * f6, axis=1)))

    if planar:
        # reference :520-584
        tmp = np.array([[0.0, x[0], x[1]],
                        [0.0, x[2], x[3]],
                        [0.0, x[4], x[5]]])
        tmp[:, 0] = np.cross(tmp[:, 1], tmp[:, 2])
        tmp = tmp.T
        c1n = np.linalg.norm(tmp[:, 1])
        c2n = np.linalg.norm(tmp[:, 2])
        scale = 1.0 / np.sqrt(max(abs(c1n * c2n), 1e-12))
        R1 = frobenius_rot(tmp)
        R1 = eigen_rot.T @ R1
        t0 = scale * x[6:9]
        R1 = R1.T * -1.0
        if np.linalg.det(R1) < 0:
            R1 = R1.copy()
            R1[:, 2] *= -1
        R2 = R1.copy()
        R2[:, 0] *= -1
        R2[:, 1] *= -1
        best, best_err = None, np.inf
        for Rc in (R1, R2):
            for tc in (t0, -t0):
                err = bearing_error(Rc, tc)
                if err < best_err:
                    best_err, best = err, (Rc, tc)
        Rout, tout = best
    else:
        # reference :586-630
        tmp = np.array([[x[0], x[3], x[6]],
                        [x[1], x[4], x[7]],
                        [x[2], x[5], x[8]]])
        scale = 1.0 / np.power(
            max(abs(np.linalg.norm(tmp[:, 0]) * np.linalg.norm(tmp[:, 1])
                    * np.linalg.norm(tmp[:, 2])), 1e-18), 1.0 / 3.0)
        Rout = frobenius_rot(tmp)
        tout = Rout @ (scale * x[9:12])
        # two sign candidates, inverted convention (reference :608-629)
        best, best_err = None, np.inf
        for sgn in (1.0, -1.0):
            Rc = Rout.T
            tc = -Rout.T @ (sgn * tout)
            err = bearing_error(Rc, tc)
            if err < best_err:
                best_err, best = err, (Rc, tc)
        Rout, tout = best

    # GN polish on the nullspace residuals (reference mlpnp_gn :687-755)
    Rout, tout = _mlpnp_gn(Rout, tout, Xw.astype(np.float64), ns)
    z = Xw @ Rout[2].astype(np.float64) + tout[2]
    if np.median(z) < 0:
        return None
    return Rout.astype(np.float32), tout.astype(np.float32)


def _mlpnp_gn(R, t, Xw, ns, iters: int = 5):
    """Vectorized GN on r_i = N_i^T (v/||v||), v = R p + t, with
    left-multiplicative SO3 perturbation."""
    from ..geometry import so3

    for _ in range(iters):
        v = Xw @ R.T + t                      # (N,3)
        nv = np.linalg.norm(v, axis=1)
        bad = nv < 1e-9
        nv = np.where(bad, 1.0, nv)
        u = v / nv[:, None]
        res = np.einsum("nij,ni->nj", ns, u)  # (N,2)
        # du/dv = (I - u u^T)/||v||
        duv = (np.eye(3)[None] - u[:, :, None] * u[:, None, :]) \
            / nv[:, None, None]
        Rp = v - t                            # R p
        skew = np.zeros((len(Xw), 3, 3))
        skew[:, 0, 1] = -Rp[:, 2]
        skew[:, 0, 2] = Rp[:, 1]
        skew[:, 1, 0] = Rp[:, 2]
        skew[:, 1, 2] = -Rp[:, 0]
        skew[:, 2, 0] = -Rp[:, 1]
        skew[:, 2, 1] = Rp[:, 0]
        Jw = -np.einsum("nij,njk,nkl->nil",
                        np.transpose(ns, (0, 2, 1)), duv, skew)  # (N,2,3)
        Jt = np.einsum("nij,njk->nik",
                       np.transpose(ns, (0, 2, 1)), duv)         # (N,2,3)
        J = np.concatenate([Jw, Jt], axis=2).reshape(-1, 6)
        r = res.reshape(-1)
        H = J.T @ J + 1e-9 * np.eye(6)
        g = J.T @ r
        try:
            dx = -np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            break
        dR = so3.exp(dx[:3].astype(np.float32)).astype(np.float64)
        R = dR @ R
        t = dR @ t + dx[3:]
        if np.linalg.norm(dx) < 1e-10:
            break
    return R, t


def _gn_refine(R, t, Xw, uv, fx, fy, cx, cy, iters=8):
    from ..geometry import so3

    for _ in range(iters):
        Xc = Xw @ R.T + t
        z = np.maximum(Xc[:, 2], 1e-6)
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
        r = np.stack([uv[:, 0] - u, uv[:, 1] - v], 1).reshape(-1)
        # analytic Jacobian wrt [w, t] (left perturbation on Tcw)
        n = len(Xw)
        J = np.zeros((2 * n, 6))
        invz = 1.0 / z
        invz2 = invz * invz
        x, y = Xc[:, 0], Xc[:, 1]
        # d(uv)/dXc
        J_u = np.stack([fx * invz, np.zeros(n), -fx * x * invz2], 1)
        J_v = np.stack([np.zeros(n), fy * invz, -fy * y * invz2], 1)
        # dXc/d(w) = -[Xc]x ; dXc/dt = I
        for i in range(n):
            skew = np.array([[0, -Xc[i, 2], Xc[i, 1]],
                             [Xc[i, 2], 0, -Xc[i, 0]],
                             [-Xc[i, 1], Xc[i, 0], 0]])
            J[2 * i, :3] = -(J_u[i] @ (-skew))
            J[2 * i, 3:] = -(J_u[i])
            J[2 * i + 1, :3] = -(J_v[i] @ (-skew))
            J[2 * i + 1, 3:] = -(J_v[i])
        H = J.T @ J + 1e-6 * np.eye(6)
        g = J.T @ r
        dx = -np.linalg.solve(H, g)
        dR = so3.exp(dx[:3].astype(np.float32))
        R = (dR @ R).astype(np.float32)
        t = (dR @ t + dx[3:]).astype(np.float32)
    return R, t


class PnPSolver:
    """RANSAC PnP with the MLPnPsolver interface used by relocalization."""

    def __init__(self, Xw: np.ndarray, uv: np.ndarray, cam: CameraModel,
                 probability=0.99, min_inliers=10, max_iterations=300,
                 min_set=6, epsilon=0.4, th2=5.991, seed: int = 0):
        self.Xw = np.asarray(Xw, np.float32)
        self.uv = np.asarray(uv, np.float32)
        self.cam = cam
        self.n = len(Xw)
        self.min_set = min_set
        self.min_inliers = max(min_inliers, min_set)
        self.th2 = th2
        self.rng = np.random.RandomState(seed)
        eps = max(epsilon, self.min_inliers / max(self.n, 1))
        if self.n >= self.min_inliers:
            its = int(np.ceil(np.log(max(1 - probability, 1e-12))
                              / np.log(max(1 - eps ** min_set, 1e-12))))
            self.max_iterations = int(np.clip(its, 1, max_iterations))
        else:
            self.max_iterations = 1
        self.iterations_done = 0
        self.best_inliers = np.zeros(self.n, bool)
        self.best_n = 0
        self.best_R = None
        self.best_t = None
        # normalized coords for the DLT fallback
        self._uv_n = np.stack([
            (self.uv[:, 0] - cam.cx) / cam.fx,
            (self.uv[:, 1] - cam.cy) / cam.fy,
        ], 1)
        # unit bearing vectors (reference MLPnPsolver ctor :54-56, via the
        # camera model so fisheye works too)
        if self.n:
            b = np.asarray(cam.unproject_np(self.uv), np.float64)
            b /= np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
        else:
            b = np.zeros((0, 3))
        self._bearings = b

    def _inliers(self, R, t) -> np.ndarray:
        """Pixel-reprojection inlier check (reference CheckInliers
        :246-277, via the camera model)."""
        Xc = (self.Xw @ R.T + t).astype(np.float32)
        ok = Xc[:, 2] > 0
        if self.cam.is_fisheye:
            uv = np.asarray(self.cam.project_np(Xc))
            e2 = np.sum((uv - self.uv) ** 2, axis=1)
            return ok & (e2 < self.th2)
        z = np.where(ok, Xc[:, 2], 1.0)
        u = self.cam.fx * Xc[:, 0] / z + self.cam.cx
        v = self.cam.fy * Xc[:, 1] / z + self.cam.cy
        e2 = (u - self.uv[:, 0]) ** 2 + (v - self.uv[:, 1]) ** 2
        return ok & (e2 < self.th2)

    def iterate(self, n_iterations: int):
        """Returns (ok, Rcw, tcw, inliers, n_inliers, no_more)."""
        if self.n < self.min_set:
            return False, None, None, np.zeros(self.n, bool), 0, True
        it = 0
        while it < n_iterations and \
                self.iterations_done < self.max_iterations:
            it += 1
            self.iterations_done += 1
            idx = self.rng.choice(self.n, self.min_set, replace=False)
            res = _mlpnp_pose(self.Xw[idx], self._bearings[idx])
            if res is None:
                res = _dlt_pose(self.Xw[idx], self._uv_n[idx])
            if res is None:
                continue
            R, t = res
            inl = self._inliers(R, t)
            n_in = int(inl.sum())
            if n_in > self.best_n:
                self.best_n = n_in
                self.best_inliers = inl
                self.best_R, self.best_t = R, t
            if n_in >= self.min_inliers:
                # Refine (reference :279-331): MLPnP on all inliers,
                # then pixel-space GN polish
                res2 = _mlpnp_pose(self.Xw[inl], self._bearings[inl])
                if res2 is not None:
                    R, t = res2
                if self.cam.is_fisheye:
                    R2, t2 = R, t  # bearing-space GN already polished
                else:
                    R2, t2 = _gn_refine(R, t, self.Xw[inl], self.uv[inl],
                                        self.cam.fx, self.cam.fy,
                                        self.cam.cx, self.cam.cy)
                inl2 = self._inliers(R2, t2)
                if inl2.sum() >= self.min_inliers:
                    self.best_R, self.best_t = R2, t2
                    self.best_inliers = inl2
                    self.best_n = int(inl2.sum())
                    return (True, R2, t2, inl2, self.best_n,
                            self.iterations_done >= self.max_iterations)
        no_more = self.iterations_done >= self.max_iterations
        return False, self.best_R, self.best_t, self.best_inliers, \
            self.best_n, no_more
