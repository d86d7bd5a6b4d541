"""Per-frame pose optimization - the tracking hot path.

Port of ppg_slam_tpu/estimator/pose_opt.py (reference OptimizerPose.cpp):
  * pose_optimization: PoseOptimization (:26-160) - pose-only LM on Tcw,
    4 rounds x 10 iterations, Huber(sqrt 5.991) dropped after round 3,
    chi2-based inlier reclassification each round, the pose re-seeded from
    the initial estimate at the start of every round (:108-110).
  * pose_inertial_optimization: PoseInertialOptimizationLastFrame /
    LastKeyFrame (:177-466, :484-) - dense GN over the 15-D states of the
    current and previous frame (prev fixed for the LastKeyFrame variant),
    with the 9-D preintegration residual, bias random walks, the 15-D
    marginalization prior, depth-aware chi2 thresholds, a <30-inlier
    recovery pass, and Schur marginalization of the previous state into a
    new 15-D prior.

Both run on their inputs' device with a fixed iteration structure and every
accept/reject and classification decision kept on the device (no host
reads). The Jacobians are analytic: the per-observation reprojection rows
here, the inertial and prior rows from ba_core's closed forms (the
reference takes jax.jacfwd of the residual definitions, which the tests
hold these against with torch.func.jacfwd).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from ..device import StaticBuffers
from ..geometry import so3
from ..geometry.cameras import CameraModel
from ..utils import profiler
from .ba_core import (DOF, S_BA, S_BG, S_V, inertial_linearization,
                      prior15_linearization)
from .robust import huber_weight

CHI2_MONO = 5.991
HUBER_MONO = 2.447574  # sqrt(5.991)


# ---------------------------------------------------------------------------
# visual-only pose optimization (g2o VertexSE3Expmap convention: left-mult
# update on Tcw)
# ---------------------------------------------------------------------------

def _reproj_tcw(d6, Rcw, tcw, X, uv, cam: CameraModel):
    """One observation's residual under a left-multiplied pose update."""
    dR = so3.exp(d6[:3])
    return uv - cam.project((dR @ Rcw) @ X + dR @ tcw + d6[3:])


def _reproj_tcw_batch(Rcw, tcw, X, uv, cam: CameraModel, want_jac: bool):
    """(r (O, 2), J (O, 2, 6)): the residuals and the analytic Jacobian of
    `_reproj_tcw` at d6 = 0 (dXc/dtheta = -[Xc]x, dXc/drho = I)."""
    Xc = X @ Rcw.T + tcw
    r = uv - cam.project(Xc)
    if not want_jac:
        return r, None
    Jp = cam.project_jac(Xc)
    return r, torch.cat([Jp @ so3.hat(Xc), -Jp], dim=-1)


def pose_optimization(Rcw0, tcw0, X, uv, valid, cam: CameraModel):
    """Returns (Rcw, tcw, inlier (O,), n_inliers). X: (O, 3) world points."""
    profiler.count_device("pose_optimization", X)
    dtype, dev = tcw0.dtype, tcw0.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def lm_round(active, use_kernel, iters=10):
        Rc, tc = Rcw0, tcw0
        lam = torch.full((), 1e-5, dtype=dtype, device=dev)
        for _ in range(iters):
            r, J = _reproj_tcw_batch(Rc, tc, X, uv, cam, want_jac=True)
            chi2 = torch.sum(r * r, dim=1)
            w = huber_weight(chi2, HUBER_MONO) if use_kernel \
                else torch.ones_like(chi2)
            w = w * active
            H = torch.einsum("o,odi,odj->ij", w, J, J)
            g = torch.einsum("o,odi,od->i", w, J, r)
            cost = torch.sum(torch.where(active > 0, chi2, 0.0))
            dx = -torch.linalg.solve_ex(H + lam * eye6, g)[0]
            dR = so3.exp(dx[:3])
            Rn = so3.normalize(dR @ Rc)
            tn = dR @ tc + dx[3:]
            rn, _ = _reproj_tcw_batch(Rn, tn, X, uv, cam, want_jac=False)
            new_cost = torch.sum(torch.where(active > 0,
                                             torch.sum(rn * rn, dim=1), 0.0))
            ok = new_cost < cost
            Rc = torch.where(ok, Rn, Rc)
            tc = torch.where(ok, tn, tc)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        return Rc, tc

    inlier = valid
    Rf, tf = Rcw0, tcw0
    for rnd in range(4):
        Rf, tf = lm_round(inlier.to(dtype), use_kernel=(rnd < 3))
        r, _ = _reproj_tcw_batch(Rf, tf, X, uv, cam, want_jac=False)
        inlier = valid & (torch.sum(r * r, dim=1) <= CHI2_MONO)
    return Rf, tf, inlier, torch.sum(inlier)


# ---------------------------------------------------------------------------
# visual-inertial 2-frame pose optimization + marginalization
# ---------------------------------------------------------------------------

class FrameVIState(NamedTuple):
    R: torch.Tensor   # (3, 3) Rwb
    t: torch.Tensor   # (3,)
    v: torch.Tensor   # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)

    def retract(self, d):
        return FrameVIState(
            so3.normalize(self.R @ so3.exp(d[:3])), self.t + self.R @ d[3:6],
            self.v + d[S_V:S_BG], self.bg + d[S_BG:S_BA], self.ba + d[S_BA:])


class PreintData(NamedTuple):
    """Preintegration payload of one link (the device-side mirror of
    Preintegrated)."""
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    b0: torch.Tensor    # (6,)
    sqi: torch.Tensor   # (9, 9) sqrt information
    sqig: torch.Tensor  # (3, 3) gyro RW sqrt info
    sqia: torch.Tensor  # (3, 3) acc RW sqrt info
    dt: torch.Tensor    # ()


class Prior15(NamedTuple):
    """ConstraintPoseImu: linearization point + 15x15 Hessian."""
    R: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    H: torch.Tensor      # (15, 15)
    valid: torch.Tensor  # () bool


def _mono_res_body(d, R, t, X, uv, Rcb, tcb, cam):
    """One observation's residual and depth under a right-multiplied body
    pose update."""
    Rn = R @ so3.exp(d[:3])
    tn = t + R @ d[3:6]
    Xc = Rcb @ (Rn.T @ (X - tn)) + tcb
    return uv - cam.project(Xc), Xc[2]


def _mono_batch(R, t, X, uv, Rcb, tcb, cam, want_jac: bool):
    """(r (O, 2), depth (O,), J (O, 2, 6)): `_mono_res_body` for all
    observations with its analytic Jacobian at d = 0 (dXb/dtheta = [Xb]x,
    dXb/drho = -I)."""
    Xb = (X - t) @ R
    Xc = Xb @ Rcb.T + tcb
    r = uv - cam.project(Xc)
    if not want_jac:
        return r, Xc[:, 2], None
    JpR = cam.project_jac(Xc) @ Rcb
    return r, Xc[:, 2], torch.cat([-(JpR @ so3.hat(Xb)), JpR], dim=-1)


def _sqrtm_psd(H, cap=None):
    """Symmetric PSD square root via eigendecomposition (for whitening),
    the spectrum clamped to [0, cap]."""
    w, V = torch.linalg.eigh(0.5 * (H + H.T))
    return (V * torch.sqrt(torch.clamp(w, 0.0, cap))[None, :]) @ V.T


def _jacobi_solve(H, g):
    """Solve H dx = g with Jacobi (diagonal) preconditioning: the 2-frame
    system mixes ~1e8-scale whitened-preintegration blocks with ~1e2-scale
    vision blocks; normalizing to unit diagonal keeps the f32 solve stable."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hn = H * d[:, None] * d[None, :]
    Hn = Hn + 1e-6 * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(Hn, g * d)[0] * d


def marginalize_schur(H, keep_start: int):
    """Reference Marginalize(H, 0, 14) (OptimizerInertial.cpp:380-...):
    Schur-complement the leading `keep_start` variables away using an SVD
    pseudo-inverse; returns the trailing block."""
    a = H[:keep_start, :keep_start]
    b = H[:keep_start, keep_start:]
    c = H[keep_start:, keep_start:]
    u, s, vt = torch.linalg.svd(0.5 * (a + a.T))
    big = s > 1e-6
    s_inv = torch.where(big, 1.0 / torch.where(big, s, 1.0), 0.0)
    a_pinv = (vt.T * s_inv[None, :]) @ u.T
    return c - b.T @ a_pinv @ b


def _prior_sqrt(prior: Prior15):
    """The prior's whitening square root, its information spectrum capped at
    1e7 (sigma floor 3e-4): the KF-anchored marginal inherits ~1/preint-cov
    information, which a f32 GN cannot mix with ~1e2-scale vision blocks.
    The capped matrix is never formed: its square root comes from the same
    eigendecomposition. The eigh reads its status on the host (a sync).

    An invalid prior (LastKeyFrame's zeros) gives exactly 0, its eigh run on
    the identity: CUDA's eigh of an all-zero matrix returned finite and
    then NaN eigenvalues on successive calls with the same input on the
    H100, with no error, and NaN x 0 is NaN."""
    with profiler.timer("pose_inertial.prior_sqrt"):
        eye = torch.eye(DOF, dtype=prior.H.dtype, device=prior.H.device)
        sq = _sqrtm_psd(torch.where(prior.valid, prior.H, eye), cap=1e7)
        return torch.where(prior.valid, sq, 0.0)


def _pose_inertial_gn(curr: FrameVIState, prev: FrameVIState,
                      preint: PreintData, prior: Prior15, sq_prior, X, uv,
                      valid, close, Rcb, tcb, cam: CameraModel,
                      fix_prev: bool, rec_init: bool):
    """The 4 x 10 GN iterations, the inlier classification, the recovery
    pass and the 30x30 H at the final estimate: (curr', inlier, n_inliers,
    H30). Issues no host sync, so a CUDA graph can capture it."""
    dtype, dev = X.dtype, X.device

    def stacked(c: FrameVIState, p: FrameVIState):
        """Whitened [inertial(9), gyro walk(3), acc walk(3), prior(15)] and
        its Jacobians (30, 15) w.r.t. the curr and prev local updates."""
        ri, Jp_i, Jc_i = inertial_linearization(
            p.R, p.t, p.v, p.bg, p.ba, c.R, c.t, c.v, preint.dR, preint.dV,
            preint.dP, preint.JRg, preint.JVg, preint.JVa, preint.JPg,
            preint.JPa, preint.b0, preint.dt)
        rp, Jp_p = prior15_linearization(p.R, p.t, p.v, p.bg, p.ba, prior.R,
                                         prior.t, prior.v, prior.bg, prior.ba)
        r = torch.cat([preint.sqi @ ri, preint.sqig @ (c.bg - p.bg),
                       preint.sqia @ (c.ba - p.ba), sq_prior @ rp])
        Jc = X.new_zeros(2 * DOF, DOF)
        Jp = X.new_zeros(2 * DOF, DOF)
        Jc[0:9] = preint.sqi @ Jc_i
        Jp[0:9] = preint.sqi @ Jp_i
        for rows, sq, cols in ((slice(9, 12), preint.sqig,
                                slice(S_BG, S_BA)),
                               (slice(12, 15), preint.sqia,
                                slice(S_BA, DOF))):
            Jc[rows, cols] = sq
            Jp[rows, cols] = -sq
        Jp[15:] = sq_prior @ Jp_p
        return r, Jc, Jp

    def gn_round(c, p, active, use_kernel, iters=10):
        for _ in range(iters):
            rm, _, Jm = _mono_batch(c.R, c.t, X, uv, Rcb, tcb, cam,
                                    want_jac=True)
            chi2 = torch.sum(rm * rm, dim=1)
            wm = huber_weight(chi2, HUBER_MONO) if use_kernel \
                else torch.ones_like(chi2)
            wm = wm * active
            H = torch.zeros((2 * DOF, 2 * DOF), dtype=dtype, device=dev)
            g = torch.zeros((2 * DOF,), dtype=dtype, device=dev)
            # mono rows: pose columns of the current state only
            H[:6, :6] += torch.einsum("o,odi,odj->ij", wm, Jm, Jm)
            g[:6] += torch.einsum("o,odi,od->i", wm, Jm, rm)

            r_all, Jc, Jp = stacked(c, p)
            # prior robust kernel Huber(5.0) on its own chi2
            chi2p = torch.sum(r_all[15:30] * r_all[15:30])
            wp = huber_weight(chi2p, 5.0) * prior.valid
            wvec = torch.cat([torch.ones(15, dtype=dtype, device=dev),
                              wp.expand(15).to(dtype)])
            H[:DOF, :DOF] += torch.einsum("d,di,dj->ij", wvec, Jc, Jc)
            g[:DOF] += torch.einsum("d,di,d->i", wvec, Jc, r_all)
            if not fix_prev:
                H[DOF:, DOF:] += torch.einsum("d,di,dj->ij", wvec, Jp, Jp)
                H[:DOF, DOF:] += torch.einsum("d,di,dj->ij", wvec, Jc, Jp)
                H[DOF:, :DOF] += torch.einsum("d,di,dj->ij", wvec, Jp, Jc)
                g[DOF:] += torch.einsum("d,di,d->i", wvec, Jp, r_all)
                dx = -_jacobi_solve(H, g)
                c, p = c.retract(dx[:DOF]), p.retract(dx[DOF:])
            else:
                c = c.retract(-_jacobi_solve(H[:DOF, :DOF], g[:DOF]))
        return c, p

    inlier = valid
    c, p = curr, prev
    for rnd in range(4):
        c, p = gn_round(c, p, inlier.to(dtype), use_kernel=(rnd < 3))
        r, depth, _ = _mono_batch(c.R, c.t, X, uv, Rcb, tcb, cam, False)
        chi2 = torch.sum(r * r, dim=1)
        th = torch.where(close, 1.5 * CHI2_MONO, CHI2_MONO)
        inlier = valid & (chi2 <= th) & (depth > 0)
    n_in = torch.sum(inlier)

    # recovery pass: relaxed threshold 18.0 when < 30 inliers
    if not rec_init:
        relaxed = valid & (chi2 < 18.0)
        inlier = torch.where(n_in < 30, relaxed, inlier)
        n_in = torch.sum(inlier)

    # ---- marginalization: the 30x30 H at the final estimate ---------------
    _, Jc, Jp = stacked(c, p)
    J30 = torch.cat([Jp, Jc], dim=1)  # layout as the reference: [prev, curr]
    H30 = J30.T @ J30
    _, _, Jm = _mono_batch(c.R, c.t, X, uv, Rcb, tcb, cam, want_jac=True)
    H30[DOF:DOF + 6, DOF:DOF + 6] += torch.einsum(
        "o,odi,odj->ij", inlier.to(dtype), Jm, Jm)
    return c, inlier, n_in, H30


def _marginal_prior(c: FrameVIState, H30) -> Prior15:
    """The new 15-D prior of curr': the previous state Schur-complemented
    out of H30, then PSD-projected (the reference does so in the
    ConstraintPoseImu ctor, G2oEdge.h:350-403): Schur complements of
    near-singular f32 systems come out slightly indefinite. Its svd and
    eigh read their status on the host (a sync each)."""
    with profiler.timer("pose_inertial.marginal"):
        H_new = marginalize_schur(H30, DOF)
        w, V = torch.linalg.eigh(0.5 * (H_new + H_new.T))
        H_new = (V * torch.clamp(w, min=0.0)[None, :]) @ V.T
        return Prior15(R=c.R, t=c.t, v=c.v, bg=c.bg, ba=c.ba, H=H_new,
                       valid=torch.ones((), dtype=torch.bool,
                                        device=H30.device))


def pose_inertial_optimization(
    curr: FrameVIState, prev: FrameVIState, preint: PreintData,
    prior: Prior15, X, uv, valid, close, Rcb, tcb, cam: CameraModel,
    fix_prev: bool = False, rec_init: bool = False,
):
    """Returns (curr', inlier mask, n_inliers, new Prior15 for curr').

    fix_prev=True reproduces PoseInertialOptimizationLastKeyFrame (previous
    state fixed, no prior edge); otherwise LastFrame (prev free + 15-D prior).
    """
    profiler.count_device("pose_inertial_optimization", X)
    c, inlier, n_in, H30 = _pose_inertial_gn(
        curr, prev, preint, prior, _prior_sqrt(prior), X, uv, valid, close,
        Rcb, tcb, cam, fix_prev, rec_init)
    return c, inlier, n_in, _marginal_prior(c, H30)


# ---------------------------------------------------------------------------
# pose_inertial_optimization replayed from a CUDA graph (the tracking path)
# ---------------------------------------------------------------------------

def pad_observations(X, uv, valid, close, capacity: int):
    """Host observation arrays (n rows) padded to `capacity` rows. A padded
    row copies row 0, so it is finite wherever the real rows are (a weight
    of 0 times a NaN Jacobian would still poison H), and has valid and
    close False: it weighs 0 in every sum and is never an inlier."""
    n = len(X)
    if n > capacity:
        raise ValueError(f"{n} observations over the capacity {capacity}")
    rows = np.zeros(capacity, np.int64)
    rows[:n] = np.arange(n)
    real = np.arange(capacity) < n
    return (X[rows], uv[rows], np.asarray(valid, bool)[rows] & real,
            np.asarray(close, bool)[rows] & real)


class PoseInertialReplay:
    """pose_inertial_optimization on a CUDA device with its sync-free middle
    (_pose_inertial_gn: ~26k small launches at ~25 us of host issue each)
    replayed from a CUDA graph. The prior's eigh before it and the
    marginalization's svd and eigh after it read their status on the host,
    so they run eagerly on either side of the replay.

    One graph per (fix_prev, rec_init), captured at its first call into the
    instance's own memory pool; the graphs read static input buffers that
    each call fills with one host-to-device copy, observations padded to
    `capacity` rows (pad_observations). Calls with more rows do not fit:
    the caller runs pose_inertial_optimization itself."""

    def __init__(self, cam: CameraModel, capacity: int, device):
        self.cam, self.capacity = cam, capacity
        self.device = torch.device(device)
        C = capacity
        shapes = ([(3, 3), (3,), (3,), (3,), (3,)] * 2             # curr, prev
                  + [(3, 3), (3,), (3,)] + [(3, 3)] * 5            # preint
                  + [(6,), (9, 9), (3, 3), (3, 3), ()]
                  + [(3, 3), (3,), (3,), (3,), (3,), (DOF, DOF)]   # prior
                  + [(C, 3), (C, 2), (3, 3), (3,)]                 # X uv Rcb tcb
                  + [(C,), (C,), ()])               # valid close prior_valid
        self._buf = StaticBuffers([(s, torch.float32) for s in shapes],
                                  self.device)
        self._host, self._dev = self._buf.host, self._buf.dev
        self._sq_prior = torch.empty((DOF, DOF), dtype=torch.float32,
                                     device=self.device)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(self.device)
        self._graphs = {}  # (fix_prev, rec_init) -> (graph, its outputs)

    def _prior(self) -> Prior15:
        d = self._dev
        return Prior15(*d[23:29], valid=d[35] > 0.5)

    def _gn(self, fix_prev: bool, rec_init: bool):
        d = self._dev
        return _pose_inertial_gn(
            FrameVIState(*d[0:5]), FrameVIState(*d[5:10]),
            PreintData(*d[10:23]), self._prior(), self._sq_prior, d[29],
            d[30], d[33] > 0.5, d[34] > 0.5, d[31], d[32], self.cam,
            fix_prev, rec_init)

    def _capture(self, key):
        with profiler.timer("pose_inertial.capture"):
            # warm up on the capture stream first (cuBLAS and cuSOLVER
            # create their handles and workspaces lazily)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for _ in range(2):
                    self._gn(*key)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the threaded GBA and the prefetcher may touch
            # CUDA from other threads meanwhile
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self._gn(*key)
            self._graphs[key] = (graph, out)

    def __call__(self, curr, prev, preint, prior, prior_valid, X, uv, valid,
                 close, Rcb, tcb, fix_prev: bool, rec_init: bool = False):
        """pose_inertial_optimization's (curr', inlier, n_inliers, new
        Prior15) from host arrays: curr and prev the 5 of FrameVIState,
        preint the 13 of PreintData, prior the 6 of Prior15 before valid;
        X, uv, valid and close n <= capacity rows. The outputs are the
        graph's buffers, valid until the next call; inlier has `capacity`
        rows."""
        profiler.count_device("pose_inertial_optimization", self._dev[0])
        X, uv, valid, close = pad_observations(X, uv, valid, close,
                                               self.capacity)
        for dst, a in zip(self._host, [*curr, *prev, *preint, *prior, X, uv,
                                       Rcb, tcb, valid, close, prior_valid]):
            dst[...] = a
        with torch.cuda.device(self.device):
            # the eigh below waits for this copy, so the next call may
            # refill the pinned buffer
            self._buf.upload()
            self._sq_prior.copy_(_prior_sqrt(self._prior()))
            key = (bool(fix_prev), bool(rec_init))
            if key not in self._graphs:
                self._capture(key)
            graph, (c, inlier, n_in, H30) = self._graphs[key]
            with profiler.timer("pose_inertial.replay"):
                graph.replay()
            return c, inlier, n_in, _marginal_prior(c, H30)
