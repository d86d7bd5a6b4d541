"""Batched Gauss-Newton / Levenberg bundle adjustment in PyTorch.

Port of ppg_slam_tpu/estimator/ba_core.py, flat observation layout. One
solver serves every BA flavor of the reference (SURVEY.md §2.4;
Optimizer*.cpp):

  * KF states are uniform 15-DOF blocks [theta(3), t(3), v(3), bg(3), ba(3)]
    with a per-DOF free mask (visual-only BA frees [0:6]; fixed KFs free
    nothing).
  * residual types: reprojection (EdgeMono), 3-point colinearity
    (EdgeColine), 9-D IMU preintegration (EdgeInertial), bias random walks
    (EdgeGyroRW/EdgeAccRW), 15-D pose-IMU prior (EdgePriorPoseImu), bias
    priors (EdgePriorGyro/Acc). Reprojection, inertial links and priors are
    linearized analytically (_reproj_batch, inertial_linearization,
    prior15_linearization; the tests hold them against torch.func.jacfwd of
    the residual definitions, which the reference differentiates with
    jax.jacfwd); colines take torch.func.jacfwd, as in the reference.
  * robust kernels are IRLS weights (estimator.robust).
  * landmarks are eliminated with a Schur complement over the coline-aware
    block diagonal of Hll; the reduced (15N x 15N) system is solved with a
    dense Cholesky, or block-Jacobi PCG; the landmark back-substitution runs
    PCG with the coline cross-blocks.
  * implicit=True (the reference's `kfm=` path, for large windows) never
    forms the landmark-pose block W (M, 3, N*6) or the reduced matrix: the
    PCG applies S = Hpp - W^T Hll^-1 W observation by observation, in
    O(obs) a matvec, from the per-observation blocks.
  * mesh= (a parallel.Mesh) splits every residual family into equal
    contiguous slices, one a mesh device: each slice is linearized, and
    its chi2 and matvecs evaluated, on its own device; the sums meet on
    the lead device (Mesh.psum), where the reduced solve, the PCG vectors
    and the LM decisions run once. This is the reference's shard_map over
    its "dp" axis.

The reference's TPU workarounds are not ported: gathers are `t[idx]` and
scatters `index_add_` (no one-hot MXU products), and there is no slot-major
or kf-major observation layout (the implicit matvecs gather and
`index_add_` in the caller's row order). solve_ba solves a problem at its
own size; estimator.ba.LocalBAReplay pads local BAs to the reference's
shape buckets for its CUDA graphs.
The LM loop runs eagerly: each GN iteration reads one device scalar pair
(the exit test), the backtracking branch one more, and the reduced-system
PCG checks its exit every PCG_CHECK iterations; `info["host_syncs"]` counts
them. _lm_iteration(sync_free=True) is the iteration that reads nothing
(estimator.ba.LocalBAReplay's CUDA graphs hold it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..geometry import so3
from ..geometry.cameras import CameraModel
from ..imu.preintegration import GRAVITY_VALUE
from ..utils import profiler
from .robust import kernel_rho, kernel_weight

# state block layout
DOF = 15
S_TH, S_T, S_V, S_BG, S_BA = 0, 3, 6, 9, 12

# chi2_hist capacity (runs longer than this overwrite the last slot)
MAX_HIST = 32

# the reduced-system PCG reads its exit test every PCG_CHECK iterations;
# iterations past convergence are masked no-ops, so the result is the one
# an exit at the first converged iteration gives
PCG_CHECK = 16

HUBER_INERTIAL = 4.113393  # sqrt(16.92)

_INDEX_FIELDS = ("r_kf", "r_mp", "c_idx", "i_kf1", "i_kf2", "p_kf", "bp_kf")


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class KFStates(NamedTuple):
    """SoA keyframe states: body-in-world pose + velocity + biases."""

    R: torch.Tensor   # (N, 3, 3) Rwb
    t: torch.Tensor   # (N, 3) twb
    v: torch.Tensor   # (N, 3)
    bg: torch.Tensor  # (N, 3)
    ba: torch.Tensor  # (N, 3)

    def retract(self, dx: torch.Tensor) -> "KFStates":
        """dx: (N, 15) local update, ImuCamPose::Update convention
        (G2oVertex.cpp: twb += Rwb*ut; Rwb = Rwb*exp(ur))."""
        R = self.R @ so3.exp(dx[:, S_TH:S_T])
        t = self.t + _mv(self.R, dx[:, S_T:S_V])
        return KFStates(so3.normalize(R), t, self.v + dx[:, S_V:S_BG],
                        self.bg + dx[:, S_BG:S_BA], self.ba + dx[:, S_BA:])

    def select(self, cond: torch.Tensor, other: "KFStates") -> "KFStates":
        """Field-wise torch.where(cond, self, other) on a 0-d bool."""
        return KFStates(*(torch.where(cond, a, b) for a, b in zip(self, other)))


class BAProblem(NamedTuple):
    """Residual data. Index arrays refer to KF slot / MP slot. A family may
    be empty (length 0); `*_valid` masks individual rows."""

    # reprojection observations
    r_kf: torch.Tensor     # (O,) int64
    r_mp: torch.Tensor     # (O,) int64
    r_uv: torch.Tensor     # (O, 2)
    r_valid: torch.Tensor  # (O,) bool

    # colines (3 landmark indices + weight)
    c_idx: torch.Tensor    # (C, 3)
    c_w: torch.Tensor      # (C,) aveWeight -> information = I * w
    c_valid: torch.Tensor  # (C,) bool

    # inertial links
    i_kf1: torch.Tensor    # (L,)
    i_kf2: torch.Tensor    # (L,)
    i_dR: torch.Tensor     # (L, 3, 3) preintegrated deltas at bias i_b0
    i_dV: torch.Tensor     # (L, 3)
    i_dP: torch.Tensor     # (L, 3)
    i_JRg: torch.Tensor    # (L, 3, 3) bias Jacobians
    i_JVg: torch.Tensor
    i_JVa: torch.Tensor
    i_JPg: torch.Tensor
    i_JPa: torch.Tensor
    i_b0: torch.Tensor     # (L, 6) [bg, ba] linearization bias
    i_sqi: torch.Tensor    # (L, 9, 9) sqrt information
    i_dt: torch.Tensor     # (L,)
    i_valid: torch.Tensor  # (L,) bool
    i_huber: torch.Tensor  # (L,) bool - Huber(sqrt(16.92)) on this link

    # bias random walks (same links as inertial)
    rw_sqig: torch.Tensor  # (L, 3, 3) sqrt info gyro walk
    rw_sqia: torch.Tensor  # (L, 3, 3) sqrt info acc walk
    rw_valid: torch.Tensor  # (L,)

    # 15-D pose-imu prior (EdgePriorPoseImu)
    p_kf: torch.Tensor     # (P,)
    p_R: torch.Tensor      # (P, 3, 3)
    p_t: torch.Tensor      # (P, 3)
    p_v: torch.Tensor      # (P, 3)
    p_bg: torch.Tensor     # (P, 3)
    p_ba: torch.Tensor     # (P, 3)
    p_sqi: torch.Tensor    # (P, 15, 15)
    p_valid: torch.Tensor  # (P,)

    # bias priors (EdgePriorGyro/Acc): r = bg/ba of kf, info = I * w
    bp_kf: torch.Tensor    # (B,)
    bp_wg: torch.Tensor    # (B,)
    bp_wa: torch.Tensor    # (B,)
    bp_valid: torch.Tensor  # (B,)

    def to(self, device) -> "BAProblem":
        return BAProblem(*(x.to(device) for x in self))


def empty_problem(n_obs=0, n_col=0, n_links=0, n_priors=0, n_bp=0,
                  dtype=torch.float32, device=None) -> BAProblem:
    """All-invalid problem (building block for host assemblers)."""
    f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    i = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    eye = lambda k, n: torch.eye(k, dtype=dtype, device=device).expand(
        n, k, k).clone()
    return BAProblem(
        r_kf=i(n_obs), r_mp=i(n_obs), r_uv=f(n_obs, 2), r_valid=b(n_obs),
        c_idx=i(n_col, 3), c_w=f(n_col), c_valid=b(n_col),
        i_kf1=i(n_links), i_kf2=i(n_links), i_dR=eye(3, n_links),
        i_dV=f(n_links, 3), i_dP=f(n_links, 3), i_JRg=f(n_links, 3, 3),
        i_JVg=f(n_links, 3, 3), i_JVa=f(n_links, 3, 3),
        i_JPg=f(n_links, 3, 3), i_JPa=f(n_links, 3, 3), i_b0=f(n_links, 6),
        i_sqi=eye(9, n_links), i_dt=f(n_links), i_valid=b(n_links),
        i_huber=b(n_links),
        rw_sqig=eye(3, n_links), rw_sqia=eye(3, n_links), rw_valid=b(n_links),
        p_kf=i(n_priors), p_R=eye(3, n_priors), p_t=f(n_priors, 3),
        p_v=f(n_priors, 3), p_bg=f(n_priors, 3), p_ba=f(n_priors, 3),
        p_sqi=eye(15, n_priors), p_valid=b(n_priors),
        bp_kf=i(n_bp), bp_wg=f(n_bp), bp_wa=f(n_bp), bp_valid=b(n_bp),
    )


@dataclasses.dataclass(frozen=True)
class BAOptions:
    """Solver configuration (the reference's BAOptions, as plain data)."""

    iters: int = 10
    lambda0: float = 1e-5           # g2o userLambdaInit of the BA flavor
    adapt: bool = True              # reject worse steps, grow lambda
    reproj_kernel: str = "cauchy"   # LBA/GBA mapping default
    reproj_delta: float = 2.447574  # sqrt(5.991)
    coline_kernel: str = "huber"
    coline_delta: float = 2.795532  # sqrt(7.815)
    pcg_iters: int = 4              # landmark-system PCG (coline coupling)
    chi2_inlier_mono: float = 5.991
    # stop once the accepted chi2 gain stays below tol (relative) for two
    # consecutive accepted iterations, or after 16 consecutive rejections;
    # 0 disables both and always runs `iters`
    tol: float = 1e-3
    # reduced-pose-system solver: 0 = dense Cholesky, >0 = block-Jacobi PCG
    # with that iteration cap (exit at 1e-6 relative residual). None = the
    # reference's backend default: PCG(64) on an accelerator (CUDA here),
    # Cholesky on the CPU
    pose_cg_iters: Optional[int] = None
    # retry a rejected step at alpha = 1/4 and 1/16 before growing lambda.
    # None = the backend default: on for CUDA, off on the CPU
    backtrack: Optional[bool] = None


def resolve_pose_cg(v, device) -> int:
    """None -> 64 on an accelerator, 0 (Cholesky) on the CPU."""
    if v is None:
        return 64 if torch.device(device).type != "cpu" else 0
    return int(v)


def resolve_backtrack(v, device) -> bool:
    """None -> on for an accelerator, off on the CPU."""
    if v is None:
        return torch.device(device).type != "cpu"
    return bool(v)


# ---------------------------------------------------------------------------
# residual functions (delta at zero -> jacfwd gives GN Jacobians)
# ---------------------------------------------------------------------------

def _perturb_pose(R, t, d6):
    return R @ so3.exp(d6[:3]), t + R @ d6[3:6]


def make_reproj_residual(cam: CameraModel, Rcb, tcb):
    """uv - project(Tcb * Twb(kf)^-1 * X) (EdgeMono, G2oEdge.cpp:14-20)."""

    def res(d_kf, d_mp, R, t, X, uv):
        Rn, tn = _perturb_pose(R, t, d_kf[:6])
        Xb = Rn.T @ (X + d_mp - tn)
        return uv - cam.project(Rcb @ Xb + tcb)

    return res


def coline_residual(d1, d2, d3, X1, X2, X3):
    """normalize(p2-p1) x normalize(p3-p2) (EdgeColine, G2oEdge.cpp:689-707),
    the norm smoothed with a small epsilon so the Jacobian stays finite on
    degenerate entries."""
    v1 = (X2 + d2) - (X1 + d1)
    v2 = (X3 + d3) - (X2 + d2)
    n1 = v1 * torch.rsqrt(torch.sum(v1 * v1, -1, keepdim=True) + 1e-12)
    n2 = v2 * torch.rsqrt(torch.sum(v2 * v2, -1, keepdim=True) + 1e-12)
    return torch.linalg.cross(n1, n2)


def _gravity(like):
    """(0, 0, -g) made on like's device: a host tensor copied there would
    wait for the copy (a sync each call) and cannot be captured in a CUDA
    graph."""
    g = like.new_zeros(3)
    g[2:].fill_(-GRAVITY_VALUE)
    return g


def inertial_residual(d1, d2, R1, t1, v1, bg1, ba1, R2, t2, v2,
                      dRm, dVm, dPm, JRg, JVg, JVa, JPg, JPa, b0, dt):
    """9-D preintegration residual (EdgeInertial::computeError,
    G2oEdge.cpp:241-262) with first-order bias correction."""
    R1n, t1n = _perturb_pose(R1, t1, d1[:6])
    v1n = v1 + d1[S_V:S_BG]
    bg = bg1 + d1[S_BG:S_BA]
    ba = ba1 + d1[S_BA:]
    R2n, t2n = _perturb_pose(R2, t2, d2[:6])
    v2n = v2 + d2[S_V:S_BG]

    dbg = bg - b0[:3]
    dba = ba - b0[3:]
    dR = dRm @ so3.exp(JRg @ dbg)
    dV = dVm + JVg @ dbg + JVa @ dba
    dP = dPm + JPg @ dbg + JPa @ dba

    g = _gravity(R1)
    er = so3.log(dR.T @ R1n.T @ R2n)
    ev = R1n.T @ (v2n - v1n - g * dt) - dV
    ep = R1n.T @ (t2n - t1n - v1n * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep])


def prior15_residual(d, R, t, v, bg, ba, R0, t0, v0, bg0, ba0):
    """EdgePriorPoseImu::computeError (G2oEdge.cpp)."""
    Rn, tn = _perturb_pose(R, t, d[:6])
    er = so3.log(R0.T @ Rn)
    et = R0.T @ (tn - t0)
    ev = (v + d[S_V:S_BG]) - v0
    ebg = (bg + d[S_BG:S_BA]) - bg0
    eba = (ba + d[S_BA:]) - ba0
    return torch.cat([er, et, ev, ebg, eba])


def _mT(M):
    return M.transpose(-1, -2)


def inertial_linearization(R1, t1, v1, bg1, ba1, R2, t2, v2, dRm, dVm, dPm,
                           JRg, JVg, JVa, JPg, JPa, b0, dt):
    """`inertial_residual` at zero deltas with its Jacobians (..., 9, 15)
    w.r.t. both states' local updates, in closed form
    (EdgeInertial::linearizeOplus, G2oEdge.cpp): the same values jacfwd
    gives, from about a tenth of the kernels. Batched over leading axes."""
    dbg = bg1 - b0[..., :3]
    dba = ba1 - b0[..., 3:]
    phi = _mv(JRg, dbg)
    dR = dRm @ so3.exp(phi)
    dV = dVm + _mv(JVg, dbg) + _mv(JVa, dba)
    dP = dPm + _mv(JPg, dbg) + _mv(JPa, dba)
    g = _gravity(R1)
    dt_ = dt[..., None]
    R1T = _mT(R1)
    E = _mT(dR) @ R1T @ R2
    er = so3.log(E)
    u = _mv(R1T, v2 - v1 - g * dt_)
    w = _mv(R1T, t2 - t1 - v1 * dt_ - 0.5 * g * dt_ * dt_)
    Jinv = so3.inverse_right_jacobian(er)
    eye = torch.eye(3, dtype=R1.dtype, device=R1.device).expand(R1.shape)
    J1 = R1.new_zeros(R1.shape[:-2] + (9, DOF))
    J2 = R1.new_zeros(R1.shape[:-2] + (9, DOF))
    J1[..., 0:3, S_TH:S_T] = -Jinv @ _mT(R2) @ R1
    J1[..., 0:3, S_BG:S_BA] = -Jinv @ _mT(E) @ so3.right_jacobian(phi) @ JRg
    J1[..., 3:6, S_TH:S_T] = so3.hat(u)
    J1[..., 3:6, S_V:S_BG] = -R1T
    J1[..., 3:6, S_BG:S_BA] = -JVg
    J1[..., 3:6, S_BA:] = -JVa
    J1[..., 6:9, S_TH:S_T] = so3.hat(w)
    J1[..., 6:9, S_T:S_V] = -eye
    J1[..., 6:9, S_V:S_BG] = -R1T * dt_[..., None]
    J1[..., 6:9, S_BG:S_BA] = -JPg
    J1[..., 6:9, S_BA:] = -JPa
    J2[..., 0:3, S_TH:S_T] = Jinv
    J2[..., 3:6, S_V:S_BG] = R1T
    J2[..., 6:9, S_T:S_V] = R1T @ R2
    return torch.cat([er, u - dV, w - dP], dim=-1), J1, J2


def prior15_linearization(R, t, v, bg, ba, R0, t0, v0, bg0, ba0):
    """`prior15_residual` at zero delta with its Jacobian (..., 15, 15), in
    closed form. Batched over leading axes."""
    R0T = _mT(R0)
    er = so3.log(R0T @ R)
    Jp = R.new_zeros(R.shape[:-2] + (DOF, DOF))
    Jp[..., S_TH:S_T, S_TH:S_T] = so3.inverse_right_jacobian(er)
    Jp[..., S_T:S_V, S_T:S_V] = R0T @ R
    torch.diagonal(Jp[..., S_V:, S_V:], dim1=-2, dim2=-1).fill_(1.0)
    r = torch.cat([er, _mv(R0T, t - t0), v - v0, bg - bg0, ba - ba0], dim=-1)
    return r, Jp


def _with_aux(f):
    """f -> (f, f) for jacfwd(has_aux=True): the residual with its
    Jacobian in one forward pass."""

    def g(*args):
        r = f(*args)
        return r, r

    return g


# ---------------------------------------------------------------------------
# assembly helpers
# ---------------------------------------------------------------------------

def _whiten(J, r, sqi):
    """Apply sqrt information: J' = sqi @ J, r' = sqi @ r."""
    return sqi @ J, sqi @ r


def _reproj_batch(cam: CameraModel, Rcb, tcb, Rg, tg, Xg, uv,
                  want_jac: bool):
    """Batched reprojection residual (+ analytic Jacobians): exactly the
    linearization jacfwd gives of `make_reproj_residual` at delta = 0.

    Returns (r (O,2), depth (O,), Jk (O,2,6), Jx (O,2,3)); the Jacobians
    are None when want_jac is False."""
    d = Xg - tg
    Xb = torch.sum(Rg * d[:, :, None], dim=1)          # R^T d
    Xc = Xb @ Rcb.T + tcb
    r = uv - cam.project(Xc)
    depth = Xc[..., 2]
    if not want_jac:
        return r, depth, None, None
    Jp = cam.project_jac(Xc)                           # (O, 2, 3)
    A = Rcb @ Rg.transpose(1, 2)                       # dXc/dX
    B = Rcb @ so3.hat(Xb)                              # dXc/dtheta
    Jx = -(Jp @ A)
    Jth = -(Jp @ B)
    Jdt = Jp @ Rcb                                     # dr/d(dt)
    return r, depth, torch.cat([Jth, Jdt], dim=-1), Jx


def _inv3x3(A):
    """Closed-form batched 3x3 inverse via the adjugate (callers pass
    regularized SPD blocks). A finite block whose f32 determinant overflows
    gets a zero inverse, which holds its landmark still for the step: its
    true inverse is below 1e-12 anyway. Such a block belongs to a landmark
    on a coline of huge weight (entries of ~1e13). The JAX package's
    jit-compiled solver returns this zero block (its fused multiply-adds
    carry the determinant to inf, and cofactor * (1 / inf) is 0); the same
    arithmetic run op by op gives inf - inf = NaN, and a NaN step that
    rejects every iteration of the solve. Every other block follows the
    reference's arithmetic: a determinant of exactly 0, or a NaN or an
    infinity in the block, still gives a non-finite inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    rows = torch.stack([
        torch.stack([c11, c12, c13], -1),
        torch.stack([c21, c22, c23], -1),
        torch.stack([c31, c32, c33], -1),
    ], -2)
    # a NaN or an infinity in the block makes some cofactor non-finite
    overflow = torch.isfinite(rows).all(-1).all(-1) & ~torch.isfinite(det)
    inv_det = torch.where(overflow, 0.0, 1.0 / det)
    return rows * inv_det[..., None, None]


def _outer(Ja, Jb):
    """Per-row Ja^T Jb: (K, d, i), (K, d, j) -> (K, i, j)."""
    return Ja.transpose(1, 2) @ Jb


def _jtr(J, r):
    """Per-row J^T r: (K, d, i), (K, d) -> (K, i)."""
    return (J.transpose(1, 2) @ r[..., None])[..., 0]


def _pad15(blk, rows: slice, cols: slice):
    """Place (K, a, b) blocks at [rows, cols] of zero (K, 15, 15) blocks."""
    out = blk.new_zeros(blk.shape[0], DOF, DOF)
    out[:, rows, cols] = blk
    return out


def _coline_batch(points, c_idx):
    """Residuals (C, 3) and the three (C, 3, 3) Jacobians of every coline."""
    z3 = points.new_zeros(3)

    def one(X1, X2, X3):
        (J1, J2, J3), rc = jacfwd(_with_aux(coline_residual),
                                  argnums=(0, 1, 2), has_aux=True)(
            z3, z3, z3, X1, X2, X3)
        return rc, J1, J2, J3

    return vmap(one)(points[c_idx[:, 0]], points[c_idx[:, 1]],
                     points[c_idx[:, 2]])


def _link_args(states: KFStates, prob: BAProblem):
    k1, k2 = prob.i_kf1, prob.i_kf2
    return (states.R[k1], states.t[k1], states.v[k1], states.bg[k1],
            states.ba[k1], states.R[k2], states.t[k2], states.v[k2],
            prob.i_dR, prob.i_dV, prob.i_dP, prob.i_JRg, prob.i_JVg,
            prob.i_JVa, prob.i_JPg, prob.i_JPa, prob.i_b0, prob.i_dt)


def _prior_args(states: KFStates, prob: BAProblem):
    k = prob.p_kf
    return (states.R[k], states.t[k], states.v[k], states.bg[k], states.ba[k],
            prob.p_R, prob.p_t, prob.p_v, prob.p_bg, prob.p_ba)


def _inertial_batch(states, prob, want_jac: bool):
    """Whitened link residuals (L, 9) and, with want_jac, their (L, 9, 15)
    Jacobians w.r.t. both states."""
    ri, Ja, Jb = inertial_linearization(*_link_args(states, prob))
    if not want_jac:
        return _mv(prob.i_sqi, ri), None, None
    return _mv(prob.i_sqi, ri), prob.i_sqi @ Ja, prob.i_sqi @ Jb


def _prior_batch(states, prob, want_jac: bool):
    rp, Jp = prior15_linearization(*_prior_args(states, prob))
    if not want_jac:
        return _mv(prob.p_sqi, rp), None
    return _mv(prob.p_sqi, rp), prob.p_sqi @ Jp


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _compute_all(states: KFStates, points, prob: BAProblem, cam, Rcb, tcb,
                 opts: BAOptions, kf_dof, mp_free, implicit: bool = False):
    """One linearization: whitened residuals, Jacobians, robust weights.

    Returns (total_chi2, Hpp (N15, N15), b_p (N15,), Hll (M,3,3),
    Hll_col (M,3,3), b_l (M,3), W (M, 3, N*6), coline terms). W spans only
    the 6 pose columns of each keyframe: reprojection is the only family
    that couples landmarks to keyframes, and it does not depend on velocity
    or bias. Hll_col holds the colines' landmark-diagonal blocks apart from
    the visual Hll (the solver folds with their sum). With implicit, W is
    never formed and its place holds the raw per-observation blocks Bw
    (O, 3, 6), robust weight and free masks applied (the reference's
    materialize_w=False)."""
    n = states.R.shape[0]
    m = points.shape[0]
    n15 = n * DOF
    dtype = points.dtype
    dev = points.device

    # Hpp as (N*N, 15, 15) blocks: block (i, j) at row i*N + j
    Hblk = points.new_zeros(n * n, DOF, DOF)
    b_p = points.new_zeros(n, DOF)
    Hll = points.new_zeros(m, 3, 3)
    Hll_col = points.new_zeros(m, 3, 3)
    b_l = points.new_zeros(m, 3)
    W = None if implicit else points.new_zeros(m * n, 3, 6)
    Bw = points.new_zeros(0, 3, 6)
    chi2_sum = points.new_zeros(())

    dof_mask = kf_dof.to(dtype)   # (N, 15)
    mp_mask = mp_free.to(dtype)   # (M,)

    # ---- reprojection ---------------------------------------------------
    r_kf, r_mp = prob.r_kf, prob.r_mp
    if r_kf.numel():
        r, _, Jk, Jx = _reproj_batch(cam, Rcb, tcb, states.R[r_kf],
                                     states.t[r_kf], points[r_mp], prob.r_uv,
                                     want_jac=True)
        rv = prob.r_valid[:, None]
        r = torch.where(rv, r, 0.0)
        Jk = torch.where(rv[..., None], Jk, 0.0)
        Jx = torch.where(rv[..., None], Jx, 0.0)
        chi2 = torch.sum(r * r, dim=1)
        w = kernel_weight(opts.reproj_kernel, chi2, opts.reproj_delta) \
            * prob.r_valid
        chi2_sum = chi2_sum + torch.sum(torch.where(
            prob.r_valid, kernel_rho(opts.reproj_kernel, chi2,
                                     opts.reproj_delta), 0.0))
        Jk = Jk * dof_mask[r_kf, :6][:, None, :]
        Jx = Jx * mp_mask[r_mp][:, None, None]
        sw = w[:, None, None]
        Hkk = points.new_zeros(n, 6, 6).index_add_(0, r_kf, sw * _outer(Jk, Jk))
        Hblk[torch.arange(n, device=dev) * (n + 1), :6, :6] += Hkk
        b_p[:, :6] += points.new_zeros(n, 6).index_add_(
            0, r_kf, w[:, None] * _jtr(Jk, r))
        Hll.index_add_(0, r_mp, sw * _outer(Jx, Jx))
        b_l.index_add_(0, r_mp, w[:, None] * _jtr(Jx, r))
        Bw = sw * _outer(Jx, Jk)                       # (O, 3, 6)
        if not implicit:
            W.index_add_(0, r_mp * n + r_kf, Bw)
    if implicit:
        W = Bw
    else:
        W = W.reshape(m, n, 3, 6).permute(0, 2, 1, 3).reshape(m, 3, n * 6)

    # ---- colines --------------------------------------------------------
    c_idx = prob.c_idx
    if c_idx.shape[0]:
        rc, J1, J2, J3 = _coline_batch(points, c_idx)
        chi2c = torch.sum(rc * rc, dim=1) * prob.c_w
        wc = kernel_weight(opts.coline_kernel, chi2c, opts.coline_delta) \
            * prob.c_valid * prob.c_w  # includes the information weight
        chi2_sum = chi2_sum + torch.sum(torch.where(
            prob.c_valid, kernel_rho(opts.coline_kernel, chi2c,
                                     opts.coline_delta), 0.0))
        # sanitize invalid rows by selection (0 * nan = nan)
        cv = prob.c_valid[:, None, None]
        rc = torch.where(prob.c_valid[:, None], rc, 0.0)
        Js = [torch.where(cv, J, 0.0) * mp_mask[c_idx[:, a]][:, None, None]
              for a, J in enumerate((J1, J2, J3))]
        swc = wc[:, None, None]
        for a in range(3):
            Hll_col.index_add_(0, c_idx[:, a], swc * _outer(Js[a], Js[a]))
            b_l.index_add_(0, c_idx[:, a], wc[:, None] * _jtr(Js[a], rc))
    else:
        rc, Js, wc = None, None, None
    coline_terms = (rc, Js, wc)

    k1, k2 = prob.i_kf1, prob.i_kf2
    if k1.numel():
        # ---- inertial links -----------------------------------------------
        ri, Ja, Jb = _inertial_batch(states, prob, want_jac=True)
        chi2i = torch.sum(ri * ri, dim=1)
        wi = torch.where(prob.i_huber,
                         kernel_weight(1, chi2i, HUBER_INERTIAL), 1.0) \
            * prob.i_valid
        chi2_sum = chi2_sum + torch.sum(torch.where(
            prob.i_valid, torch.where(prob.i_huber,
                                      kernel_rho(1, chi2i, HUBER_INERTIAL),
                                      chi2i), 0.0))
        Ja = Ja * dof_mask[k1][:, None, :]
        Jb = Jb * dof_mask[k2][:, None, :]
        swi = wi[:, None, None]
        Hblk.index_add_(0, k1 * n + k1, swi * _outer(Ja, Ja))
        Hblk.index_add_(0, k2 * n + k2, swi * _outer(Jb, Jb))
        Hblk.index_add_(0, k1 * n + k2, swi * _outer(Ja, Jb))
        Hblk.index_add_(0, k2 * n + k1, swi * _outer(Jb, Ja))
        b_p.index_add_(0, k1, wi[:, None] * _jtr(Ja, ri))
        b_p.index_add_(0, k2, wi[:, None] * _jtr(Jb, ri))

        # ---- bias random walks (r = b2 - b1, J = [-I, +I], whitened) ------
        wrw = prob.rw_valid.to(dtype)
        for slot, sq, b in ((S_BG, prob.rw_sqig, states.bg),
                            (S_BA, prob.rw_sqia, states.ba)):
            rrw = _mv(sq, b[k2] - b[k1])
            chi2_sum = chi2_sum + torch.sum(torch.where(
                prob.rw_valid, torch.sum(rrw * rrw, dim=1), 0.0))
            sl = slice(slot, slot + 3)
            Jw1 = -sq * dof_mask[k1][:, sl][:, None, :]
            Jw2 = sq * dof_mask[k2][:, sl][:, None, :]
            sw = wrw[:, None, None]
            blk12 = sw * _outer(Jw1, Jw2)
            Hblk.index_add_(0, k1 * n + k1, _pad15(sw * _outer(Jw1, Jw1), sl, sl))
            Hblk.index_add_(0, k2 * n + k2, _pad15(sw * _outer(Jw2, Jw2), sl, sl))
            Hblk.index_add_(0, k1 * n + k2, _pad15(blk12, sl, sl))
            Hblk.index_add_(0, k2 * n + k1,
                            _pad15(blk12.transpose(1, 2), sl, sl))
            g1 = points.new_zeros(k1.shape[0], DOF)
            g1[:, sl] = wrw[:, None] * _jtr(Jw1, rrw)
            g2 = points.new_zeros(k1.shape[0], DOF)
            g2[:, sl] = wrw[:, None] * _jtr(Jw2, rrw)
            b_p.index_add_(0, k1, g1)
            b_p.index_add_(0, k2, g2)

    # ---- 15-D priors -------------------------------------------------------
    pk = prob.p_kf
    if pk.numel():
        rp, Jp = _prior_batch(states, prob, want_jac=True)
        wp = prob.p_valid.to(dtype)
        chi2_sum = chi2_sum + torch.sum(torch.where(
            prob.p_valid, torch.sum(rp * rp, dim=1), 0.0))
        Jp = Jp * dof_mask[pk][:, None, :]
        Hblk.index_add_(0, pk * n + pk, wp[:, None, None] * _outer(Jp, Jp))
        b_p.index_add_(0, pk, wp[:, None] * _jtr(Jp, rp))

    # ---- bias priors (diagonal) --------------------------------------------
    bk = prob.bp_kf
    if bk.numel():
        wbg = prob.bp_wg * prob.bp_valid
        wba = prob.bp_wa * prob.bp_valid
        bg_v = states.bg[bk]
        ba_v = states.ba[bk]
        chi2_sum = chi2_sum + torch.sum(wbg * torch.sum(bg_v * bg_v, 1)
                                        + wba * torch.sum(ba_v * ba_v, 1))
        mgg = kf_dof[bk, S_BG:S_BA].to(dtype)
        mba = kf_dof[bk, S_BA:].to(dtype)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        sg, sa = slice(S_BG, S_BA), slice(S_BA, DOF)
        Hblk.index_add_(0, bk * n + bk, _pad15(
            wbg[:, None, None] * eye3 * mgg[:, :, None] * mgg[:, None, :],
            sg, sg))
        Hblk.index_add_(0, bk * n + bk, _pad15(
            wba[:, None, None] * eye3 * mba[:, :, None] * mba[:, None, :],
            sa, sa))
        gb = points.new_zeros(bk.shape[0], DOF)
        gb[:, sg] = wbg[:, None] * bg_v * mgg
        gb[:, sa] = wba[:, None] * ba_v * mba
        b_p.index_add_(0, bk, gb)

    Hpp = Hblk.reshape(n, n, DOF, DOF).permute(0, 2, 1, 3).reshape(n15, n15)
    return (chi2_sum, Hpp, b_p.reshape(n15), Hll, Hll_col, b_l, W,
            coline_terms)


def _chi2_only(states, points, prob, cam, Rcb, tcb, opts):
    """Total robust cost at a state (for the LM step accept/reject)."""
    total = points.new_zeros(())
    if prob.r_kf.numel():
        r, _, _, _ = _reproj_batch(cam, Rcb, tcb, states.R[prob.r_kf],
                                   states.t[prob.r_kf], points[prob.r_mp],
                                   prob.r_uv, want_jac=False)
        chi2 = torch.sum(r * r, dim=1)
        total = total + torch.sum(torch.where(
            prob.r_valid, kernel_rho(opts.reproj_kernel, chi2,
                                     opts.reproj_delta), 0.0))
    if prob.c_idx.shape[0]:
        z3 = points.new_zeros(3)
        c = prob.c_idx
        rc = vmap(lambda X1, X2, X3: coline_residual(z3, z3, z3, X1, X2, X3))(
            points[c[:, 0]], points[c[:, 1]], points[c[:, 2]])
        chi2c = torch.sum(rc * rc, dim=1) * prob.c_w
        total = total + torch.sum(torch.where(
            prob.c_valid, kernel_rho(opts.coline_kernel, chi2c,
                                     opts.coline_delta), 0.0))
    k1, k2 = prob.i_kf1, prob.i_kf2
    if k1.numel():
        ri, _, _ = _inertial_batch(states, prob, want_jac=False)
        chi2i = torch.sum(ri * ri, dim=1)
        total = total + torch.sum(torch.where(
            prob.i_valid, torch.where(prob.i_huber,
                                      kernel_rho(1, chi2i, HUBER_INERTIAL),
                                      chi2i), 0.0))
        for sq, b in ((prob.rw_sqig, states.bg), (prob.rw_sqia, states.ba)):
            rrw = _mv(sq, b[k2] - b[k1])
            total = total + torch.sum(torch.where(
                prob.rw_valid, torch.sum(rrw * rrw, 1), 0.0))
    if prob.p_kf.numel():
        rp, _ = _prior_batch(states, prob, want_jac=False)
        total = total + torch.sum(torch.where(prob.p_valid,
                                              torch.sum(rp * rp, 1), 0.0))
    if prob.bp_kf.numel():
        wbg = prob.bp_wg * prob.bp_valid
        wba = prob.bp_wa * prob.bp_valid
        total = total + torch.sum(
            wbg * torch.sum(states.bg[prob.bp_kf] ** 2, 1)
            + wba * torch.sum(states.ba[prob.bp_kf] ** 2, 1))
    return total


def _pcg(S_mv, d_inv, rhs, iters: int, syncs: list, poll: bool = True):
    """Jacobi-preconditioned CG on the damped SPD reduced system: the
    operator `S_mv` (x -> S x), the preconditioner the inverse diagonal
    `d_inv`; up to `iters` iterations, exit at 1e-6 relative residual
    (read on the host every PCG_CHECK iterations where `poll`)."""
    x = torch.zeros_like(rhs)
    r = rhs
    z = r * d_inv
    p = z
    rz = torch.dot(r, z)
    thresh = 1e-12 * torch.dot(r, r)
    active = torch.ones((), dtype=torch.bool, device=rhs.device)
    for it in range(iters):
        if poll and it and it % PCG_CHECK == 0:
            syncs[0] += 1
            if not bool(active):
                break
        active = active & (torch.dot(r, r) > thresh)
        Sp = S_mv(p)
        alpha = rz / torch.clamp(torch.dot(p, Sp), min=1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Sp
        z_n = r_n * d_inv
        rz_n = torch.dot(r_n, z_n)
        beta = rz_n / torch.clamp(rz, min=1e-30)
        p_n = z_n + beta * p
        x, r, p, rz = (torch.where(active, a, b) for a, b in
                       ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return x


def _on(states: KFStates, device) -> KFStates:
    return KFStates(*(x.to(device) for x in states))


def split_problem(prob: BAProblem, n: int) -> list:
    """`n` problems of equal contiguous slices of every residual family of
    `prob`; each family's length must be a multiple of n
    (parallel.pad_problem_for_mesh pads it so)."""
    sizes = {name: getattr(prob, name).shape[0] for name in BAProblem._fields}
    for name, size in sizes.items():
        if size % n:
            raise ValueError(f"split_problem: {name} has {size} rows, not a "
                             f"multiple of {n} (pad_problem_for_mesh first)")
    return [BAProblem(*(x[k * (x.shape[0] // n):(k + 1) * (x.shape[0] // n)]
                        for x in prob)) for k in range(n)]


def solve_ba(states: KFStates, points: torch.Tensor, prob: BAProblem,
             kf_dof: torch.Tensor, mp_free: torch.Tensor, Rcb: torch.Tensor,
             tcb: torch.Tensor, cam: CameraModel, opts: BAOptions,
             implicit: bool = False, mesh=None):
    """Damped-GN iterations on the tensors' device. Returns (states, points,
    info).

    info: chi2_hist (MAX_HIST,) for diagnostics, final_chi2, the final
    damping `lam` (chunked callers resume by passing it back as
    opts.lambda0, ba._padded_solve), iters_run, `accepted` (one bool an
    iteration), the final per-observation chi2 and depth for the callers'
    outlier classification, and host_syncs (device scalars the host read).

    implicit: solve the reduced pose system matrix-free (module docstring);
    the same system as the dense fold to round-off. It takes the PCG only:
    with a pose solve that resolves to Cholesky it raises ValueError.
    mesh: a parallel.Mesh whose lead device holds the tensors; every
    residual family's length a multiple of mesh.size (solve_ba_sharded
    pads them)."""
    dev = points.device
    if implicit and resolve_pose_cg(opts.pose_cg_iters, dev) <= 0:
        raise ValueError("solve_ba(implicit=True) solves the reduced system "
                         "by PCG only: there is no Cholesky on an implicit "
                         "operator (pose_cg_iters resolved to 0)")
    if mesh is not None and torch.device(dev) != mesh.lead:
        raise ValueError(f"solve_ba(mesh=): the tensors are on {dev}, the "
                         f"mesh's lead device is {mesh.lead}")
    profiler.count_device("solve_ba", points)
    if implicit:
        profiler.count_device("solve_ba_implicit", points)
    if mesh is not None:
        profiler.count_device("solve_ba_sharded", points)
    syncs = [0]
    solve_iter, shards = _lm_iteration(states, points, prob, kf_dof, mp_free,
                                       Rcb, tcb, cam, opts, implicit, mesh,
                                       syncs)
    hist = points.new_zeros(MAX_HIST)
    # states, points, damping, last accepted chi2
    carry = [states, points,
             torch.as_tensor(opts.lambda0, dtype=points.dtype, device=dev),
             torch.full((), torch.inf, dtype=points.dtype, device=dev)]

    def step(it):
        st, pts, lam, last = carry
        st, pts, lam, chi2_acc, chi2_pre = solve_iter(st, pts, lam)
        hist[min(it, MAX_HIST - 1)] = chi2_pre
        syncs[0] += 1
        carry[:] = st, pts, lam, chi2_acc
        return _exit_test(chi2_acc, last, opts.tol).tolist()

    it, accepts = _lm_loop(step, opts)
    st, pts, lam, last = carry
    # each shard's rows in shard order
    obs = [_obs_residuals(_on(st, d), pts.to(d), p, cam, R_, t_)
           for d, p, R_, t_, _, _ in shards]
    return st, pts, _finish(it, accepts, hist, last, lam,
                            torch.cat([c.to(dev) for c, _ in obs]),
                            torch.cat([z.to(dev) for _, z in obs]), syncs[0])


def _finish(it: int, accepts: list, hist, last, lam, obs_chi2, obs_depth,
            host_syncs: int) -> dict:
    """solve_ba's info after `it` iterations: hist the chi2 history,
    `last` the final accepted chi2, `lam` the final damping, obs_chi2 and
    obs_depth the final per-observation chi2 and depth (for the callers'
    outlier classification)."""
    # unexecuted slots hold the final accepted chi2
    chi2_hist = torch.where(torch.arange(MAX_HIST, device=hist.device) < it,
                            hist, last)
    return dict(chi2_hist=chi2_hist, final_chi2=last, lam=lam, iters_run=it,
                accepted=accepts, obs_chi2=obs_chi2, obs_depth=obs_depth,
                host_syncs=host_syncs)


def _lm_loop(step, opts: BAOptions):
    """The LM loop's host side: step(it) runs iteration `it` and returns
    its [accepted, small gain] (_exit_test) read on the host; the loop ends
    after opts.iters iterations, two accepted small gains in a row, or 16
    rejections in a row (with opts.tol > 0). Returns (iterations run, the
    accepted flags)."""
    it = stall = rej = 0
    accepts = []
    rej_cap = 16 if opts.tol > 0 else opts.iters + 1
    while it < opts.iters and stall < 2 and rej < rej_cap:
        accepted, small = step(it)
        stall = (stall + 1 if small else 0) if accepted else stall
        rej = 0 if accepted else rej + 1
        accepts.append(accepted)
        it += 1
    return it, accepts


def _exit_test(chi2_acc, last, tol: float):
    """[accepted, small gain] of an iteration as the LM loop reads them:
    the accepted chi2 against the previous one."""
    rel_gain = (last - chi2_acc) / torch.clamp(chi2_acc, min=1e-20)
    return torch.stack([chi2_acc < last, rel_gain < tol])


def _obs_residuals(st: KFStates, pts, prob: BAProblem, cam, Rcb, tcb):
    """(chi2, depth) of each reprojection row of prob at (st, pts)."""
    r, depth, _, _ = _reproj_batch(cam, Rcb, tcb, st.R[prob.r_kf],
                                   st.t[prob.r_kf], pts[prob.r_mp],
                                   prob.r_uv, want_jac=False)
    return torch.sum(r * r, dim=1), depth


def _lm_iteration(states: KFStates, points, prob: BAProblem, kf_dof,
                  mp_free, Rcb, tcb, cam: CameraModel, opts: BAOptions,
                  implicit: bool, mesh, syncs: list,
                  sync_free: bool = False):
    """solve_ba's damped-GN iteration on the problem of these shapes:
    (solve_iter, shards). solve_iter(states, points, lam) returns (states',
    points', lam', the accepted chi2, the chi2 at the linearization point);
    host reads add to syncs[0].

    sync_free: the iteration reads nothing on the host, so a CUDA graph
    can hold it (ba.LocalBAReplay captures this function and the
    iteration). The backtracking tries at alpha = 1/4 and 1/16 are made on
    every iteration and picked on the device where the full step is
    rejected, and the reduced-system PCG runs all its iterations without
    its exit poll (those past convergence are masked no-ops): the values
    the host-read branch and exit give."""
    n = states.R.shape[0]
    m = points.shape[0]
    n15 = n * DOF
    dtype, dev = points.dtype, points.device
    pose_cg = resolve_pose_cg(opts.pose_cg_iters, dev)
    prob = prob._replace(**{k: getattr(prob, k).long() for k in _INDEX_FIELDS})
    kf_dof = kf_dof.to(torch.bool)
    backtrack = resolve_backtrack(opts.backtrack, dev)
    dof_flat = kf_dof.reshape(-1)
    mask_f = dof_flat.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if not implicit:
        keep = dof_flat[:, None] & dof_flat[None, :]
        fixed_diag = torch.diag(torch.where(dof_flat, 0.0, 1.0).to(dtype))
        eye_n = torch.eye(n15, dtype=dtype, device=dev)

    # the shards: one on the tensors' device without a mesh; the per-shard
    # constants are copies on the shard's device (no copy on the lead's)
    if mesh is None:
        devs, probs = [dev], [prob]

        def psum(parts):
            return parts[0]
    else:
        devs = list(mesh.devices)
        probs = [p.to(d) for p, d in zip(split_problem(prob, mesh.size),
                                         devs)]
        psum = mesh.psum
    shards = [(d, p, Rcb.to(d), tcb.to(d), kf_dof.to(d), mp_free.to(d))
              for d, p in zip(devs, probs)]

    def pad15(x6):
        """(N, 6) pose-column values -> (N15,) with zeros elsewhere."""
        out = x6.new_zeros(n, DOF)
        out[:, :6] = x6
        return out.reshape(n15)

    def chi2_at(st, pts):
        return psum([_chi2_only(_on(st, d), pts.to(d), p, cam, R_, t_, opts)
                     for d, p, R_, t_, _, _ in shards])

    def solve_iter(states_c, points_c, lam):
        outs = [_compute_all(_on(states_c, d), points_c.to(d), p, cam, R_,
                             t_, opts, dof, free, implicit=implicit)
                for d, p, R_, t_, dof, free in shards]
        chi2, Hpp, b_p, Hll, Hll_col, b_l = (psum([o[k] for o in outs])
                                             for k in range(6))
        # the landmark block: visual + coline diagonal + damping, folded in
        # the Schur complement; the coline cross blocks enter the
        # back-substitution PCG (the reference's structure, ba_core.py:940)
        Hll_r = Hll + Hll_col + (lam + 1e-8) * eye3[None]
        Hll_inv = _inv3x3(Hll_r)
        if implicit:
            dx_p, W_x = implicit_pose_step(outs, Hpp, b_p, b_l, Hll_inv, lam)
        else:
            W = psum([o[6] for o in outs])
            dx_p = dense_pose_step(W, Hpp, b_p, b_l, Hll_inv, lam)

            def W_x(x6):
                return torch.einsum("mip,p->mi", W, x6.reshape(n * 6))
        dx_p = torch.where(dof_flat, dx_p, 0.0)

        # back-substitute landmarks: A dx_l = -(b_l + W dx_p) with
        # A = blockdiag(Hll_r) + coline cross-blocks, PCG preconditioned by
        # the block-diagonal inverse
        rhs_l = -(b_l + W_x(dx_p.reshape(n, DOF)[:, :6]))
        colines = []
        for (d, p, *_), o in zip(shards, outs):
            rc, Js, wc = o[7]
            if rc is not None:
                colines.append((d, p.c_idx, {
                    (a, b): wc[:, None, None] * _outer(Js[a], Js[b])
                    for a in range(3) for b in range(3) if a != b}))

        def A_mv(x):
            y = _mv(Hll_r, x)
            if not colines:
                return y
            parts = []
            for d, c_idx, Hab in colines:
                xd = x.to(d)
                xg = [xd[c_idx[:, b]] for b in range(3)]
                yc = xd.new_zeros(m, 3)
                for a in range(3):
                    yc.index_add_(0, c_idx[:, a], sum(
                        _mv(Hab[a, b], xg[b]) for b in range(3) if b != a))
                parts.append(yc)
            return y + psum(parts)

        dx_l = _mv(Hll_inv, rhs_l)
        if opts.pcg_iters > 0:
            r_cg = rhs_l - A_mv(dx_l)
            z_cg = _mv(Hll_inv, r_cg)
            p_cg = z_cg
            for _ in range(opts.pcg_iters):
                Ap = A_mv(p_cg)
                rz = torch.sum(r_cg * z_cg)
                alpha = rz / torch.clamp(torch.sum(p_cg * Ap), min=1e-20)
                dx_l = dx_l + alpha * p_cg
                r_cg = r_cg - alpha * Ap
                z_cg = _mv(Hll_inv, r_cg)
                beta = torch.sum(r_cg * z_cg) / torch.clamp(rz, min=1e-20)
                p_cg = z_cg + beta * p_cg
        dx_l = dx_l * mp_free[:, None]

        dx = dx_p.reshape(n, DOF)
        new_states = states_c.retract(dx)
        new_points = points_c + dx_l
        if not opts.adapt:
            return new_states, new_points, lam, chi2, chi2
        new_chi2 = chi2_at(new_states, new_points)
        full_ok = new_chi2 < chi2
        cand = (new_states, new_points, new_chi2)
        if backtrack:
            # a rejected full step is retried along the same direction at
            # alpha = 1/4 and 1/16 before lambda grows
            if not sync_free:
                syncs[0] += 1
            if sync_free or not bool(full_ok):
                tries = []
                for alpha in (0.25, 0.0625):
                    st_a = states_c.retract(alpha * dx)
                    pts_a = points_c + alpha * dx_l
                    tries.append((st_a, pts_a, chi2_at(st_a, pts_a)))
                (st2, pts2, c2), (st3, pts3, c3) = tries
                pick2 = c2 <= c3
                tried = (st2.select(pick2, st3),
                         torch.where(pick2, pts2, pts3), torch.minimum(c2, c3))
                cand = tried if not sync_free else (
                    new_states.select(full_ok, tried[0]),
                    torch.where(full_ok, new_points, tried[1]),
                    torch.where(full_ok, new_chi2, tried[2]))
        cand_states, cand_points, cand_chi2 = cand
        accept = cand_chi2 < chi2
        # full-step accept halves lambda; a backtracked accept keeps it;
        # a total reject grows it
        lam_n = torch.where(full_ok, lam * 0.5,
                            torch.where(accept, lam, lam * 4.0))
        return (cand_states.select(accept, states_c),
                torch.where(accept, cand_points, points_c), lam_n,
                torch.where(accept, cand_chi2, chi2), chi2)

    def dense_pose_step(W, Hpp, b_p, b_l, Hll_inv, lam):
        # Schur: S = Hpp - W^T Hll^-1 W; rhs = b_p - W^T Hll^-1 b_l, the
        # visual correction in the compact (N6) layout padded into 15-DOF.
        # The fold cancels most of Hpp's camera stiffness, and a f32 fold
        # left the first step 5x further from the f64 step than the
        # reference's f32 step (1.9e-4 m vs 3.8e-5 m on make_vi_problem's
        # 5-KF problem, CPU), so it accumulates in f64
        W64 = W.double()
        HinvW = torch.einsum("mij,mjp->mip", Hll_inv.double(), W64)
        S6 = torch.einsum("mip,miq->pq", W64, HinvW).to(dtype).reshape(
            n, 6, n, 6)
        S6f = points.new_zeros(n, DOF, n, DOF)
        S6f[:, :6, :, :6] = S6
        S = Hpp - S6f.reshape(n15, n15)
        r6 = torch.einsum("mip,mi->p", W, _mv(Hll_inv, b_l)).reshape(n, 6)
        rhs = b_p - pad15(r6)

        # damping + fixed-DOF handling
        S = S + lam * eye_n
        S = torch.where(keep, S, 0.0) + fixed_diag
        if pose_cg > 0:
            d_inv = 1.0 / torch.clamp(torch.diagonal(S), min=1e-12)
            return -_pcg(lambda x: S @ x, d_inv, rhs, pose_cg, syncs,
                         poll=not sync_free)
        L, info = torch.linalg.cholesky_ex(S)
        sol = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        # a failed factorization gives NaN, as the reference's does: the
        # step is then rejected and lambda grows
        return torch.where(info == 0, -sol, torch.nan)

    def implicit_pose_step(outs, Hpp, b_p, b_l, Hll_inv, lam):
        """The reduced pose solve without W or S (the reference's implicit
        branch, ba_core.py:979-1040): W x and W^T t are applied observation
        by observation from each shard's blocks Bw (O, 3, 6), gathered by
        r_kf / r_mp and summed with index_add_; the operator carries the
        dense path's damping and fixed-DOF rows. Returns (dx_p, W_x).

        The matvecs run in f32, as the reference's do, although S x is the
        small difference of Hpp x and W^T Hll^-1 W x: the first LM step
        lies within 1e-2 of the step of the dense route, which folds S in
        f64 (chip_smoke.py phase 12, 64-300 KFs; test_torch_implicit_schur
        on the CPU)."""
        blocks = [(d, p.r_kf, p.r_mp, o[6])
                  for (d, p, *_), o in zip(shards, outs)]

        def W_x(x6):
            # (N, 6) -> (M, 3): the sum over a landmark's observations
            return psum([x6.new_zeros(m, 3, device=d).index_add_(
                0, r_mp, _mv(Bw, x6.to(d)[r_kf]))
                for d, r_kf, r_mp, Bw in blocks])

        def Wt_t(t):
            # (M, 3) -> (N, 6): the sum over a keyframe's observations
            return psum([t.new_zeros(n, 6, device=d).index_add_(
                0, r_kf, _mv(Bw.transpose(1, 2), t.to(d)[r_mp]))
                for d, r_kf, r_mp, Bw in blocks])

        rhs = b_p - pad15(Wt_t(_mv(Hll_inv, b_l)))

        def S_mv(x):
            xm = x * mask_f
            y = Hpp @ xm + lam * xm
            t = _mv(Hll_inv, W_x(xm.reshape(n, DOF)[:, :6]))
            y = y - pad15(Wt_t(t))
            return y * mask_f + (1.0 - mask_f) * x

        # diag(S) for the Jacobi preconditioner, observation by
        # observation: diag(Hpp) + lam - sum_obs diag(Bw^T Hll^-1 Bw). This
        # is the fold's diagonal only where no (landmark, keyframe) pair
        # holds two observations, as the reference assumes (ba_core.py:1031)
        parts = []
        for d, r_kf, r_mp, Bw in blocks:
            dg = (Bw * (Hll_inv.to(d)[r_mp] @ Bw)).sum(1)      # (O, 6)
            parts.append(dg.new_zeros(n, 6).index_add_(0, r_kf, dg))
        dS = torch.diagonal(Hpp) + lam - pad15(psum(parts))
        d_inv = 1.0 / torch.clamp(torch.where(dof_flat, dS, 1.0), min=1e-12)
        return -_pcg(S_mv, d_inv, rhs, pose_cg, syncs,
                     poll=not sync_free), W_x

    return solve_iter, shards
