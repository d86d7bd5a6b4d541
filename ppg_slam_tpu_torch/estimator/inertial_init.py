"""IMU initialization optimizers: gravity direction, scale, biases, velocities.

Port of ppg_slam_tpu/estimator/inertial_init.py, the two
InertialOptimization overloads (reference OptimizerInertial.cpp):
  * full init (:174-378): poses fixed; per-KF velocities + one shared
    gyro/acc bias + 2-DOF gravity direction + log-scale optimized through
    the EdgeInertialGS chain with bias priors (weights priorG/priorA), LM
    (lambda0 = 1e3 when priorG != 0).
  * scale refinement (:29-152): only gravity direction + scale free.

One LM solve over the dense [v(3N), bg(3), ba(3), gdir(2), logs(1)] system
on the inputs' device, every accept/reject decision kept on the device. The
links are linearized in closed form (_gs_linearization; the reference
takes jax.jacfwd of the residual, which the tests hold it against with
torch.func.jacfwd).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3
from ..imu.preintegration import GRAVITY_VALUE
from ..utils import profiler


class InertialInitProblem(NamedTuple):
    """Per-link preintegration payload."""

    kf1: torch.Tensor   # (L,) int
    kf2: torch.Tensor   # (L,)
    dR: torch.Tensor    # (L, 3, 3)
    dV: torch.Tensor    # (L, 3)
    dP: torch.Tensor    # (L, 3)
    JRg: torch.Tensor   # (L, 3, 3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    b0: torch.Tensor    # (L, 6)
    sqi: torch.Tensor   # (L, 9, 9)
    dt: torch.Tensor    # (L,)
    valid: torch.Tensor  # (L,)


def _gs_residual(dv1, dv2, bg_abs, ba_abs, dgd, ds, R1, t1, v1, R2, t2, v2,
                 Rwg, log_s, dRm, dVm, dPm, JRg, JVg, JVa, JPg, JPa, b0, dt):
    """EdgeInertialGS residual; bg_abs/ba_abs are the absolute shared biases
    (the caller adds its deltas before passing, so jacfwd differentiates
    through them)."""
    dbg_c = bg_abs - b0[:3]
    dba_c = ba_abs - b0[3:]
    dR = dRm @ so3.exp(JRg @ dbg_c)
    dV = dVm + JVg @ dbg_c + JVa @ dba_c
    dP = dPm + JPg @ dbg_c + JPa @ dba_c

    gI = torch.tensor([0.0, 0.0, -GRAVITY_VALUE], dtype=R1.dtype,
                      device=R1.device)
    g = Rwg @ so3.exp(torch.cat([dgd, dgd.new_zeros(1)])) @ gI
    s = torch.exp(log_s + ds)

    v1n = v1 + dv1
    v2n = v2 + dv2
    er = so3.log(dR.T @ R1.T @ R2)
    ev = R1.T @ (s * (v2n - v1n) - g * dt) - dV
    ep = R1.T @ (s * (t2 - t1 - v1n * dt) - 0.5 * g * dt * dt) - dP
    return torch.cat([er, ev, ep])


def _mT(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _gs_linearization(R1, t1, R2, t2, v1, v2, bg, ba, Rwg, log_s, dRm, dVm,
                      dPm, JRg, JVg, JVa, JPg, JPa, b0, dt):
    """`_gs_residual` at zero deltas for a batch of links, with its
    Jacobians w.r.t. (dv1 (.., 9, 3), dv2, bg, ba, dgd (.., 9, 2),
    ds (.., 9)), in closed form."""
    dbg = bg - b0[..., :3]
    dba = ba - b0[..., 3:]
    phi = _mv(JRg, dbg)
    dR = dRm @ so3.exp(phi)
    dV = dVm + _mv(JVg, dbg) + _mv(JVa, dba)
    dP = dPm + _mv(JPg, dbg) + _mv(JPa, dba)
    gI = torch.tensor([0.0, 0.0, -GRAVITY_VALUE], dtype=R1.dtype,
                      device=R1.device)
    g = _mv(Rwg, gI)
    s = torch.exp(log_s)
    dt_ = dt[..., None]
    R1T = _mT(R1)
    E = _mT(dR) @ R1T @ R2
    er = so3.log(E)
    vel = _mv(R1T, s * (v2 - v1))
    pos = _mv(R1T, s * (t2 - t1 - v1 * dt_))
    r = torch.cat([er, vel - _mv(R1T, g) * dt_ - dV,
                   pos - 0.5 * _mv(R1T, g) * dt_ * dt_ - dP], dim=-1)
    lead = R1.shape[:-2]
    zero = R1.new_zeros(lead + (3, 3))
    Jbg_r = -so3.inverse_right_jacobian(er) @ _mT(E) \
        @ so3.right_jacobian(phi) @ JRg
    Jv1 = torch.cat([zero, -s * R1T, -s * R1T * dt_[..., None]], dim=-2)
    Jv2 = torch.cat([zero, s * R1T, zero], dim=-2)
    Jbg = torch.cat([Jbg_r, -JVg, -JPg], dim=-2)
    Jba = torch.cat([zero, -JVa, -JPa], dim=-2)
    # d g / d gdir = -Rwg hat(gI)[:, :2]
    dg = (R1T @ Rwg @ so3.hat(gI))[..., :2]
    Jgd = torch.cat([zero[..., :2], dg * dt_[..., None],
                     0.5 * dg * (dt_ * dt_)[..., None]], dim=-2)
    Jds = torch.cat([torch.zeros_like(er), vel, pos], dim=-1)
    return r, (Jv1, Jv2, Jbg, Jba, Jgd, Jds)


def inertial_optimization(R, t, v, bg0, ba0, Rwg0, scale0,
                          prob: InertialInitProblem, prior_g: float,
                          prior_a: float, fix_vel_bias: bool = False,
                          iters: int = 40):
    """Returns (v, bg, ba, Rwg, scale, chi2 history (iters,)).

    R/t/v: (N,3,3)/(N,3)/(N,3) fixed poses + initial velocities; bg0/ba0:
    (3,) shared bias inits; fix_vel_bias=True gives the scale-refinement
    variant.
    """
    profiler.count_device("inertial_optimization", t)
    dtype, dev = t.dtype, t.device
    n = t.shape[0]
    n_dof = 3 * n + 9  # v..., bg, ba, gdir(2), logs(1)
    kf1, kf2 = prob.kf1.long(), prob.kf2.long()
    prior_g = torch.as_tensor(prior_g, dtype=dtype, device=dev)
    prior_a = torch.as_tensor(prior_a, dtype=dtype, device=dev)
    lam0_raw = torch.where(prior_g != 0.0, 1e3, 1e-5).to(dtype)

    # Global information normalization: clean IMU gives sqrt-info factors
    # ~1e3-1e4, and a whitened chi2 at ~1e5-1e6 where f32 cannot resolve the
    # LM accept test. Scaling every chi2 term by one alpha^2 (links by
    # alpha, priors by alpha^2) keeps the optimum and brings chi2 to
    # O(#residuals); the initial damping scales with the Hessian.
    diag_mag = torch.abs(torch.diagonal(prob.sqi, dim1=1, dim2=2))
    w_valid = prob.valid.to(dtype)[:, None]
    mean_sqi = torch.sum(diag_mag * w_valid) / torch.clamp(
        torch.sum(w_valid) * 9.0, min=1.0)
    alpha = 1.0 / torch.clamp(mean_sqi, min=1.0)
    sqi = prob.sqi * alpha
    prior_g = prior_g * alpha * alpha
    prior_a = prior_a * alpha * alpha
    lam0 = lam0_raw * alpha * alpha

    link = (prob.dR, prob.dV, prob.dP, prob.JRg, prob.JVg, prob.JVa,
            prob.JPg, prob.JPa, prob.b0, prob.dt)
    w = prob.valid.to(dtype)
    L = kf1.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(3, device=dev)

    def assemble(vels, bg, ba, Rwg, log_s, want_jac=True):
        r, Js = _gs_linearization(R[kf1], t[kf1], R[kf2], t[kf2], vels[kf1],
                                  vels[kf2], bg, ba, Rwg, log_s, *link)
        r = _mv(sqi, r) * w[:, None]
        chi2 = torch.sum(r * r) + prior_g * torch.sum(bg * bg) \
            + prior_a * torch.sum(ba * ba)
        if not want_jac:
            return chi2
        Jv1, Jv2, Jbg, Jba, Jgd, Jds = (sqi @ Js[0], sqi @ Js[1],
                                        sqi @ Js[2], sqi @ Js[3],
                                        sqi @ Js[4], _mv(sqi, Js[5]))
        # per-link J (L, 9, n_dof): velocity blocks at their KF's columns
        J = t.new_zeros(L, 9, n_dof)
        rows = torch.arange(L, device=dev)[:, None, None]
        J[rows, torch.arange(9, device=dev)[None, :, None],
          (kf1 * 3)[:, None, None] + ar] += Jv1
        J[rows, torch.arange(9, device=dev)[None, :, None],
          (kf2 * 3)[:, None, None] + ar] += Jv2
        J[:, :, 3 * n: 3 * n + 3] += Jbg
        J[:, :, 3 * n + 3: 3 * n + 6] += Jba
        J[:, :, 3 * n + 6: 3 * n + 8] += Jgd
        J[:, :, 3 * n + 8] += Jds
        J = J * w[:, None, None]
        H = torch.einsum("ldi,ldj->ij", J, J)
        b = torch.einsum("ldi,ld->i", J, r)
        # bias priors: r = bg * sqrt(priorG) etc.
        H[3 * n: 3 * n + 3, 3 * n: 3 * n + 3] += prior_g * eye3
        H[3 * n + 3: 3 * n + 6, 3 * n + 3: 3 * n + 6] += prior_a * eye3
        b[3 * n: 3 * n + 3] += prior_g * bg
        b[3 * n + 3: 3 * n + 6] += prior_a * ba
        return chi2, H, b

    free = torch.ones(n_dof, dtype=torch.bool, device=dev)
    if fix_vel_bias:
        free[: 3 * n + 6] = False
    keep = free[:, None] & free[None, :]
    fixed_diag = torch.diag(torch.where(free, 0.0, 1.0).to(dtype))
    eye_n = torch.eye(n_dof, dtype=dtype, device=dev)

    vels, bg, ba, Rwg = v, bg0, ba0, Rwg0
    log_s = torch.log(torch.as_tensor(scale0, dtype=dtype, device=dev))
    lam = lam0
    hist = []
    for _ in range(iters):
        chi2, H, b = assemble(vels, bg, ba, Rwg, log_s)
        H = torch.where(keep, H + lam * eye_n, 0.0) + fixed_diag
        dx = -torch.linalg.solve_ex(H, torch.where(free, b, 0.0))[0]
        vels_n = vels + dx[: 3 * n].reshape(n, 3)
        bg_n = bg + dx[3 * n: 3 * n + 3]
        ba_n = ba + dx[3 * n + 3: 3 * n + 6]
        Rwg_n = so3.normalize(Rwg @ so3.exp(
            torch.cat([dx[3 * n + 6: 3 * n + 8], dx.new_zeros(1)])))
        log_s_n = log_s + dx[3 * n + 8]
        ok = assemble(vels_n, bg_n, ba_n, Rwg_n, log_s_n, want_jac=False) \
            < chi2
        vels, bg, ba, Rwg, log_s = (
            torch.where(ok, a, b_) for a, b_ in
            ((vels_n, vels), (bg_n, bg), (ba_n, ba), (Rwg_n, Rwg),
             (log_s_n, log_s)))
        lam = torch.where(ok, lam * 0.5, lam * 5.0)
        hist.append(chi2)
    return vels, bg, ba, Rwg, torch.exp(log_s), torch.stack(hist)
