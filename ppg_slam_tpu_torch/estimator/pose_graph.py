"""Pose-graph optimizers: Sim3 essential graph, 4-DoF variant, loop Sim3.

Port of ppg_slam_tpu/estimator/pose_graph.py (the reference's
optimizing/src/OptimizerGraph.cpp):
  * optimize_essential_graph (:31-353): Sim3 vertices (Scw), relative-Sim3
    edges (the CALLER selects the edge set), identity information, LM from
    lambda = 1e-16, 20 iterations, fixed vertices held;
  * optimize_essential_graph_4dof (:638-962): yaw + translation vertices,
    Edge4DoF relative-pose residual with the rotation rows weighted
    sqrt(1e3);
  * optimize_sim3 (:355-636): relative Sim3 between two KFs from paired
    forward/inverse projections, Huber(sqrt th2), 5 iterations -> outlier
    cut -> 10 more, returns the inlier mask and count.

Each runs on its inputs' device at the exact node, edge and point counts,
with the reference's fixed iteration counts and its LM rule (lambda x0.5 on
a strict decrease, else x10 for the graphs and x5 for the Sim3), the
accept decided on the device (no host sync inside the loop). The per-edge
and per-point Jacobians are forward-mode derivatives (torch.func.jacfwd,
under torch.func.vmap over edges) of the same branch-free functions the
reference differentiates with jax.jacfwd, so that where an edge's error sits
in a small-angle or small-scale branch of Sim3.log, the Jacobian is that
branch's, as in the reference. The normal equations are dense
((7N)^2 or (4N)^2, f32) and solved with torch.linalg.solve.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import so3
from ..geometry.cameras import CameraModel
from ..geometry.se3 import _mv
from ..geometry.sim3 import Sim3
from ..utils import profiler
from .robust import huber_weight


class Sim3Graph(NamedTuple):
    """Edge set of the essential graph: Sji maps vertex i's frame to j's."""

    i: torch.Tensor      # (E,) int64 vertex indices
    j: torch.Tensor      # (E,)
    Sji_R: torch.Tensor  # (E, 3, 3) measured relative Sim3 (j <- i)
    Sji_t: torch.Tensor  # (E, 3)
    Sji_s: torch.Tensor  # (E,)


class Graph4DoF(NamedTuple):
    i: torch.Tensor      # (E,)
    j: torch.Tensor      # (E,)
    dRij: torch.Tensor   # (E, 3, 3) measured Ti<-j rotation (camera)
    dtij: torch.Tensor   # (E, 3)


def _sim3_error(di, dj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """log(Sji o (exp(di) Si) o (exp(dj) Sj)^-1): zero when
    Sj Si^-1 == Sji. Vertices hold Scw; the g2o Sim3 vertex update is
    left-multiplicative exp(delta) o S."""
    Si = Sim3.exp(di) @ Sim3(Ri, ti, si)
    Sj = Sim3.exp(dj) @ Sim3(Rj, tj, sj)
    err = Sim3(Rm, tm, sm) @ Si @ Sj.inverse()
    return err.log()


def _pose4_error(di, dj, Rwbi, twbi, Rwbj, twbj, dRij, dtij, rot_w):
    """Edge4DoF residual (G2oEdge.cpp Edge4DoF::computeError) with the
    reference's world-frame yaw + translation update (UpdateW)."""

    def upd(d, Rwb, twb):
        dyaw = torch.cat([torch.zeros_like(d[:2]), d[:1]])
        return so3.exp(dyaw) @ Rwb, twb + d[1:4]

    Ri_w, ti_w = upd(di, Rwbi, twbi)
    Rj_w, tj_w = upd(dj, Rwbj, twbj)
    Ri = Ri_w.T
    ti = -_mv(Ri, ti_w)
    Rj = Rj_w.T
    tj = -_mv(Rj, tj_w)
    er = so3.log(Ri @ Rj.T @ dRij.T) * rot_w
    et = _mv(Ri, -_mv(Rj.T, tj)) + ti - dtij
    return torch.cat([er, et])


def _with_jacobians(fn, z, edge_args):
    """Per-edge residual and its Jacobians w.r.t. both vertex updates
    (forward mode, at the zero update), vmapped over the edges."""

    def one(*args):
        (Ji, Jj), r = jacfwd(lambda a, b: (fn(a, b, *args),) * 2,
                             argnums=(0, 1), has_aux=True)(z, z)
        return r, Ji, Jj

    return vmap(one)(*edge_args)


def _normal_equations(r, Ji, Jj, i, j, n, dim):
    """chi2, the dense (n dim)^2 Hessian and gradient of the edge set."""
    Hb = torch.cat([Ji.transpose(1, 2) @ Ji, Jj.transpose(1, 2) @ Jj,
                    Ji.transpose(1, 2) @ Jj, Jj.transpose(1, 2) @ Ji])
    H = torch.zeros((n, n, dim, dim), dtype=r.dtype, device=r.device)
    H.index_put_((torch.cat([i, j, i, j]), torch.cat([i, j, j, i])), Hb,
                 accumulate=True)
    gb = torch.cat([_mv(Ji.transpose(1, 2), r), _mv(Jj.transpose(1, 2), r)])
    b = torch.zeros((n, dim), dtype=r.dtype, device=r.device)
    b.index_put_((torch.cat([i, j]),), gb, accumulate=True)
    H = H.permute(0, 2, 1, 3).reshape(n * dim, n * dim)
    return torch.sum(r * r), H, b.reshape(n * dim)


def _damped_step(H, b, lam, dof):
    """-(H + lam I)^-1 b on the free coordinates; held ones get 0."""
    n_dof = H.shape[0]
    eye = torch.eye(n_dof, dtype=H.dtype, device=H.device)
    H = H + lam * eye
    H = torch.where(dof[:, None] & dof[None, :], H, 0.0)
    H = H + torch.diag(torch.where(dof, 0.0, 1.0).to(H.dtype))
    b = torch.where(dof, b, 0.0)
    return -torch.linalg.solve(H, b)


def optimize_essential_graph(R: torch.Tensor, t: torch.Tensor,
                             s: torch.Tensor, graph: Sim3Graph,
                             fixed: torch.Tensor, iters: int = 20,
                             fix_scale: bool = False):
    """R/t/s: (N,3,3)/(N,3)/(N,) Sim3 Scw vertices; fixed: (N,) bool.
    Returns the optimized (R, t, s)."""
    profiler.count_device("optimize_essential_graph", t)
    dtype, dev = t.dtype, t.device
    n = t.shape[0]
    z7 = torch.zeros(7, dtype=dtype, device=dev)
    dof = torch.repeat_interleave(~fixed, 7)
    if fix_scale:
        dof = dof & ((torch.arange(7 * n, device=dev) % 7) != 6)
    edge_meas = (graph.Sji_R, graph.Sji_t, graph.Sji_s)

    def vertex_args(Rc, tc, sc):
        return (Rc[graph.i], tc[graph.i], sc[graph.i],
                Rc[graph.j], tc[graph.j], sc[graph.j]) + edge_meas

    def chi2_at(Rc, tc, sc):
        r = vmap(lambda *a: _sim3_error(z7, z7, *a))(
            *vertex_args(Rc, tc, sc))
        return torch.sum(r * r)

    lam = torch.tensor(1e-16, dtype=dtype, device=dev)
    for _ in range(iters):
        r, Ji, Jj = _with_jacobians(_sim3_error, z7, vertex_args(R, t, s))
        chi2, H, b = _normal_equations(r, Ji, Jj, graph.i, graph.j, n, 7)
        dx = _damped_step(H, b, lam, dof).reshape(n, 7)
        Sn = Sim3.exp(dx) @ Sim3(R, t, s)
        Rn, tn, sn = so3.normalize(Sn.R), Sn.t, Sn.s
        ok = chi2_at(Rn, tn, sn) < chi2
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        s = torch.where(ok, sn, s)
        lam = torch.where(ok, lam * 0.5, lam * 10.0)
    return R, t, s


def optimize_essential_graph_4dof(Rwb: torch.Tensor, twb: torch.Tensor,
                                  graph: Graph4DoF, fixed: torch.Tensor,
                                  iters: int = 20):
    """4-DoF pose graph (yaw + translation; keeps the IMU's roll/pitch).
    Rotation rows weighted sqrt(1e3) (OptimizerGraph.cpp:715-718).
    Returns the optimized (Rwb, twb)."""
    profiler.count_device("optimize_essential_graph_4dof", twb)
    dtype, dev = twb.dtype, twb.device
    n = twb.shape[0]
    rot_w = torch.sqrt(torch.tensor(1e3, dtype=dtype, device=dev))
    z4 = torch.zeros(4, dtype=dtype, device=dev)
    dof = torch.repeat_interleave(~fixed, 4)

    def edge_args(Rc, tc):
        return (Rc[graph.i], tc[graph.i], Rc[graph.j], tc[graph.j],
                graph.dRij, graph.dtij)

    def err(di, dj, *a):
        return _pose4_error(di, dj, *a, rot_w)

    def chi2_at(Rc, tc):
        r = vmap(lambda *a: err(z4, z4, *a))(*edge_args(Rc, tc))
        return torch.sum(r * r)

    lam = torch.tensor(1e-16, dtype=dtype, device=dev)
    R, t = Rwb, twb
    for _ in range(iters):
        r, Ji, Jj = _with_jacobians(err, z4, edge_args(R, t))
        chi2, H, b = _normal_equations(r, Ji, Jj, graph.i, graph.j, n, 4)
        dx = _damped_step(H, b, lam, dof).reshape(n, 4)
        dyaw = torch.cat([torch.zeros_like(dx[:, :2]), dx[:, :1]], dim=1)
        Rn = so3.normalize(so3.exp(dyaw) @ R)
        tn = t + dx[:, 1:4]
        ok = chi2_at(Rn, tn) < chi2
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        lam = torch.where(ok, lam * 0.5, lam * 10.0)
    return R, t


def _sim3_proj_residuals(d, S_R, S_t, S_s, X1, X2, uv1, uv2,
                         cam1: CameraModel, cam2: CameraModel,
                         fix_scale: bool):
    """Paired forward/inverse Sim3 projection residuals (OptimizeSim3).
    X1: points in camera-1's frame; X2: in camera-2's. S maps 2 -> 1."""
    if fix_scale:
        d = torch.cat([d[:6], torch.zeros_like(d[6:])])
    S = Sim3.exp(d) @ Sim3(S_R, S_t, S_s)
    r12 = uv1 - cam1.project(S.apply(X2))
    r21 = uv2 - cam2.project(S.inverse().apply(X1))
    return r12, r21


def optimize_sim3(S_R, S_t, S_s, X1, X2, uv1, uv2,
                  cam1: CameraModel, cam2: CameraModel,
                  fix_scale: bool = False, th2: float = 10.0):
    """Returns (S12 R, t, s, inlier mask, n_inliers), all on the inputs'
    device. X1/X2: (M, 3) matched map points in each camera's frame;
    uv1/uv2 their observed pixels. 5 robust iterations -> outlier cut ->
    10 more (OptimizerGraph.cpp:544-605)."""
    profiler.count_device("optimize_sim3", X1)
    dtype, dev = S_t.dtype, S_t.device
    z7 = torch.zeros(7, dtype=dtype, device=dev)
    delta = torch.sqrt(torch.tensor(th2, dtype=dtype, device=dev))

    def residuals(d, R_, t_, s_):
        return _sim3_proj_residuals(d, R_, t_, s_, X1, X2, uv1, uv2,
                                    cam1, cam2, fix_scale)

    def chi_at(R_, t_, s_):
        r12, r21 = residuals(z7, R_, t_, s_)
        return torch.sum(r12 * r12, 1), torch.sum(r21 * r21, 1)

    def gn(R_, t_, s_, active, n_iters):
        lam = torch.tensor(1e-5, dtype=dtype, device=dev)
        eye = torch.eye(7, dtype=dtype, device=dev)
        for _ in range(n_iters):
            (J12, J21), (r12, r21) = jacfwd(
                lambda d: (residuals(d, R_, t_, s_),) * 2,
                has_aux=True)(z7)
            chi12 = torch.sum(r12 * r12, 1)
            chi21 = torch.sum(r21 * r21, 1)
            w12 = huber_weight(chi12, delta) * active
            w21 = huber_weight(chi21, delta) * active
            H = (torch.einsum("m,mdi,mdj->ij", w12, J12, J12)
                 + torch.einsum("m,mdi,mdj->ij", w21, J21, J21))
            g = (torch.einsum("m,mdi,md->i", w12, J12, r12)
                 + torch.einsum("m,mdi,md->i", w21, J21, r21))
            cost = torch.sum(active * (chi12 + chi21))
            dx = -torch.linalg.solve(H + lam * eye, g)
            Sn = Sim3.exp(dx) @ Sim3(R_, t_, s_)
            Rn, tn, sn = so3.normalize(Sn.R), Sn.t, Sn.s
            if fix_scale:
                sn = s_
            c12, c21 = chi_at(Rn, tn, sn)
            ok = torch.sum(active * (c12 + c21)) < cost
            R_ = torch.where(ok, Rn, R_)
            t_ = torch.where(ok, tn, t_)
            s_ = torch.where(ok, sn, s_)
            lam = torch.where(ok, lam * 0.5, lam * 5.0)
        return R_, t_, s_

    active = torch.ones(X1.shape[0], dtype=dtype, device=dev)
    R1, t1, s1 = gn(S_R, S_t, S_s, active, 5)
    chi12, chi21 = chi_at(R1, t1, s1)
    inlier = (chi12 <= th2) & (chi21 <= th2)
    R2, t2, s2 = gn(R1, t1, s1, inlier.to(dtype), 10)
    chi12, chi21 = chi_at(R2, t2, s2)
    inlier = (chi12 <= th2) & (chi21 <= th2)
    return R2, t2, s2, inlier, torch.sum(inlier)
