"""The full bundle-adjustment solver over a device mesh.

Port of ppg_slam_tpu/parallel/sharded_ba.py. `solve_ba_sharded` runs
`estimator.ba_core.solve_ba` itself with a Mesh: every residual family
(reprojection, colines with their PCG cross-block matvecs, inertial links,
bias random walks, 15-D priors, bias priors) is padded to a multiple of the
mesh size and cut into equal contiguous slices, one a device, where it is
linearized and its chi2 evaluated; the normal equations are summed on the
lead device, which runs the reduced solve and the damped accept/reject LM
loop once. States and points go to every shard each iteration.

Two routes, as in the reference: the dense one sums each shard's
landmark-pose block W (M, 3, N*6); the implicit one (at IMPLICIT_MIN_KF
keyframes and more, with a PCG pose solve) keeps each shard's
per-observation blocks on its device and sums the matvecs' (M, 3) and
(N, 6) results instead. The reference's per-shard slot-major relayout
(`_shard_obs_layout`) is a one-hot-assembly workaround and is not ported:
the observations keep the caller's order, so the per-observation results
need no mapping back.

Entry: `estimator.ba.global_bundle_adjustment(..., mesh=)` and
`full_inertial_ba(..., mesh=)` route here; `solve_ba_sharded` is the
solver-level call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..estimator.ba_core import (BAOptions, BAProblem, KFStates,
                                 empty_problem, resolve_pose_cg, solve_ba)
from ..geometry.cameras import CAM_PINHOLE, CameraModel
from ..imu.preintegration import GRAVITY_VALUE
from .mesh import Mesh

# BAProblem residual families and their leading-dim group:
#   O: reprojection, C: colines, L: inertial + bias walks, P: priors, B: bias
_FAMILY_OF = dict(
    r_kf="O", r_mp="O", r_uv="O", r_valid="O",
    c_idx="C", c_w="C", c_valid="C",
    i_kf1="L", i_kf2="L", i_dR="L", i_dV="L", i_dP="L", i_JRg="L",
    i_JVg="L", i_JVa="L", i_JPg="L", i_JPa="L", i_b0="L", i_sqi="L",
    i_dt="L", i_valid="L", i_huber="L", rw_sqig="L", rw_sqia="L",
    rw_valid="L",
    p_kf="P", p_R="P", p_t="P", p_v="P", p_bg="P", p_ba="P", p_sqi="P",
    p_valid="P",
    bp_kf="B", bp_wg="B", bp_wa="B", bp_valid="B",
)


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.array(a)).to(device)


def pad_problem_for_mesh(prob: BAProblem, n_dev: int,
                         device=None) -> BAProblem:
    """`prob` (numpy arrays or tensors) as tensors on `device` (CUDA unless
    named), every residual family's leading dim padded to a multiple of
    n_dev with invalid (masked) rows so the shards are equal-sized."""
    device = resolve_device(device)
    sizes = {}
    for name in BAProblem._fields:
        sizes.setdefault(_FAMILY_OF[name], getattr(prob, name).shape[0])
    pads = {f: (-(-n // n_dev)) * n_dev - n for f, n in sizes.items()}
    ext = empty_problem(n_obs=pads["O"], n_col=pads["C"], n_links=pads["L"],
                        n_priors=pads["P"], n_bp=pads["B"], device=device)
    out = {}
    for name in BAProblem._fields:
        a = _tensor(getattr(prob, name), device)
        e = getattr(ext, name)
        out[name] = torch.cat([a, e.to(a.dtype)]) if e.shape[0] else a
    return BAProblem(**out)


def solve_ba_sharded(states: KFStates, points, prob: BAProblem, kf_dof,
                     mp_free, Rcb, tcb, cam: CameraModel, opts: BAOptions,
                     mesh: Mesh, implicit: Optional[bool] = None):
    """solve_ba over a device mesh: the same arguments and results, the
    residual families sharded over the mesh, the solve on its lead device
    (where the returned states, points and info live).

    implicit: None = the reference's auto rule: the implicit route where
    the keyframe count is at least estimator.ba.IMPLICIT_MIN_KF and the
    pose solve resolves to PCG on the lead device; True/False forces it.
    The per-observation info (obs_chi2, obs_depth) comes back in the
    caller's row order, its padding rows dropped."""
    from ..estimator.ba import IMPLICIT_MIN_KF

    lead = mesh.lead
    if implicit is None:
        implicit = (states.R.shape[0] >= IMPLICIT_MIN_KF
                    and resolve_pose_cg(opts.pose_cg_iters, lead) > 0)
    n_obs = prob.r_kf.shape[0]
    prob = pad_problem_for_mesh(prob, mesh.size, device=lead)
    states = KFStates(*(_tensor(x, lead) for x in states))
    st, pts, info = solve_ba(states, _tensor(points, lead), prob,
                             _tensor(kf_dof, lead), _tensor(mp_free, lead),
                             _tensor(Rcb, lead), _tensor(tcb, lead), cam,
                             opts, implicit=implicit, mesh=mesh)
    info["obs_chi2"] = info["obs_chi2"][:n_obs]
    info["obs_depth"] = info["obs_depth"][:n_obs]
    return st, pts, info


# ---------------------------------------------------------------------------
# a tiny visual-inertial problem with colines through the full sharded
# solver (the dry run, and the tests)
# ---------------------------------------------------------------------------

def make_vi_problem(n_kf=6, n_mp=128, n_obs=256, n_col=32, seed=0,
                    noise=0.02, device=None):
    """Synthetic visual-inertial BA problem (the reference's
    make_vi_problem, the same numbers from the same seed): a KF chain with
    reprojection observations, valid collinear triplets, inertial links
    with plausible preintegration deltas, and a prior on the first KF.
    Returns (cam, states, points, prob, kf_dof, mp_free), tensors on
    `device` (CUDA unless named)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    cam = CameraModel(kind=CAM_PINHOLE, fx=200.0, fy=200.0, cx=64.0, cy=48.0,
                      dist=(0.0, 0.0, 0.0, 0.0), width=128, height=96)
    # straight-line colinear triplets: base + k * direction
    base = np.stack([rng.uniform(-2, 2, n_col), rng.uniform(-2, 2, n_col),
                     rng.uniform(5, 9, n_col)], 1)
    d = rng.randn(n_col, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = np.stack([base, base + 0.3 * d, base + 0.7 * d], 1)  # (C, 3, 3)
    pts_tri = tri.reshape(-1, 3)
    n_rand = n_mp - len(pts_tri)
    if n_rand < 0:
        raise ValueError("n_mp must hold 3*n_col triplet points")
    pts_rand = np.stack([rng.uniform(-3, 3, n_rand),
                         rng.uniform(-2, 2, n_rand),
                         rng.uniform(4, 10, n_rand)], 1)
    points = np.concatenate([pts_tri, pts_rand]).astype(np.float32)
    c_idx = np.arange(3 * n_col, dtype=np.int64).reshape(n_col, 3)

    dt = 0.5
    Rwb = np.broadcast_to(np.eye(3, dtype=np.float32), (n_kf, 3, 3)).copy()
    v_true = np.float32([0.4, 0.0, 0.0])
    twb = np.stack([v_true * dt * k for k in range(n_kf)]).astype(np.float32)

    r_kf = rng.randint(0, n_kf, n_obs).astype(np.int64)
    r_mp = rng.randint(0, n_mp, n_obs).astype(np.int64)
    Xc = np.einsum("oij,oj->oi", Rwb[r_kf].transpose(0, 2, 1),
                   points[r_mp] - twb[r_kf])
    uv = np.stack([200.0 * Xc[:, 0] / Xc[:, 2] + 64.0,
                   200.0 * Xc[:, 1] / Xc[:, 2] + 48.0], 1)
    uv += rng.randn(n_obs, 2) * 0.3
    r_valid = Xc[:, 2] > 0.1

    n_links = n_kf - 1
    g = np.float32([0, 0, -GRAVITY_VALUE])
    # constant-velocity ground truth: dV = -g*dt, dP = v*dt - 0.5*g*dt^2
    dV = np.broadcast_to(-g * dt, (n_links, 3)).astype(np.float32)
    dP = np.broadcast_to(v_true * dt - 0.5 * g * dt * dt,
                         (n_links, 3)).astype(np.float32)

    def eye(k, n, s):
        return np.broadcast_to(np.eye(k, dtype=np.float32) * s,
                               (n, k, k)).astype(np.float32)

    host = empty_problem(n_obs=n_obs, n_col=n_col, n_links=n_links,
                         n_priors=1, n_bp=1)._asdict()
    host = {k: v.numpy() for k, v in host.items()}
    host.update(
        r_kf=r_kf, r_mp=r_mp, r_uv=uv.astype(np.float32), r_valid=r_valid,
        c_idx=c_idx, c_w=np.full(n_col, 30.0, np.float32),
        c_valid=np.ones(n_col, bool),
        i_kf1=np.arange(n_links, dtype=np.int64),
        i_kf2=np.arange(1, n_links + 1, dtype=np.int64),
        i_dV=dV, i_dP=dP, i_sqi=eye(9, n_links, 10.0),
        i_dt=np.full(n_links, dt, np.float32),
        i_valid=np.ones(n_links, bool), i_huber=np.zeros(n_links, bool),
        rw_sqig=eye(3, n_links, 100.0), rw_sqia=eye(3, n_links, 100.0),
        rw_valid=np.ones(n_links, bool),
        p_kf=np.zeros(1, np.int64), p_R=Rwb[:1].copy(), p_t=twb[:1].copy(),
        p_v=v_true[None].copy(), p_bg=np.zeros((1, 3), np.float32),
        p_ba=np.zeros((1, 3), np.float32), p_sqi=eye(15, 1, 30.0),
        p_valid=np.ones(1, bool),
        bp_kf=np.zeros(1, np.int64), bp_wg=np.full(1, 100.0, np.float32),
        bp_wa=np.full(1, 100.0, np.float32), bp_valid=np.ones(1, bool))
    prob = BAProblem(**{k: _tensor(v, device) for k, v in host.items()})

    # perturbed initial state
    tn = twb + rng.randn(n_kf, 3).astype(np.float32) * noise
    tn[0] = twb[0]
    pn = points + rng.randn(n_mp, 3).astype(np.float32) * noise
    z = np.zeros((n_kf, 3), np.float32)
    states = KFStates(*(_tensor(a, device) for a in (
        Rwb, tn, np.broadcast_to(v_true, (n_kf, 3)).copy(), z, z)))
    kf_dof = np.ones((n_kf, 15), bool)
    kf_dof[0, :6] = False  # gauge: first pose fixed
    return (cam, states, _tensor(pn, device), prob, _tensor(kf_dof, device),
            torch.ones(n_mp, dtype=torch.bool, device=device))


def dryrun_sharded_ba_step(mesh: Mesh) -> None:
    """Run the full sharded visual-inertial solver (reprojection, colines,
    inertial links, walks, priors, the damped LM loop) on tiny shapes,
    through the dense route and the implicit one; raises on a non-finite
    chi2."""
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        device=mesh.lead)
    eye = torch.eye(3, device=mesh.lead)
    z3 = torch.zeros(3, device=mesh.lead)
    for implicit, cg in ((False, None), (True, 32)):
        opts = BAOptions(iters=2, lambda0=1e-2, pose_cg_iters=cg)
        _, _, info = solve_ba_sharded(states, points, prob, kf_dof, mp_free,
                                      eye, z3, cam, opts, mesh,
                                      implicit=implicit)
        if not bool(torch.isfinite(info["chi2_hist"]).all()):
            raise RuntimeError(f"dryrun_sharded_ba_step: non-finite chi2 "
                               f"on the {'implicit' if implicit else 'dense'}"
                               " route")
