"""Monocular initialization: parallel 8-pt F + H RANSAC + model selection.

Port of ppg_slam_tpu/geometry/two_view.py (the reference's
TwoViewReconstruction.cpp, an ORB-SLAM3 port): all RANSAC hypotheses are
estimated and scored at once on the tensors' device (batched 9-column DLT
SVDs and a (sets, P) scoring pass), and the 12 motion hypotheses (4 from E,
8 from the Faugeras H decomposition) are triangulated and checked in one
batched CheckRT. Thresholds and acceptance rules are the reference's:
  * CheckHomography: symmetric transfer, th = 5.991 (:322-379)
  * CheckFundamental: epipolar, th = 3.841, score th 5.991 (:381-459)
  * model selection: RH = SH/(SH+SF) > 0.50 -> H (:94-109)
  * ReconstructF: nsimilar == 1, maxGood >= max(0.9N, 50), parallax > 1 deg
  * ReconstructH: secondBest < 0.75 best, best > max(50, 0.9N), parallax >= 1
  * CheckRT: 4x4 DLT triangulation, reproj th 4 sigma^2, cheirality with
    cosParallax < 0.99998 guard, parallax = 50th smallest (:780-899)

The count thresholds (0.9 N, 0.7 maxGood) are compared in float64, as the
reference's tests run them. SVD sign conventions differ between libraries;
the scores, the hypothesis sets and the triangulated points do not depend on
them, and the chosen hypothesis is the one with the most good points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiler

MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
SIGMA2 = 1.0  # mSigma = 1.0
COS_PARALLAX_GUARD = 0.99998
RANSAC_ITERS = 200


class TwoViewResult(NamedTuple):
    ok: torch.Tensor            # () bool
    R21: torch.Tensor           # (3, 3)
    t21: torch.Tensor           # (3,)
    points3d: torch.Tensor      # (P, 3) in camera-1 frame (index = match slot)
    triangulated: torch.Tensor  # (P,) bool


def _normalize(pts, valid):
    """ORB-SLAM Normalize: mean + mean absolute deviation scaling."""
    n = torch.clamp(valid.sum(), min=1).to(pts.dtype)
    mean = torch.where(valid[:, None], pts, 0.0).sum(0) / n
    d = torch.where(valid[:, None], torch.abs(pts - mean), 0.0)
    mdev = d.sum(0) / n
    s = 1.0 / torch.clamp(mdev, min=1e-9)
    pn = (pts - mean) * s
    z, o = pts.new_zeros(()), pts.new_ones(())
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return pn, T


def _null_vector(A):
    """Last right-singular vector of each (..., m, 9) system. The SVD runs
    in f64: PyTorch's f32 SVD of the 8x9 systems left the two-view t
    3-9x further from the f64 solution than the reference's f32 (8.6e-5
    against 2.8e-5 on a radtan stream, tests/test_torch_distorted.py),
    enough to move a landmark across the triangulation threshold."""
    _, _, vt = torch.linalg.svd(A.double(), full_matrices=True)
    return vt[..., -1, :].to(A.dtype)


def _compute_h(p1, p2):
    """8-point homography DLT (ComputeH21, :217-258), batched over sets."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([r1, r2], -2)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3)


def _compute_f(p1, p2):
    """8-point fundamental + rank-2 projection (ComputeF21, :260-297)."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o],
                    -1)
    Fp = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    u, w, vt2 = torch.linalg.svd(Fp)
    w = torch.cat([w[..., :2], torch.zeros_like(w[..., 2:])], -1)
    return (u * w[..., None, :]) @ vt2


def _transfer(H, a, b, sigma2):
    """(S, P) squared transfer error of b against H a, for S homographies."""
    H = H[:, None]
    w = H[..., 2, 0] * a[:, 0] + H[..., 2, 1] * a[:, 1] + H[..., 2, 2]
    winv = 1.0 / w
    x = (H[..., 0, 0] * a[:, 0] + H[..., 0, 1] * a[:, 1] + H[..., 0, 2]) * winv
    y = (H[..., 1, 0] * a[:, 0] + H[..., 1, 1] * a[:, 1] + H[..., 1, 2]) * winv
    return ((b[:, 0] - x) ** 2 + (b[:, 1] - y) ** 2) / sigma2


def _check_h(H21, H12, p1, p2, valid, sigma2):
    """(score (S,), inliers (S, P)) - CheckHomography (:300-379)."""
    th = 5.991
    chi1 = _transfer(H12, p2, p1, sigma2)
    chi2 = _transfer(H21, p1, p2, sigma2)
    ok = (chi1 <= th) & (chi2 <= th) & valid
    score = torch.sum(torch.where((chi1 <= th) & valid, th - chi1, 0.0)
                      + torch.where((chi2 <= th) & valid, th - chi2, 0.0), -1)
    return score, ok


def _check_f(F21, p1, p2, valid, sigma2):
    """(score (S,), inliers (S, P)) - CheckFundamental (:381-459)."""
    th = 3.841
    th_score = 5.991
    F = F21[:, None]
    a2 = F[..., 0, 0] * p1[:, 0] + F[..., 0, 1] * p1[:, 1] + F[..., 0, 2]
    b2 = F[..., 1, 0] * p1[:, 0] + F[..., 1, 1] * p1[:, 1] + F[..., 1, 2]
    c2 = F[..., 2, 0] * p1[:, 0] + F[..., 2, 1] * p1[:, 1] + F[..., 2, 2]
    num2 = a2 * p2[:, 0] + b2 * p2[:, 1] + c2
    chi1 = num2 * num2 / (a2 * a2 + b2 * b2) / sigma2

    a1 = F[..., 0, 0] * p2[:, 0] + F[..., 1, 0] * p2[:, 1] + F[..., 2, 0]
    b1 = F[..., 0, 1] * p2[:, 0] + F[..., 1, 1] * p2[:, 1] + F[..., 2, 1]
    c1 = F[..., 0, 2] * p2[:, 0] + F[..., 1, 2] * p2[:, 1] + F[..., 2, 2]
    num1 = a1 * p1[:, 0] + b1 * p1[:, 1] + c1
    chi2 = num1 * num1 / (a1 * a1 + b1 * b1) / sigma2

    ok = (chi1 <= th) & (chi2 <= th) & valid
    score = torch.sum(torch.where((chi1 <= th) & valid, th_score - chi1, 0.0)
                      + torch.where((chi2 <= th) & valid, th_score - chi2,
                                    0.0), -1)
    return score, ok


def _triangulate(P1, P2, x1, x2):
    """DLT (CheckRT, :819-825): P1 (3, 4), P2 (h, 3, 4), x1/x2 (P, 2) ->
    (h, P, 3), one 4x4 SVD a point and hypothesis."""
    h, n = P2.shape[0], x1.shape[0]
    r1 = (x1[:, 0, None] * P1[2] - P1[0]).expand(h, n, 4)
    r2 = (x1[:, 1, None] * P1[2] - P1[1]).expand(h, n, 4)
    r3 = x2[None, :, 0, None] * P2[:, None, 2] - P2[:, None, 0]
    r4 = x2[None, :, 1, None] * P2[:, None, 2] - P2[:, None, 1]
    A = torch.stack([r1, r2, r3, r4], -2)
    _, _, vt = torch.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)


def _check_rt(R, t, p1, p2, inliers, K, th2):
    """CheckRT (:776-899) for h hypotheses R (h, 3, 3), t (h, 3) against
    one inlier mask (P,). Returns (nGood (h,), parallax_deg (h,),
    X (h, P, 3), triangulated (h, P))."""
    h = R.shape[0]
    P1 = torch.cat([K, K.new_zeros(3, 1)], 1)
    P2 = K @ torch.cat([R, t[..., None]], -1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]

    X = _triangulate(P1, P2, p1, p2)
    finite = torch.all(torch.isfinite(X), -1)
    d1 = torch.linalg.norm(X, dim=-1)
    n2 = X - O2[:, None]
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = torch.sum(X * n2, -1) / torch.clamp(d1 * d2, min=1e-12)

    Xc2 = X @ R.transpose(-1, -2) + t[:, None]
    depth_ok = ~(((X[..., 2] <= 0) | (Xc2[..., 2] <= 0))
                 & (cos_par < COS_PARALLAX_GUARD))

    def reproj_err(Xc, p):
        invz = 1.0 / Xc[..., 2]
        ex = K[0, 0] * Xc[..., 0] * invz + K[0, 2] - p[:, 0]
        ey = K[1, 1] * Xc[..., 1] * invz + K[1, 2] - p[:, 1]
        return ex * ex + ey * ey

    good = (inliers & finite & depth_ok & (reproj_err(X, p1) <= th2)
            & (reproj_err(Xc2, p2) <= th2))
    n_good = good.sum(-1)

    # parallax = acos of the (min(50, n-1))-th smallest cosParallax
    cp_sorted = torch.sort(torch.where(good, cos_par, 2.0), -1).values
    idx = torch.clamp(n_good - 1, min=0, max=50)
    cp_sel = torch.clamp(cp_sorted[torch.arange(h, device=R.device), idx],
                         -1.0, 1.0)
    parallax = torch.where(n_good > 0, torch.rad2deg(torch.arccos(cp_sel)),
                           0.0)
    return n_good, parallax, X, good & (cos_par < COS_PARALLAX_GUARD)


def _det_sign(M):
    return torch.sign(torch.linalg.det(M))[..., None, None]


def _decompose_e(E):
    """DecomposeE (:901-...): E = U diag(1,1,0) V^T -> R1, R2, t."""
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2] / torch.linalg.norm(u[:, 2])
    W = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    return R1 * _det_sign(R1), R2 * _det_sign(R2), t


def _decompose_h(H, K):
    """Faugeras decomposition -> 8 (R, t) hypotheses and the validity of
    the singular values (:570-680)."""
    A = torch.linalg.inv(K) @ H @ K
    u, w, vt = torch.linalg.svd(A)
    s = torch.linalg.det(u) * torch.linalg.det(vt)
    d1, d2, d3 = w[0], w[1], w[2]
    ok = (d1 / d2 >= 1.00001) & (d2 / d3 >= 1.00001)

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3),
                                  min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3),
                                  min=0.0))
    x1 = torch.stack([aux1, aux1, -aux1, -aux1])
    x3 = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    z, o = w.new_zeros(4), w.new_ones(4)

    def rot(c, sn, sy, sz):
        # rows [c, 0, sy*sn], [0, sz, 0], [sn, 0, sz*c] per hypothesis
        return torch.stack([torch.stack([c, z, sy * sn], -1),
                            torch.stack([z, sz * o, z], -1),
                            torch.stack([sn, z, sz * c], -1)], -2)

    # case d' = d2
    aux_st = root / ((d1 + d3) * d2)
    ct = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand(4)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    Rp1 = rot(ct, st, -1.0, 1.0)
    tp1 = torch.stack([x1, z, -x3], -1) * (d1 - d3)
    # case d' = -d2
    aux_sp = root / ((d1 - d3) * d2)
    cp = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2)).expand(4)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    Rp2 = rot(cp, sp, 1.0, -1.0)
    tp2 = torch.stack([x1, z, x3], -1) * (d1 + d3)

    Rs = s * u @ torch.cat([Rp1, Rp2]) @ vt
    tv = torch.cat([tp1, tp2]) @ u.T
    ts = tv / torch.clamp(torch.linalg.norm(tv, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts, ok


def two_view_reconstruct(pts1: torch.Tensor, pts2: torch.Tensor,
                         valid: torch.Tensor, sets: torch.Tensor,
                         K: torch.Tensor) -> TwoViewResult:
    """pts1/pts2: (P, 2) matched (undistorted) pixels; valid: (P,); sets:
    (iters, 8) RANSAC sample indices into the rows; K: (3, 3). Runs on the
    tensors' device."""
    profiler.count_device("two_view_reconstruct", pts1)
    sets = sets.long()
    p1n, T1 = _normalize(pts1, valid)
    p2n, T2 = _normalize(pts2, valid)
    T2inv = torch.linalg.inv(T2)

    # every RANSAC set at once (the reference's per-set body, vmapped)
    Hn = _compute_h(p1n[sets], p2n[sets])
    Fn = _compute_f(p1n[sets], p2n[sets])
    H_all = T2inv @ Hn @ T1
    F_all = T2.T @ Fn @ T1
    SH, okH = _check_h(H_all, torch.linalg.inv(H_all), pts1, pts2, valid,
                       SIGMA2)
    SF, okF = _check_f(F_all, pts1, pts2, valid, SIGMA2)
    ih = torch.argmax(SH)
    if_ = torch.argmax(SF)
    H, inH, sh = H_all[ih], okH[ih], SH[ih]
    F, inF, sf = F_all[if_], okF[if_], SF[if_]

    use_h = sh / torch.clamp(sh + sf, min=1e-12) > 0.50
    th2 = 4.0 * SIGMA2

    # F branch: 4 hypotheses
    R1e, R2e, te = _decompose_e(K.T @ F @ K)
    RF = torch.stack([R1e, R2e, R1e, R2e])
    tF = torch.stack([te, te, -te, -te])
    nF, parF, XF, triF = _check_rt(RF, tF, pts1, pts2, inF, K, th2)
    NF = inF.sum().double()
    maxF = torch.max(nF)
    bestF = torch.argmax(nF)
    n_min = torch.clamp((0.9 * NF).long(), min=MIN_TRIANGULATED)
    nsim = torch.sum(nF.double() > 0.7 * maxF.double())
    okF_branch = ((maxF >= n_min) & (nsim == 1)
                  & (parF[bestF] > MIN_PARALLAX_DEG))

    # H branch: 8 hypotheses
    RH8, tH8, h_dec_ok = _decompose_h(H, K)
    nH, parH, XH, triH = _check_rt(RH8, tH8, pts1, pts2, inH, K, th2)
    NH = inH.sum().double()
    bestH = torch.argmax(nH)
    best_good = nH[bestH]
    second = torch.max(torch.where(
        torch.arange(8, device=nH.device) == bestH, -1, nH))
    okH_branch = (h_dec_ok & (second < 0.75 * best_good)
                  & (parH[bestH] >= MIN_PARALLAX_DEG)
                  & (best_good > MIN_TRIANGULATED)
                  & (best_good.double() > 0.9 * NH))

    ok = torch.where(use_h, okH_branch, okF_branch)
    R = torch.where(use_h, RH8[bestH], RF[bestF])
    t = torch.where(use_h, tH8[bestH], tF[bestF])
    X = torch.where(use_h, XH[bestH], XF[bestF])
    tri = torch.where(use_h, triH[bestH], triF[bestF])
    return TwoViewResult(ok=ok, R21=R, t21=t, points3d=X,
                         triangulated=tri & ok)


def make_ransac_sets(n_valid_idx: np.ndarray, iters: int = RANSAC_ITERS,
                     seed: int = 0) -> np.ndarray:
    """Host helper: (iters, 8) sample index sets over the valid match slots
    (without replacement per iteration, seeded like the reference's srand(0)
    determinism hook, System.cpp:119). A copy of the reference's."""
    rng = np.random.RandomState(seed)
    n = len(n_valid_idx)
    sets = np.zeros((iters, 8), np.int32)
    for it in range(iters):
        sets[it] = n_valid_idx[rng.choice(n, 8, replace=(n < 8))]
    return sets
