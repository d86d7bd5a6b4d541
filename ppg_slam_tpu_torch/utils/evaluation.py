"""Trajectory evaluation (a copy of ppg_slam_tpu/utils/evaluation.py): Umeyama alignment + ATE RMSE on TUM-format files.

The reference's de-facto accuracy harness is offline ATE over the TUM-format
trajectories written at shutdown (the reference's system/src/Viewer.cpp:853-959,
evaluated externally with evo); BASELINE.md demands ATE RMSE within 5% of the
reference on EuRoC/TUM-VI. This module is the in-repo equivalent of
`evo_ape tum GT EST -a [-s]`: associate stamps, align (SE3 or Sim3), report
RMSE/mean/median/max.  Used by the port's pipeline tests and chip_smoke.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class AteResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    n_pairs: int
    scale: float  # the Sim3 scale applied (1.0 for SE3 alignment)


def umeyama(est: np.ndarray, gt: np.ndarray,
            with_scale: bool = True) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform (s, R, t) minimizing
    ||(s*R@est + t) - gt||^2 (Umeyama 1991). est/gt: (N,3)."""
    E = np.asarray(est, np.float64)
    G = np.asarray(gt, np.float64)
    mu_e, mu_g = E.mean(0), G.mean(0)
    cov = (G - mu_g).T @ (E - mu_e) / len(E)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (E - mu_e).var(0).sum()
        s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray,
             with_scale: bool = True) -> float:
    """Umeyama-aligned ATE RMSE between matched position arrays (N,3)."""
    return align_and_ate(est, gt, with_scale=with_scale).rmse


def align_and_ate(est: np.ndarray, gt: np.ndarray,
                  with_scale: bool = True) -> AteResult:
    s, R, t = umeyama(est, gt, with_scale=with_scale)
    resid = (np.asarray(est, np.float64) @ (s * R).T + t) - gt
    err = np.sqrt((resid ** 2).sum(1))
    return AteResult(rmse=float(np.sqrt((err ** 2).mean())),
                     mean=float(err.mean()), median=float(np.median(err)),
                     max=float(err.max()), n_pairs=len(err), scale=s)


def load_tum(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file -> (stamps (N,), positions (N,3)).
    Lines: `t x y z qx qy qz qw`; '#' comments and blank lines skipped.
    EuRoC ground-truth CSVs (comma-separated, ns stamps) are also accepted."""
    stamps, pos = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 4:
                continue
            try:
                vals = [float(p) for p in parts[:4]]
            except ValueError:
                continue  # header row
            t = vals[0]
            if t > 1e14:  # nanosecond stamps (EuRoC state_groundtruth CSV)
                t *= 1e-9
            stamps.append(t)
            pos.append(vals[1:4])
    if not stamps:
        raise ValueError(f"no trajectory rows in {path}")
    return np.asarray(stamps), np.asarray(pos)


def associate(t_est: np.ndarray, t_gt: np.ndarray,
              max_diff: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-stamp association (each gt row used at most once).
    Returns index arrays (into est, into gt)."""
    order = np.argsort(t_gt)
    tg = t_gt[order]
    ie, ig = [], []
    used = np.zeros(len(tg), bool)
    for i, t in enumerate(t_est):
        j = int(np.searchsorted(tg, t))
        best, bd = -1, max_diff
        for k in (j - 1, j):
            if 0 <= k < len(tg) and not used[k]:
                d = abs(tg[k] - t)
                if d <= bd:
                    best, bd = k, d
        if best >= 0:
            used[best] = True
            ie.append(i)
            ig.append(int(order[best]))
    return np.asarray(ie, int), np.asarray(ig, int)


def evaluate_files(est_path: str, gt_path: str, with_scale: bool = True,
                   max_diff: float = 0.02) -> AteResult:
    """ATE between two trajectory files after stamp association."""
    te, pe = load_tum(est_path)
    tg, pg = load_tum(gt_path)
    ie, ig = associate(te, tg, max_diff=max_diff)
    if len(ie) < 3:
        raise ValueError(
            f"only {len(ie)} associated pairs (est {len(te)}, gt {len(tg)}) "
            f"— check timestamps/max_diff")
    return align_and_ate(pe[ie], pg[ig], with_scale=with_scale)


def rpe_trans(t_est: np.ndarray, p_est: np.ndarray, t_gt: np.ndarray,
              p_gt: np.ndarray, delta: float = 1.0,
              with_scale: bool = True) -> AteResult:
    """Translational Relative Pose Error over time windows of `delta`
    seconds (the `evo_rpe`/TUM-benchmark drift metric): for every stamp
    pair (t, t+delta), compare the estimated displacement NORM against the
    ground-truth one. Scale (monocular) is fixed globally by the Umeyama
    alignment first so RPE measures local drift, not global scale."""
    s, _, _ = umeyama(p_est, p_gt, with_scale=with_scale)
    pe = p_est * s
    errs = []
    j0 = 0
    for i, t in enumerate(t_est):
        j = int(np.searchsorted(t_est, t + delta, side="left"))
        if j >= len(t_est):
            break
        if abs((t_est[j] - t) - delta) > 0.5 * delta:
            continue
        d_est = np.linalg.norm(pe[j] - pe[i])
        d_gt = np.linalg.norm(p_gt[j] - p_gt[i])
        errs.append(abs(d_est - d_gt))
    if not errs:
        raise ValueError("no stamp pairs at the requested delta")
    err = np.asarray(errs)
    return AteResult(rmse=float(np.sqrt((err ** 2).mean())),
                     mean=float(err.mean()), median=float(np.median(err)),
                     max=float(err.max()), n_pairs=len(err), scale=s)


def evaluate_files_rpe(est_path: str, gt_path: str, delta: float = 1.0,
                       with_scale: bool = True,
                       max_diff: float = 0.02) -> AteResult:
    """Translational RPE between two trajectory files (associated stamps)."""
    te, pe = load_tum(est_path)
    tg, pg = load_tum(gt_path)
    ie, ig = associate(te, tg, max_diff=max_diff)
    if len(ie) < 3:
        raise ValueError(f"only {len(ie)} associated pairs")
    return rpe_trans(te[ie], pe[ie], tg[ig], pg[ig], delta=delta,
                     with_scale=with_scale)
