"""PPG edge (line-segment) ops over the dense (K, K) pair grid: a plain
PyTorch port of ppg_slam_tpu/ops/lines.py. Off the main path: the extractor
runs the compacted candidate form (ops/pairs.py and the fused CUDA kernels
pair_probe / line_validate).

Reference behavior (PPGExtractor.cpp detectLines :236-442, heatMapInlierRate
:461-498, heatMapLineScore :500-513):
  * candidate gate: 3 probes at 20/50/80% of the segment must have heat >= 0.2
    at the *rounded* pixel (int(v + 0.5));
  * validation: segNum = int(dist * invGapTable[lenLevel]) samples along the
    segment; inlier rate = fraction of rounded-pixel probes with heat > 0.2;
    line score = mean bilinear heat; thresholds 0.8 / 0.2; lscore = rate*score.
"""

from __future__ import annotations

import torch

from .heatmap import bilinear_sample
from .pairs import INV_SAMPLE_GAP, LINE_HEATMAP_THRESH, LINE_INLIER_RATE  # noqa: F401

LINE_DISTTHRESH = 2.0  # px (PPGExtractor.cpp:50; the graph build's)
MAX_SAMPLES = 128  # segNum is provably < 100 for all supported resolutions


def pair_probe_mask(heat: torch.Tensor, kp_un: torch.Tensor,
                    kp_ok: torch.Tensor) -> torch.Tensor:
    """3-midpoint probe gate over all keypoint pairs.

    heat: (H, W) refined+undistorted heat map; kp_un: (K, 2) undistorted
    positions; kp_ok: (K,) validity (in-image and not padding).
    Returns (K, K) bool, symmetric, i<j meaningful, diag False.
    """
    h, w = heat.shape
    k = kp_un.shape[0]
    pi = kp_un[:, None, :]
    pj = kp_un[None, :, :]

    def probe(alpha):
        p = pj * alpha + pi * (1.0 - alpha)
        x = torch.clamp((p[..., 0] + 0.5).to(torch.int64), 0, w - 1)
        y = torch.clamp((p[..., 1] + 0.5).to(torch.int64), 0, h - 1)
        return heat[y, x] >= LINE_HEATMAP_THRESH

    ok = probe(0.2) & probe(0.8) & probe(0.5)
    valid_pair = kp_ok[:, None] & kp_ok[None, :]
    not_diag = ~torch.eye(k, dtype=torch.bool, device=heat.device)
    return ok & valid_pair & not_diag


def validate_edges(heat: torch.Tensor, ps: torch.Tensor, pe: torch.Tensor,
                   cand_ok: torch.Tensor, max_samples: int = MAX_SAMPLES):
    """Sampled line validation for a padded candidate list.

    ps/pe: (E, 2) float endpoint positions (undistorted); cand_ok: (E,) mask.
    Returns (inlier_rate, heat_score): (E,) floats. Candidates with
    segNum < 2 return rate=1, score=midpoint bilinear heat (the reference hits
    0/0 = NaN there, which its thresholds treat as "pass"; this passes
    cleanly).
    """
    h, w = heat.shape
    dt = heat.dtype
    d = torch.linalg.norm(pe - ps, dim=-1)
    inv_scale = 1.0 / torch.sqrt(torch.tensor(float(h * h + w * w),
                                              dtype=torch.float32))
    len_level = torch.clamp((d * inv_scale * 4.0).to(torch.int64), 0, 3)
    inv_gap = torch.tensor(INV_SAMPLE_GAP, dtype=dt,
                           device=heat.device)[len_level]
    seg_num = (d * inv_gap).to(torch.int64)

    i = torch.arange(1, max_samples + 1, dtype=dt, device=heat.device)
    sn = torch.clamp(seg_num, min=2).to(dt)[:, None]
    step = 1.0 / sn
    alpha = i[None, :] * step  # weight on ps
    # sample = ps * step*i + pe * step*(segNum - i)
    sample = ps[:, None, :] * alpha[..., None] + pe[:, None, :] * (
        (sn - i[None, :])[..., None] * step[..., None])
    smask = (i[None, :] <= (seg_num[:, None] - 1)) & cand_ok[:, None]

    sx, sy = sample[..., 0], sample[..., 1]
    rx = torch.clamp((sx + 0.5).to(torch.int64), 0, w - 1)
    ry = torch.clamp((sy + 0.5).to(torch.int64), 0, h - 1)
    inlier = (heat[ry, rx] > LINE_HEATMAP_THRESH) & smask
    bil = bilinear_sample(heat, sx, sy) * smask

    denom = torch.clamp(seg_num - 1, min=1).to(dt)
    rate = inlier.sum(dim=1).to(dt) / denom
    score = bil.sum(dim=1) / denom

    # segNum < 2: single midpoint fallback
    mid = 0.5 * (ps + pe)
    mid_v = bilinear_sample(heat, mid[..., 0], mid[..., 1])
    few = seg_num < 2
    rate = torch.where(few, torch.ones_like(rate), rate)
    score = torch.where(few, mid_v, score)
    return rate, score


def pair_geometry(kp_un: torch.Tensor):
    """(K, 2) undistorted keypoints -> (dist, dir) matrices, matching
    PPGExtractor.cpp:266-291: dir[i,j] = atan2(dy, dx) of j-i; dir[j,i] =
    dir[i,j] - pi wrapped to (-pi, pi]."""
    diff = kp_un[None, :, :] - kp_un[:, None, :]  # [i, j] = pj - pi
    dist = torch.linalg.norm(diff, dim=-1)
    ang = torch.atan2(diff[..., 1], diff[..., 0])
    return dist, ang
