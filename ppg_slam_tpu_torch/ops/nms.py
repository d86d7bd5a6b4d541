"""Exact greedy keypoint NMS (reference PPGExtractor.cpp:158-206).

Port of ppg_slam_tpu/ops/nms.py `nms_keypoints` and its spec oracle
`nms_keypoints_scan`. The reference sorts all
above-threshold junction pixels by score and greedily accepts them,
suppressing a (2r+1)^2 window around each accepted point, capped at 500.

Iterated local-max acceptance: a candidate whose score is the maximum over
its (2r+1)^2 window is accepted; a dilation of the accepted set suppresses
its neighbours; repeat until no candidates remain (at most `max_iters`
rounds). For distinct scores this equals greedy NMS. Ties inside one window
are resolved towards the lower flat index in a final pass, and the top
`max_kp` by (score desc, flat index asc) give the reference's acceptance
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_KEYPOINTS = 500  # JUNCTION_MAX_NUM (PPGExtractor.cpp:47)
NMS_RADIUS = 4  # JUNCTION_NMS_RADIUS
JUNCTION_THRESH = 1.0 / 128.0
TOPK_CANDIDATES = 2048  # candidates nms_keypoints_scan visits
_CHECK_EVERY = 4  # rounds between host checks for an empty candidate set


def _maxpool(a: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable (2r+1)^2 max with -inf padding ("SAME" window)."""
    win = 2 * radius + 1
    a = F.max_pool2d(a[None], (win, 1), stride=1, padding=(radius, 0))
    return F.max_pool2d(a, (1, win), stride=1, padding=(0, radius))[0]


def nms_keypoints(junc_prob: torch.Tensor, thresh: float = JUNCTION_THRESH,
                  max_kp: int = MAX_KEYPOINTS, radius: int = NMS_RADIUS,
                  max_iters: int = 32):
    """Greedy NMS of a (H, W) f32 junction map.

    Returns (xy, score, valid): (max_kp, 2) int32 pixel coords (x, y),
    (max_kp,) f32 scores, (max_kp,) bool validity, in acceptance order
    (score desc, flat index asc on ties)."""
    h, w = junc_prob.shape
    dev = junc_prob.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    border_ok = ((xs >= radius) & (xs <= w - radius - 1)
                 & (ys >= radius) & (ys <= h - radius - 1))
    cand = (junc_prob >= thresh) & border_ok
    acc = torch.zeros_like(cand)
    neg_inf = junc_prob.new_full((), float("-inf"))
    one = junc_prob.new_ones(())

    # Rounds after the candidate set empties change nothing, so the set is
    # checked on the host only every few rounds.
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool(cand.any()):
            break
        sc = torch.where(cand, junc_prob, neg_inf)
        local = cand & (sc >= _maxpool(sc, radius))
        acc = acc | local
        # dilate the accepted set to suppress its neighbourhood (incl. itself)
        sup = _maxpool(torch.where(local, one, neg_inf), radius) > 0
        cand = cand & ~sup

    # tie clean-up: two accepted equal-score pixels inside one window -> keep
    # the lower flat index (greedy accepts the earlier candidate first)
    flat_idx = (ys * w + xs).to(torch.float32)
    asc = torch.where(acc, junc_prob, neg_inf)
    amax = _maxpool(asc, radius)
    at_max = acc & (asc == amax)
    idx_of_max = -_maxpool(torch.where(at_max, -flat_idx, neg_inf), radius)
    acc = acc & ~(at_max & (flat_idx > idx_of_max))

    # rank by (score desc, flat index asc): a stable descending sort keeps
    # the lower flat index first among equal scores
    sc_flat = torch.where(acc, junc_prob, junc_prob.new_zeros(())).reshape(-1)
    kp_scores, idx = torch.sort(sc_flat, descending=True, stable=True)
    kp_scores = kp_scores[:max_kp]
    idx = idx[:max_kp]
    valid = kp_scores > 0.0
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    xy = torch.where(valid[:, None], xy,
                     torch.full_like(xy, -(10 * (radius + 1))))
    return xy, kp_scores, valid


def nms_keypoints_scan(junc_prob: torch.Tensor,
                       thresh: float = JUNCTION_THRESH,
                       max_kp: int = MAX_KEYPOINTS, radius: int = NMS_RADIUS,
                       topk: int = TOPK_CANDIDATES):
    """Greedy NMS as a sequential scan (the behavioural spec that
    nms_keypoints must match): the `topk` highest pixels, by (score desc,
    flat index asc), are visited in order; one at or above `thresh`, at
    least `radius` from the border and outside the (2r+1)^2 window of every
    keypoint accepted so far is accepted, up to `max_kp`. The scan runs on
    the host; the outputs come back on the input's device.

    Returns (xy, score, valid) as nms_keypoints does, in acceptance
    order."""
    h, w = junc_prob.shape
    flat = junc_prob.reshape(-1)
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores = scores[:topk].cpu().numpy()
    idx = idx[:topk].cpu().numpy()
    ys, xs = idx // w, idx % w
    cand_ok = ((scores >= thresh) & (xs >= radius) & (xs <= w - radius - 1)
               & (ys >= radius) & (ys <= h - radius - 1))
    pad = -(10 * (radius + 1))
    sx = np.full(max_kp, pad, np.int64)
    sy = np.full(max_kp, pad, np.int64)
    kp_scores = np.zeros(max_kp, scores.dtype)
    count = 0
    for x, y, sc, ok in zip(xs, ys, scores, cand_ok):
        if not ok or count >= max_kp:
            continue
        if ((np.abs(sx[:count] - x) <= radius)
                & (np.abs(sy[:count] - y) <= radius)).any():
            continue
        sx[count], sy[count], kp_scores[count] = x, y, sc
        count += 1
    dev = junc_prob.device
    xy = torch.from_numpy(np.stack([sx, sy], -1).astype(np.int32)).to(dev)
    valid = torch.arange(max_kp, device=dev) < count
    return xy, torch.from_numpy(kp_scores).to(dev), valid
