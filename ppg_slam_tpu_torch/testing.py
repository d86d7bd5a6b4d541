"""Fixtures and bounds that the port's tests and chip_smoke.py share.

Imports neither jax nor ppg_slam_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

# lscore = rate * score, and the fused line_validate kernel sums a score's
# <= 126 non-negative samples in another order than PyTorch's reduction: two
# orders differ by at most 2 (n - 1) units of the sum's last place (250 at
# n = 126), plus the division and product's roundings
LSCORE_MAX_ULP = 256


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two non-negative
    f32 tensors (0 where they are empty)."""
    if not a.numel():
        return 0
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def saturating_case():
    """(heat, kp, kp_ok) as numpy: 320x240 heat at 0.9 everywhere and 500
    keypoints in two clusters (keypoint 0 in the near one, keypoint 1 in the
    far one). Every pair passes all three probes (saturated), and the first
    CAND_CAP candidates hold more than LONG_CAP longs (pairs across the
    clusters) and more than SCORE_S_CAP rate-passing shorts (overflow)."""
    rng = np.random.RandomState(21)
    n = 500
    near = rng.rand(n) < 0.6
    near[:2] = True, False
    a = np.stack([rng.uniform(20, 100, n), rng.uniform(20, 100, n)], 1)
    b = np.stack([rng.uniform(230, 300, n), rng.uniform(160, 225, n)], 1)
    kp = np.where(near[:, None], a, b).astype(np.float32)
    return np.full((240, 320), 0.9, np.float32), kp, np.ones(n, bool)
