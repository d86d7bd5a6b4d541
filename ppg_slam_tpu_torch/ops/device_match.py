"""Device-side gated descriptor matching: per-map-point top-K in-gate
keypoint distances.

Port of ppg_slam_tpu/ops/device_match.py. Frame descriptors stay on the
device; for each candidate map point the K nearest frame keypoints inside its
gate rectangle are found on the device, and only a flat (row, kp, dist) list
goes to the host (`pack_match`, the reference's byte layout, so the host
matcher reads it unchanged). `quantize_desc_i8` serves the keyframe-rate
host descriptor fetch.

Ranking ties: the reference's top_k puts the lower index first among equal
distances; a stable ascending sort does the same here.
"""

from __future__ import annotations

import numpy as np
import torch

MATCH_K = 8          # kept candidates per map point
BIG = 1e6
PAIR_CAP = 4096      # flat gated-pair transfer budget per frame (~24 KB)


def dist_block(bank_rows: torch.Tensor, frame_desc: torch.Tensor) -> torch.Tensor:
    """Pairwise L2 distances (M, N) of bf16-rounded operands with f32
    products and sums (norms + matmul + sqrt of the clamped square)."""
    a = bank_rows.to(torch.bfloat16)
    b = frame_desc.to(torch.bfloat16)
    a2 = (a * a).float().sum(dim=1)
    b2 = (b * b).float().sum(dim=1)
    # bf16 values are exact in f32 and their products too: an f32 matmul of
    # the upcast operands is the bf16-operand / f32-accumulate product
    d2 = a2[:, None] + b2[None, :] - 2.0 * (a.float() @ b.float().T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def gated_topk(bank: torch.Tensor, bank_idx: torch.Tensor,
               frame_desc: torch.Tensor, kp_pos: torch.Tensor,
               kp_valid: torch.Tensor, rects: torch.Tensor, k: int = MATCH_K):
    """Top-k in-gate matches for M map points against one frame.

    bank:       (CAP, 256) f32 persistent descriptor bank
    bank_idx:   (M,) int bank slots of this frame's candidate map points
                (negative = dead row)
    frame_desc: (N, 256) f32 frame descriptors
    kp_pos:     (N, 2) f32 keypoint positions
    kp_valid:   (N,) bool grid-assignment eligibility
    rects:      (M, 4) f32 [x_lo, x_hi, y_lo, y_hi] open-interval gate boxes

    Returns (idx (M, k) int32, dist (M, k) f32, n_gated (M,) int32); slots
    beyond a row's gate population have idx -1 / dist BIG."""
    live = bank_idx >= 0
    sel = torch.where(live, bank_idx, 0).long()
    rows = bank.to(torch.bfloat16).index_select(0, sel)
    D = dist_block(rows, frame_desc)  # (M, N)

    x = kp_pos[:, 0][None, :]
    y = kp_pos[:, 1][None, :]
    inside = ((x > rects[:, 0:1]) & (x < rects[:, 1:2])
              & (y > rects[:, 2:3]) & (y < rects[:, 3:4])
              & kp_valid[None, :] & live[:, None])
    n_gated = inside.sum(dim=1).to(torch.int32)
    Dm = torch.where(inside, D, D.new_full((), BIG))
    dist, idx = torch.sort(Dm, dim=1, stable=True)
    dist = dist[:, :k]
    idx = torch.where(dist < BIG, idx[:, :k], -1)
    return idx.to(torch.int32), dist, n_gated


def flatten_topk(idx: torch.Tensor, dist: torch.Tensor, n_gated: torch.Tensor,
                 pair_cap: int = PAIR_CAP):
    """Compact the (M, k) top-K tables into a flat pair list of at most
    pair_cap live entries, in row order. Also returns the total live-pair
    count and the number of rows whose gate exceeded k."""
    m, k = idx.shape
    pair_cap = min(pair_cap, m * k)
    dev = idx.device
    live = (idx >= 0).reshape(-1)
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    slot = torch.where(live & (pos < pair_cap), pos, pair_cap)
    sel = torch.zeros(pair_cap + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(m * k, device=dev))
    n_pairs = live.sum()
    ok = torch.arange(pair_cap, device=dev) < n_pairs
    sel = torch.where(ok, sel[:pair_cap], 0)
    flat_rows = torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(k)
    rows = torch.where(ok, flat_rows[sel], -1)
    kps = torch.where(ok, idx.reshape(-1)[sel], -1)
    ds = torch.where(ok, dist.reshape(-1)[sel], dist.new_full((), BIG))
    n_over = (n_gated > k).sum()
    return rows, kps, ds, n_pairs, n_over


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def pack_match(rows, kps, ds, n_pairs, n_over) -> torch.Tensor:
    """One frame's flat match list as one uint8 buffer: int16 rows, int16
    kps, f16 dists, then the two int32 counters (the reference layout)."""
    counters = torch.stack([n_pairs.to(torch.int32), n_over.to(torch.int32)])
    return torch.cat([_bytes(rows.to(torch.int16)), _bytes(kps.to(torch.int16)),
                      _bytes(ds.to(torch.float16)), _bytes(counters)])


def unpack_match(buf: np.ndarray, pair_cap: int = PAIR_CAP):
    """Host-side inverse of pack_match: (rows, kps, dists, n_pairs, n_over)."""
    p = pair_cap
    rows = buf[:2 * p].view(np.int16)
    kps = buf[2 * p:4 * p].view(np.int16)
    ds = buf[4 * p:6 * p].view(np.float16)
    n_pairs, n_over = buf[6 * p:6 * p + 8].view(np.int32)
    return rows, kps, ds, int(n_pairs), int(n_over)


def match_bytes(pair_cap: int = PAIR_CAP) -> int:
    """The length of one frame's pack_match buffer."""
    return pair_cap * 6 + 8


def gated_match_packed(bank, bank_idx, frame_desc, kp_pos, kp_valid, rects,
                       k: int = MATCH_K, pair_cap: int = PAIR_CAP):
    out = gated_topk(bank, bank_idx, frame_desc, kp_pos, kp_valid, rects, k=k)
    return pack_match(*flatten_topk(*out, pair_cap=pair_cap))


def gated_match_batch_packed(bank, bank_idx_b, frame_desc_b, kp_pos_b,
                             kp_valid_b, rects_b, k: int = MATCH_K,
                             pair_cap: int = PAIR_CAP) -> torch.Tensor:
    """B frames against the shared bank (the serving/throughput shape):
    gated_match_packed frame by frame over the leading axis of every other
    argument; output (B, match_bytes(pair_cap)) uint8."""
    return torch.stack([
        gated_match_packed(bank, bi, fd, kp, kv, rc, k=k, pair_cap=pair_cap)
        for bi, fd, kp, kv, rc in zip(bank_idx_b, frame_desc_b, kp_pos_b,
                                      kp_valid_b, rects_b)])


def bank_update(bank: torch.Tensor, slots: torch.Tensor,
                descs: torch.Tensor) -> torch.Tensor:
    """Write `descs` (U, 256) into `bank` at `slots` (U,). Updates the bank
    in place (the reference returns a new array) and returns it."""
    bank.index_copy_(0, slots.long(), descs.to(bank.dtype))
    return bank


def quantize_desc_i8(descs: torch.Tensor) -> torch.Tensor:
    """Per-descriptor max-abs int8 quantization for the keyframe-rate host
    fetch: int8 codes then f16 scales, as one uint8 buffer."""
    scale = torch.clamp(descs.abs().amax(dim=1), min=1e-8)
    q = torch.clamp(torch.round(descs / scale[:, None] * 127.0),
                    -127, 127).to(torch.int8)
    return torch.cat([_bytes(q), _bytes(scale.to(torch.float16))])


def dequantize_desc_i8(buf: np.ndarray, n: int, dim: int = 256) -> np.ndarray:
    q = buf[:n * dim].view(np.int8).reshape(n, dim).astype(np.float32)
    scale = buf[n * dim:n * dim + 2 * n].view(np.float16).astype(np.float32)
    return q * (scale / 127.0)[:, None]
