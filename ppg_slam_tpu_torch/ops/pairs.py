"""Device-side PPG pair probing, candidate extraction, and line validation.

Port of ppg_slam_tpu/ops/pairs.py (reference detectLines,
PPGExtractor.cpp:236-442), with the same fixed caps and flags:

  1. all-pairs 3-probe gate (:303-313): the midpoint probe runs over every
     (i<j) pair, the first PHASE2_CAP survivors in lexicographic (i, j) order
     are probed at 20%/80%;
  2. the first CAND_CAP pairs passing all three probes, in lexicographic
     order (the reference's construction order, which the host greedy
     suppression depends on);
  3. per-candidate pair geometry (dist / atan2 both directions, :266-291);
  4. sampled line validation (heatMapInlierRate :461-498, heatMapLineScore
     :500-513): the binary inlier rate for every candidate on fixed sample
     grids (shorts on (CAND_CAP, SHORT_S), the first LONG_CAP longs on
     (LONG_CAP, MAX_SEG)), the bilinear heat score only where the rate
     passes (the first SCORE_S_CAP shorts, the first LONG_CAP longs).

`probe_and_select` and `validate_candidates` take `impl="kernel"|"plain"`.
"kernel" launches a fused CUDA kernel on CUDA tensors (`pair_probe`,
kernels/pair_probe.cu, for steps 1-2; `line_validate`,
kernels/line_validate.cu, for step 4), or raises; on CPU tensors it runs the
plain version. "plain" is the plain PyTorch version on any device: the
compactions are a cumsum + scatter (the reference uses top_k on negated
indices) and every nearest sample of the binary line mask goes through
ops.sampling.nearest_binary_packed_ref. The packed masks
(`pack_binary_mask`) and `candidate_geometry` are plain PyTorch in both.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .sampling import bilinear_f32, nearest_binary_packed_ref, pack_binary_mask

LINE_HEATMAP_THRESH = 0.2
LINE_INLIER_RATE = 0.8
INV_SAMPLE_GAP = (0.3333, 0.200, 0.1427, 0.1111)  # PPGExtractor.cpp:19

PHASE2_CAP = 16384            # pairs surviving the midpoint probe
CAND_CAP = 4096               # pairs surviving all 3 probes
MAX_SEG = 127
SHORT_S = 32                  # sample slots for short candidates (seg <= 32)
LONG_CAP = 512                # max long candidates (seg in (32, MAX_SEG])
SCORE_S_CAP = 2048            # rate-passing shorts that get a heat score

MAX_KP = 512                  # the fused pair probe's bitmask scratch

IMPLS = ("kernel", "plain")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    _require(dev.type == "cuda", f"{name} launches a CUDA kernel; got {dev}")
    _require(all(t.device == dev for t in tensors),
             f"{name}: all inputs must be on one device")
    _require(all(t.is_contiguous() for t in tensors),
             f"{name}: inputs must be contiguous")


def _round_clip(v: torch.Tensor, lim: int) -> torch.Tensor:
    """(v + 0.5) truncated toward zero, then clipped to [0, lim]."""
    return (v + 0.5).to(torch.int32).clamp(0, lim)


def _compact(mask: torch.Tensor, cap: int):
    """Positions of the first `cap` True entries of a 1-D mask, in order.

    Returns (sel (cap,) int64 with 0 in unused slots, valid (cap,) bool,
    count: 0-d int64 number of True entries, which may exceed cap)."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)  # slot `cap` is dropped
    sel = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(n, device=dev))
    count = pos[-1] + 1 if n else torch.zeros((), dtype=torch.int64, device=dev)
    valid = torch.arange(cap, device=dev) < count
    return torch.where(valid, sel[:cap], 0), valid, count


def _update_compacted(dst: torch.Tensor, sel: torch.Tensor, valid: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """dst.at[sel].set(where(valid, vals, dst[sel])) with the reference's
    in-order semantics: unused slots point at index 0 and come after the
    valid ones, so they write dst[0]'s old value back last. Index 0 keeps
    its update only when every slot is valid (see ROADMAP.md §3)."""
    out = dst.clone()
    out[torch.where(valid, sel, 0)] = torch.where(valid, vals, dst[sel])
    out[0] = torch.where(valid.all(), out[0], dst[0])
    return out


def _probe_from_mask(mask: torch.Tensor, h: int, w: int, kp_un: torch.Tensor,
                     kp_ok: torch.Tensor):
    """Plain version of the pair probe on the packed mask of heat >= 0.2."""
    k = kp_un.shape[0]
    dev = mask.device
    sample = nearest_binary_packed_ref

    # phase 1: midpoint probe of every (i, j) by outer broadcasting
    x = kp_un[:, 0]
    y = kp_un[:, 1]
    pmx = x[:, None] * 0.5 + x[None, :] * 0.5
    pmy = y[:, None] * 0.5 + y[None, :] * 0.5
    hit_m = sample(mask, _round_clip(pmy.reshape(-1), h - 1),
                   _round_clip(pmx.reshape(-1), w - 1)).reshape(k, k)
    ar = torch.arange(k, device=dev)
    okm = kp_ok[:, None] & kp_ok[None, :] & (ar[:, None] < ar[None, :])
    pass1 = (hit_m & okm).reshape(-1)

    # survivors in row-major (= lex (i, j)) order
    sel1, valid1, n_pass1 = _compact(pass1, PHASE2_CAP)
    i1 = sel1 // k
    j1 = sel1 % k
    a1 = kp_un[i1]
    b1 = kp_un[j1]

    # phase 2: 20% / 80% probes of the survivors
    p02 = b1 * 0.2 + a1 * 0.8
    p08 = b1 * 0.8 + a1 * 0.2
    ys = torch.cat([_round_clip(p02[:, 1], h - 1), _round_clip(p08[:, 1], h - 1)])
    xs = torch.cat([_round_clip(p02[:, 0], w - 1), _round_clip(p08[:, 0], w - 1)])
    hits = sample(mask, ys, xs)
    pass2 = valid1 & hits[:PHASE2_CAP] & hits[PHASE2_CAP:]

    sel2, cand_valid, n_cand = _compact(pass2, CAND_CAP)
    ci = torch.where(cand_valid, i1[sel2], 0)
    cj = torch.where(cand_valid, j1[sel2], 0)
    saturated = (n_pass1 > PHASE2_CAP) | (n_cand > CAND_CAP)
    return dict(ci=ci, cj=cj, cand_valid=cand_valid, n_cand=n_cand,
                saturated=saturated)


def _pair_probe_launch(mask: torch.Tensor, h: int, w: int,
                       kp_un: torch.Tensor, kp_ok: torch.Tensor):
    """Launch kernels/pair_probe.cu on the packed mask of heat >= 0.2."""
    _require_cuda("pair_probe", mask, kp_un, kp_ok)
    _require(mask.dtype == torch.uint8 and mask.shape == (h, (w + 7) // 8),
             "pair_probe: mask must be the (H, ceil(W/8)) uint8 packed mask")
    k = kp_un.shape[0]
    _require(kp_un.dtype == torch.float32 and kp_un.shape == (k, 2),
             "pair_probe: kp_un must be (K, 2) float32")
    _require(kp_ok.dtype == torch.bool and kp_ok.shape == (k,),
             "pair_probe: kp_ok must be (K,) bool")
    _require(k <= MAX_KP, f"pair_probe takes at most {MAX_KP} keypoints, "
                          f"not {k}")
    dev = mask.device
    n_words = k * ((k + 31) // 32)
    scratch = torch.empty(max(2 * n_words, 1), dtype=torch.int32, device=dev)
    out = dict(ci=torch.empty(CAND_CAP, dtype=torch.int64, device=dev),
               cj=torch.empty(CAND_CAP, dtype=torch.int64, device=dev),
               cand_valid=torch.empty(CAND_CAP, dtype=torch.bool, device=dev),
               n_cand=torch.empty((), dtype=torch.int64, device=dev),
               saturated=torch.empty((), dtype=torch.bool, device=dev))
    kernels.check_device("pair_probe", dev)
    code = kernels.launcher("pair_probe")(
        mask.data_ptr(), kp_un.data_ptr(), kp_ok.data_ptr(),
        scratch.data_ptr(), out["ci"].data_ptr(), out["cj"].data_ptr(),
        out["cand_valid"].data_ptr(), out["n_cand"].data_ptr(),
        out["saturated"].data_ptr(), k, h, w,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch("pair_probe", code)
    pair_probe.launches += 1
    return out


def pair_probe(heat: torch.Tensor, kp_un: torch.Tensor, kp_ok: torch.Tensor):
    """The fused CUDA pair probe (kernels/pair_probe.cu): probe_and_select on
    CUDA tensors. Raises on other devices or inputs the kernel does not
    take (K > MAX_KP, wrong dtypes or shapes, non-contiguous tensors)."""
    _require_cuda("pair_probe", heat)
    _require(heat.dtype == torch.float32 and heat.dim() == 2,
             "pair_probe: heat must be (H, W) float32")
    h, w = heat.shape
    mask = pack_binary_mask(heat >= LINE_HEATMAP_THRESH)
    return _pair_probe_launch(mask, h, w, kp_un, kp_ok)


pair_probe.launches = 0  # CUDA kernel launches, for chip_smoke.py


def probe_and_select(heat: torch.Tensor, kp_un: torch.Tensor,
                     kp_ok: torch.Tensor, impl: str = "kernel"):
    """3-probe gate over all pairs + compaction to the CAND_CAP bucket.

    heat: (H, W) f32 in undistorted coords; kp_un (K, 2) f32; kp_ok (K,)
    bool. Returns dict(ci, cj, cand_valid, n_cand, saturated): (CAND_CAP,)
    int64 / int64 / bool, 0-d int64 / bool. impl="kernel" launches
    `pair_probe` on CUDA tensors and runs the plain version on CPU tensors;
    impl="plain" runs the plain version."""
    _check_impl(impl)
    if impl == "kernel" and heat.device.type != "cpu":
        return pair_probe(heat, kp_un, kp_ok)
    h, w = heat.shape
    return _probe_from_mask(pack_binary_mask(heat >= LINE_HEATMAP_THRESH),
                            h, w, kp_un, kp_ok)


def candidate_geometry(kp_un: torch.Tensor, ci: torch.Tensor, cj: torch.Tensor):
    """Per-candidate dist / ang (both directions), direct atan2 both ways."""
    d = kp_un[cj] - kp_un[ci]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    ang_ab = torch.atan2(d[:, 1], d[:, 0])
    ang_ba = torch.atan2(-d[:, 1], -d[:, 0])
    return dist, ang_ab, ang_ba


def _grid_positions(ps, pe, seg, n_slots):
    """Fixed (C, n_slots) line-sample grid: sample i (1-based) is live iff
    i <= seg-1."""
    i_s = torch.arange(1, n_slots + 1, dtype=torch.float32,
                       device=ps.device)[None, :]
    segf = seg.clamp(min=1).to(torch.float32)[:, None]
    step = 1.0 / segf
    live = i_s <= (seg[:, None] - 1).to(torch.float32)
    posx = ps[:, 0:1] * (i_s * step) + pe[:, 0:1] * ((segf - i_s) * step)
    posy = ps[:, 1:2] * (i_s * step) + pe[:, 1:2] * ((segf - i_s) * step)
    return posx, posy, live


def _rate_grid(mask, h, w, ps, pe, seg, n_slots):
    """Inlier rate over a sample grid (nearest samples of the packed mask)."""
    c = ps.shape[0]
    posx, posy, live = _grid_positions(ps, pe, seg, n_slots)
    inl = nearest_binary_packed_ref(
        mask, _round_clip(posy.reshape(-1), h - 1),
        _round_clip(posx.reshape(-1), w - 1)).reshape(c, n_slots)
    cnt = (live & inl).to(torch.float32).sum(dim=1)
    return cnt / (seg - 1).clamp(min=1).to(torch.float32)


def _score_grid(heat, ps, pe, seg, n_slots):
    """Mean bilinear heat over a sample grid."""
    c = ps.shape[0]
    posx, posy, live = _grid_positions(ps, pe, seg, n_slots)
    bil = bilinear_f32(heat, posy.reshape(-1), posx.reshape(-1)).reshape(
        c, n_slots)
    ssum = torch.where(live, bil, bil.new_zeros(())).sum(dim=1)
    return ssum / (seg - 1).clamp(min=1).to(torch.float32)


def _inv_scale(h: int, w: int) -> float:
    return 1.0 / math.sqrt(float(h * h + w * w))


def _validate_from_mask(mask, heat, kp_un, ci, cj, dist, cand_valid):
    """Plain version of the line validation on the packed mask of
    heat > 0.2. Returns dict(good, lscore, overflow, rate, score, seg)."""
    h, w = heat.shape
    dev = heat.device
    lvl = (dist * _inv_scale(h, w) * 4.0).to(torch.int32).clamp(0, 3)
    # INV_SAMPLE_GAP[lvl] in f32, without a host->device copy (so that the
    # plain version can be captured in a CUDA graph and timed)
    gap = torch.where(lvl == 0, INV_SAMPLE_GAP[0], torch.where(
        lvl == 1, INV_SAMPLE_GAP[1], torch.where(
            lvl == 2, INV_SAMPLE_GAP[2], INV_SAMPLE_GAP[3])))
    seg = (dist * gap).to(torch.int32).clamp(0, MAX_SEG)
    seg = torch.where(cand_valid, seg, 0)

    ps = kp_un[ci]
    pe = kp_un[cj]
    is_long = seg > SHORT_S

    # ---- rate (nearest, full coverage) --------------------------------
    rate = _rate_grid(mask, h, w, ps, pe, torch.where(is_long, 0, seg),
                      SHORT_S)
    lsel, lvalid, n_long = _compact(is_long, LONG_CAP)
    rate_l = _rate_grid(mask, h, w, ps[lsel], pe[lsel],
                        torch.where(lvalid, seg[lsel], 0), MAX_SEG)
    rate = _update_compacted(rate, lsel, lvalid, rate_l)
    fits = ~is_long | (torch.cumsum(is_long.to(torch.int32), 0) <= LONG_CAP)

    # ---- score (bilinear, rate-gated + compacted) ---------------------
    need = cand_valid & fits & (seg >= 2) & (rate >= LINE_INLIER_RATE)
    score = torch.zeros(ci.shape[0], dtype=torch.float32, device=dev)

    need_s = need & ~is_long
    ssel, svalid, n_need_s = _compact(need_s, SCORE_S_CAP)
    sc = _score_grid(heat, ps[ssel], pe[ssel],
                     torch.where(svalid, seg[ssel], 0), SHORT_S)
    score = _update_compacted(score, ssel, svalid, sc)

    need_l = need & is_long
    lsel2, lvalid2, _ = _compact(need_l, LONG_CAP)
    sc = _score_grid(heat, ps[lsel2], pe[lsel2],
                     torch.where(lvalid2, seg[lsel2], 0), MAX_SEG)
    score = _update_compacted(score, lsel2, lvalid2, sc)
    overflow = (n_long > LONG_CAP) | (n_need_s > SCORE_S_CAP)
    fits_s = ~need_s | (torch.cumsum(need_s.to(torch.int32), 0) <= SCORE_S_CAP)

    # seg == 1: the reference's NaN rate passes; lscore = midpoint heat
    mid = 0.5 * (ps + pe)
    midv = bilinear_f32(heat, mid[:, 1], mid[:, 0])

    seg1 = seg == 1
    good = cand_valid & fits & fits_s & (
        seg1 | ((seg >= 2) & (rate >= LINE_INLIER_RATE)
                & (score >= LINE_HEATMAP_THRESH)))
    lscore = torch.where(seg1, midv, rate * score)
    lscore = torch.where(good, lscore, lscore.new_zeros(()))
    return dict(good=good, lscore=lscore, overflow=overflow, rate=rate,
                score=score, seg=seg)


def _line_validate_launch(mask, heat, kp_un, ci, cj, dist, cand_valid):
    """Launch kernels/line_validate.cu on the packed mask of heat > 0.2.
    Returns dict(good, lscore, overflow, rate, score), as
    _validate_from_mask, and index_error: a 0-d bool on the device, true
    where ci or cj holds an index outside [-K, K) (the plain version raises
    on one; the kernel reads keypoint 0 for it). It is not read here, so
    the launch does not wait for the card."""
    _require_cuda("line_validate", mask, heat, kp_un, ci, cj, dist,
                  cand_valid)
    _require(heat.dtype == torch.float32 and heat.dim() == 2,
             "line_validate: heat must be (H, W) float32")
    h, w = heat.shape
    _require(mask.dtype == torch.uint8 and mask.shape == (h, (w + 7) // 8),
             "line_validate: mask must be the (H, ceil(W/8)) uint8 packed "
             "mask")
    k = kp_un.shape[0]
    _require(kp_un.dtype == torch.float32 and kp_un.shape == (k, 2)
             and k >= 1, "line_validate: kp_un must be (K, 2) float32, K > 0")
    n = ci.shape[0]
    _require(ci.dtype == torch.int64 and cj.dtype == torch.int64
             and ci.shape == (n,) and cj.shape == (n,),
             "line_validate: ci and cj must be (C,) int64")
    _require(dist.dtype == torch.float32 and dist.shape == (n,),
             "line_validate: dist must be (C,) float32")
    _require(cand_valid.dtype == torch.bool and cand_valid.shape == (n,),
             "line_validate: cand_valid must be (C,) bool")
    _require(n <= CAND_CAP, f"line_validate takes at most {CAND_CAP} "
                            f"candidates, not {n}")
    dev = heat.device
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    rate, score, midv = torch.empty(3, n, dtype=torch.float32, device=dev)
    out = dict(good=torch.empty(n, dtype=torch.bool, device=dev),
               lscore=torch.empty(n, dtype=torch.float32, device=dev),
               overflow=torch.empty((), dtype=torch.bool, device=dev),
               rate=rate, score=score,
               index_error=torch.empty((), dtype=torch.bool, device=dev))
    kernels.check_device("line_validate", dev)
    code = kernels.launcher("line_validate")(
        mask.data_ptr(), heat.data_ptr(), kp_un.data_ptr(), ci.data_ptr(),
        cj.data_ptr(), dist.data_ptr(), cand_valid.data_ptr(), seg.data_ptr(),
        rate.data_ptr(), score.data_ptr(), midv.data_ptr(),
        out["good"].data_ptr(), out["lscore"].data_ptr(),
        out["overflow"].data_ptr(), out["index_error"].data_ptr(), n, k, h, w,
        _inv_scale(h, w), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch("line_validate", code)
    line_validate.launches += 1
    return out


def line_validate(heat, kp_un, ci, cj, dist, cand_valid):
    """The fused CUDA line validation (kernels/line_validate.cu):
    validate_candidates on CUDA tensors, returning dict(good, lscore,
    overflow, rate, score). Raises ValueError on other devices or inputs
    the kernel does not take (more than CAND_CAP candidates, wrong dtypes or
    shapes, non-contiguous tensors), and IndexError, as the plain version,
    where ci or cj does not index kp_un; that check waits for the kernel."""
    _require_cuda("line_validate", heat)
    mask = pack_binary_mask(heat > LINE_HEATMAP_THRESH)
    out = _line_validate_launch(mask, heat, kp_un, ci, cj, dist, cand_valid)
    if bool(out.pop("index_error")):
        raise IndexError(f"line_validate: ci or cj outside [-{kp_un.shape[0]}"
                         f", {kp_un.shape[0]})")
    return out


line_validate.launches = 0  # CUDA kernel launches, for chip_smoke.py


def validate_candidates(heat, kp_un, ci, cj, dist, cand_valid,
                        impl: str = "kernel"):
    """Sampled line validation, rate-gated (see module docstring).

    Returns (good, lscore, overflow): (CAND_CAP,) bool / f32 / 0-d bool
    (overflow = more long candidates than LONG_CAP or more rate-passing
    shorts than SCORE_S_CAP; the excess are dropped). impl="kernel"
    launches `line_validate` on CUDA tensors and runs the plain version on
    CPU tensors; impl="plain" runs the plain version. The kernel path does
    not wait for the card to check ci and cj: they must index kp_un, as
    probe_and_select's do."""
    _check_impl(impl)
    mask = pack_binary_mask(heat > LINE_HEATMAP_THRESH)
    if impl == "kernel" and heat.device.type != "cpu":
        out = _line_validate_launch(mask, heat, kp_un, ci, cj, dist,
                                    cand_valid)
    else:
        out = _validate_from_mask(mask, heat, kp_un, ci, cj, dist, cand_valid)
    return out["good"], out["lscore"], out["overflow"]
