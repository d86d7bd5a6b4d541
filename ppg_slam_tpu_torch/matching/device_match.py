"""Host service for device-side gated matching (ops/device_match.py).

Port of ppg_slam_tpu/matching/device_match.py. Owns the persistent device
descriptor bank (map-point descriptors, a (bank_cap, 256) f32 tensor,
uploaded incrementally at keyframe rate) and turns a frame's gate queries
into one gated match on the device, whose flat (row, kp, dist) result is
the only transfer back. The returned `GatedRows` is a drop-in for
matcher._RowCache: `row(mp)[kp]` is the L2 descriptor distance when
(mp, kp) is inside the map point's gate and among its K nearest, +inf
otherwise; the host matcher's sequential decisions are unchanged.

Gate membership is exact (the host computes the open-interval
|kp - center| < r boxes of Frame.features_in_area and uploads them); the
only approximation is the per-row top-K cut, counted in `overflow_rows`.
Queries are not padded to shape buckets (an XLA workaround in the
reference): a frame's rows are its live queries.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.device_match import (
    MATCH_K,
    PAIR_CAP,
    bank_update,
    gated_match_packed,
    unpack_match,
)


class _SparseRow:
    """Distance row over one frame's keypoints with +inf default."""

    __slots__ = ("d",)

    def __init__(self, d: Dict[int, float]):
        self.d = d

    def __getitem__(self, idx) -> float:
        return self.d.get(int(idx), np.inf)


_EMPTY = _SparseRow({})


class GatedRows:
    """matcher._RowCache-compatible view over one device match result."""

    def __init__(self, rows: Dict[int, _SparseRow], overflow_rows: int,
                 n_rows: int):
        self.rows = rows
        self.overflow_rows = overflow_rows  # rows with > K gated keypoints
        self.n_rows = n_rows

    def ensure(self, mps) -> None:  # the match already covered every row
        pass

    def row(self, mp) -> _SparseRow:
        return self.rows.get(mp.mnId, _EMPTY)


class DeviceMatcher:
    """Persistent device descriptor bank + per-frame gated match."""

    def __init__(self, bank_cap: int = 16384, k: int = MATCH_K,
                 device=None):
        """device: where the bank lives and the match runs; CUDA unless
        the caller names another (raises where no CUDA device is
        present)."""
        self.device = resolve_device(device)
        self.bank_cap = bank_cap
        self.k = k
        self.bank = torch.zeros((bank_cap, 256), dtype=torch.float32,
                                device=self.device)
        self._slot_of: Dict[int, int] = {}   # mp.mnId -> bank slot
        self._desc_ref: Dict[int, int] = {}  # mp.mnId -> id(descriptor array)
        self._mp_of: Dict[int, object] = {}  # mp.mnId -> MapPoint (for GC)
        self._free: List[int] = list(range(bank_cap - 1, -1, -1))
        self.n_dispatches = 0
        self.n_bank_uploads = 0
        self.n_pair_overflows = 0
        self.max_pairs = 0

    # -- bank maintenance (keyframe-rate) --------------------------------
    def release(self, mp_id: int) -> None:
        slot = self._slot_of.pop(mp_id, None)
        if slot is not None:
            self._desc_ref.pop(mp_id, None)
            self._mp_of.pop(mp_id, None)
            self._free.append(slot)

    def _reclaim_dead(self) -> None:
        """Free the slots of culled map points."""
        dead = [mid for mid, mp in self._mp_of.items() if mp.is_bad()]
        for mid in dead:
            self.release(mid)

    def ensure_bank(self, mps: Iterable) -> None:
        """Upload descriptors of map points that are new or whose
        distinctive descriptor changed (identity check: MapPoint replaces
        the array object on recompute)."""
        slots, descs = [], []
        for mp in mps:
            if mp is None:
                continue
            d = mp.descriptor
            if d is None:
                continue
            slot = self._slot_of.get(mp.mnId)
            if slot is not None and self._desc_ref[mp.mnId] == id(d):
                continue
            if slot is None:
                if not self._free:
                    self._reclaim_dead()
                if not self._free:
                    continue  # bank full: mp simply stays unmatched
                slot = self._free.pop()
                self._slot_of[mp.mnId] = slot
                self._mp_of[mp.mnId] = mp
            self._desc_ref[mp.mnId] = id(d)
            slots.append(slot)
            descs.append(d)
        if not slots:
            return
        bank_update(self.bank,
                    torch.from_numpy(np.asarray(slots, np.int64)).to(
                        self.device),
                    torch.from_numpy(np.stack(descs).astype(np.float32)).to(
                        self.device))
        self.n_bank_uploads += 1

    # -- per-frame match -------------------------------------------------
    def gated_rows(self, frame, queries: List[Tuple[object, float, float,
                                                    float]]) -> GatedRows:
        """One device match answering all of a frame's gate queries.

        queries: list of (map_point, center_x, center_y, radius). Map points
        without a bank slot get empty rows (no match, as an out-of-gate
        candidate)."""
        dd = frame.feats.desc_dev
        if dd is None:
            raise ValueError("frame was extracted without device descriptors")
        live = [(mp, cx, cy, r) for (mp, cx, cy, r) in queries
                if mp.mnId in self._slot_of]
        if not live:
            return GatedRows({}, 0, 0)
        m = len(live)
        bank_idx = np.asarray([self._slot_of[q[0].mnId] for q in live],
                              np.int64)
        c = np.asarray([(cx, cy, r) for _, cx, cy, r in live], np.float64)
        rects = np.stack([c[:, 0] - c[:, 2], c[:, 0] + c[:, 2],
                          c[:, 1] - c[:, 2], c[:, 1] + c[:, 2]],
                         1).astype(np.float32)
        n_cap = dd.shape[0]
        kp_pos = np.zeros((n_cap, 2), np.float32)
        kp_valid = np.zeros(n_cap, bool)
        n = frame.N
        kp_pos[:n] = frame.kp
        kp_valid[:n] = frame.grid.ok_mask
        dev = dd.device
        pair_cap = min(PAIR_CAP, m * self.k)
        buf = gated_match_packed(
            self.bank, torch.from_numpy(bank_idx).to(dev), dd,
            torch.from_numpy(kp_pos).to(dev),
            torch.from_numpy(kp_valid).to(dev),
            torch.from_numpy(rects).to(dev), k=self.k,
            pair_cap=pair_cap).cpu().numpy()
        p_rows, p_kps, p_ds, n_pairs, n_over = unpack_match(buf, pair_cap)
        self.n_dispatches += 1
        self.n_pair_overflows += int(n_pairs > len(p_rows))
        self.max_pairs = max(self.max_pairs, int(n_pairs))

        maps: List[Dict[int, float]] = [{} for _ in range(m)]
        for r, j, d in zip(p_rows, p_kps, p_ds):
            if 0 <= r < m:
                maps[r][int(j)] = float(d)
        rows = {mp.mnId: _SparseRow(maps[i])
                for i, (mp, _, _, _) in enumerate(live)}
        return GatedRows(rows, int(n_over), m)
