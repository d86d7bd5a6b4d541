"""Map elements: MapPoint, MapEdge, MapColine.

Copy of ppg_slam_tpu/worldmap/elements.py.

Host-side mirrors of the reference PPG-SLAM C++ sources
feature/{MapPoint,PPGGraph}.{h,cpp}.
The pointer-graph bookkeeping (observations, covisibility, lifecycle) lives
here in plain Python; all heavy math runs on device over SoA snapshots that
the estimator assemblers gather from these objects.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np


def descriptor_distance(a: np.ndarray, b: np.ndarray) -> float:
    """L2 distance of float descriptors (reference MapPoint.cpp:22-29)."""
    return float(np.linalg.norm(a - b))


_mp_ids = itertools.count()
_me_ids = itertools.count()
_mc_ids = itertools.count()


def reset_element_ids() -> None:
    """Reset MapPoint/MapEdge/MapColine id counters (reference system
    reset semantics, Tracking.cpp:1351-1384)."""
    global _mp_ids, _me_ids, _mc_ids
    _mp_ids = itertools.count()
    _me_ids = itertools.count()
    _mc_ids = itertools.count()


class MapPoint:
    """3-D landmark (reference feature/MapPoint.*)."""

    __slots__ = (
        "mnId", "first_kf_id", "pos", "normal", "min_depth", "max_depth",
        "descriptor", "observations", "n_visible", "n_found", "bad",
        "replaced", "edges", "colines",
        # per-frame tracking scratch (reference mbTrackInView etc.)
        "track_in_view", "track_proj_x", "track_proj_y", "track_depth",
        "track_view_cos", "tracked_by_frame", "last_frame_seen",
        # BA bookkeeping
        "ba_local_for_kf", "fuse_candidate_for_kf", "gba_pos", "ba_global_for_kf",
        "loop_point_for_kf", "corrected_by_kf", "corrected_reference",
    )

    def __init__(self, pos: np.ndarray, first_kf) -> None:
        self.mnId = next(_mp_ids)
        self.first_kf_id = first_kf.mnId if first_kf is not None else -1
        self.pos = np.asarray(pos, np.float32).copy()
        self.normal = np.zeros(3, np.float32)
        self.min_depth = 0.0
        self.max_depth = 0.0
        self.descriptor = np.zeros(256, np.float32)
        self.observations: Dict["KeyFrame", int] = {}
        self.n_visible = 1
        self.n_found = 1
        self.bad = False
        self.replaced: Optional["MapPoint"] = None
        self.edges: List["MapEdge"] = []
        self.colines: List["MapColine"] = []
        self.track_in_view = False
        self.track_proj_x = -1.0
        self.track_proj_y = -1.0
        self.track_depth = -1.0
        self.track_view_cos = 0.0
        self.tracked_by_frame = -1
        self.last_frame_seen = -1
        self.ba_local_for_kf = -1
        self.fuse_candidate_for_kf = -1
        self.ba_global_for_kf = -1
        self.loop_point_for_kf = -1
        self.corrected_by_kf = -1
        self.corrected_reference = -1
        self.gba_pos = None

    # -- observations ------------------------------------------------------
    def add_observation(self, kf, idx: int) -> None:
        self.observations[kf] = idx

    def erase_observation(self, kf) -> None:
        if kf in self.observations:
            idx = self.observations.pop(kf)
            kf.map_points[idx] = None
            if len(self.observations) <= 2:
                self.set_bad()

    def get_index_in_keyframe(self, kf) -> int:
        return self.observations.get(kf, -1)

    def n_observations(self) -> int:
        return len(self.observations)

    def is_bad(self) -> bool:
        return self.bad

    def set_bad(self) -> None:
        self.bad = True
        for kf, idx in list(self.observations.items()):
            if kf.map_points[idx] is self:
                kf.map_points[idx] = None
        self.observations.clear()
        for e in self.edges:
            e.bad = True

    def get_replaced(self) -> Optional["MapPoint"]:
        return self.replaced

    def replace(self, other: "MapPoint") -> None:
        """Reference MapPoint::Replace: move observations into `other`."""
        if other.mnId == self.mnId:
            return
        obs = dict(self.observations)
        self.observations.clear()
        self.bad = True
        self.replaced = other
        n_vis, n_found = self.n_visible, self.n_found
        for kf, idx in obs.items():
            if other.get_index_in_keyframe(kf) < 0:
                kf.map_points[idx] = other
                other.add_observation(kf, idx)
            else:
                kf.map_points[idx] = None
        other.n_visible += n_vis
        other.n_found += n_found
        other.compute_distinctive_descriptor()

    # -- statistics ----------------------------------------------------------
    def increase_visible(self, n: int = 1) -> None:
        self.n_visible += n

    def increase_found(self, n: int = 1) -> None:
        self.n_found += n

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)

    # -- descriptor / geometry refresh ---------------------------------------
    def compute_distinctive_descriptor(self) -> None:
        """Median-distance descriptor selection (MapPoint.cpp:234-302)."""
        if self.bad or not self.observations:
            return
        descs = []
        for kf, idx in self.observations.items():
            if not kf.is_bad() and idx >= 0:
                descs.append(kf.descriptors[idx])
        if not descs:
            return
        D = np.stack(descs)
        d2 = np.linalg.norm(D[:, None, :] - D[None, :, :], axis=-1)
        medians = np.sort(d2, axis=1)[:, (len(descs) - 1) // 2]
        self.descriptor = D[int(np.argmin(medians))].copy()

    def update_normal_and_depth(self) -> None:
        """Mean viewing direction + min/max depth (MapPoint.cpp:338-376).

        Vectorized over observations: this runs for every window MP after
        every BA write-back (hundreds of calls per frame on the live path),
        so one stacked norm beats a per-KF Python loop ~5x."""
        if self.bad or not self.observations:
            return
        centers = np.stack([kf.camera_center() for kf in self.observations])
        po = self.pos - centers
        d = np.sqrt(np.einsum("ni,ni->n", po, po))
        ok = d > 1e-12
        if not ok.any():
            return
        dv = d[ok]
        self.min_depth = float(dv.min())
        self.max_depth = float(dv.max())
        self.normal = (po[ok] / dv[:, None]).mean(0).astype(np.float32)

    # depth-invariance bounds (MapPoint.cpp:378-389: 0.5x min / 2.0x max —
    # PPG has no image pyramid but the reference still allows a wide band;
    # tighter bounds progressively frustum-reject close points as the
    # camera translates, bleeding tracked inliers between keyframes)
    def min_distance_invariance(self) -> float:
        return 0.5 * self.min_depth

    def max_distance_invariance(self) -> float:
        return 2.0 * self.max_depth

    # -- PPG graph -----------------------------------------------------------
    def add_edge(self, edge: "MapEdge") -> None:
        if edge not in self.edges:
            self.edges.append(edge)

    def get_edge(self, other: "MapPoint") -> Optional["MapEdge"]:
        for e in self.edges:
            if e.the_other_pt(self) is other:
                return e
        return None

    def get_edges(self) -> List["MapEdge"]:
        return [e for e in self.edges if not e.is_bad()]

    def get_colines(self) -> List["MapColine"]:
        return [c for c in self.colines if not c.is_bad()]

    def add_coline(self, mp_s: "MapPoint", mp_e: "MapPoint", kf,
                   weight: float = -1.0) -> Optional["MapColine"]:
        """Reference MapPoint::addColine (:459-519): degeneracy gates +
        weight = harmonic mean of the two 2-D segment lengths."""
        if mp_s.replaced is not None:
            mp_s = mp_s.replaced
        if mp_e.replaced is not None:
            mp_e = mp_e.replaced
        idx_m = self.get_index_in_keyframe(kf)
        idx_s = mp_s.get_index_in_keyframe(kf)
        idx_e = mp_e.get_index_in_keyframe(kf)
        if idx_m < 0 or idx_s < 0 or idx_e < 0:
            return None
        v1 = mp_s.pos - self.pos
        v2 = self.pos - mp_e.pos
        n_ = kf.camera_center() - self.pos
        d1 = np.linalg.norm(v1)
        d2 = np.linalg.norm(v2)
        dn = np.linalg.norm(n_)
        if d1 < 1e-9 or d2 < 1e-9 or dn < 1e-9:
            return None
        ratio = d1 / d2
        vd1 = abs(float(n_ @ v1) / (dn * d1))
        vd2 = abs(float(n_ @ v2) / (dn * d2))
        if ratio < 0.2 or ratio > 5 or vd1 > 0.996 or vd2 > 0.996:
            return None
        if weight < 0:
            ps = kf.kp_un[idx_s]
            pm = kf.kp_un[idx_m]
            pe = kf.kp_un[idx_e]
            l1 = float(np.linalg.norm(ps - pm))
            l2 = float(np.linalg.norm(pm - pe))
            if l1 + l2 < 1e-9:
                return None
            weight = 2 * l1 * l2 / (l1 + l2)
        for mc in self.colines:
            if ((mc.mp_s is mp_s and mc.mp_e is mp_e)
                    or (mc.mp_s is mp_e and mc.mp_e is mp_s)):
                mc.add_observation(kf, weight)
                return None
        mc = MapColine(mp_s, self, mp_e)
        mc.add_observation(kf, weight)
        self.colines.append(mc)
        return mc

    def remove_coline_outliers(self) -> List["MapColine"]:
        """Kill colines whose direction agreement dropped below 0.90
        (MapPoint.cpp:429-457)."""
        removed = []
        kept = []
        for mc in self.get_colines():
            v1 = mc.mp_s.pos - self.pos
            v2 = self.pos - mc.mp_e.pos
            n1 = np.linalg.norm(v1)
            n2 = np.linalg.norm(v2)
            if n1 < 1e-12 or n2 < 1e-12:
                kept.append(mc)
                continue
            if float(v1 @ v2) / (n1 * n2) < 0.90:
                mc.bad = True
                removed.append(mc)
            else:
                kept.append(mc)
        self.colines = kept
        return removed


class MapEdge:
    """3-D segment between two MapPoints (reference PPGGraph.h:61-110)."""

    view_cos_th = 0.85  # config ViewCosTh (set by System at load)

    __slots__ = ("mnId", "mp_s", "mp_e", "observations", "bad", "valid",
                 "ba_local_for_kf", "tracked_frame_id")

    def __init__(self, mp_s: MapPoint, mp_e: MapPoint) -> None:
        self.mnId = next(_me_ids)
        self.mp_s = mp_s
        self.mp_e = mp_e
        self.observations: Dict[object, int] = {}
        self.bad = False
        self.valid = True
        self.ba_local_for_kf = -1
        self.tracked_frame_id = -1
        mp_s.add_edge(self)
        mp_e.add_edge(self)

    def the_other_pt(self, mp: MapPoint) -> Optional[MapPoint]:
        if self.mp_s is mp:
            return self.mp_e
        if self.mp_e is mp:
            return self.mp_s
        return None

    def add_observation(self, kf, key_edge_id: int) -> None:
        self.observations[kf] = key_edge_id

    def check_valid(self) -> None:
        """Viewing-angle validity (PPGGraph.cpp:68-88)."""
        if len(self.observations) < 2:
            self.valid = False
            return
        n1 = self.mp_s.normal
        n2 = self.mp_e.normal
        nn1 = np.linalg.norm(n1)
        nn2 = np.linalg.norm(n2)
        v = self.mp_s.pos - self.mp_e.pos
        nv = np.linalg.norm(v)
        if nn1 < 1e-12 or nn2 < 1e-12 or nv < 1e-12:
            self.valid = False
            return
        v = v / nv
        c1 = abs(float(v @ (n1 / nn1)))
        c2 = abs(float(v @ (n2 / nn2)))
        self.valid = not (c1 > MapEdge.view_cos_th or c2 > MapEdge.view_cos_th)

    def is_bad(self) -> bool:
        return self.bad or self.mp_s.is_bad() or self.mp_e.is_bad()


class MapColine:
    """3-point collinearity constraint (reference PPGGraph.h:116-155)."""

    __slots__ = ("mnId", "mp_s", "mp_m", "mp_e", "observations", "bad",
                 "valid", "first_kf")

    def __init__(self, mp_s: MapPoint, mp_m: MapPoint, mp_e: MapPoint) -> None:
        self.mnId = next(_mc_ids)
        self.mp_s = mp_s
        self.mp_m = mp_m
        self.mp_e = mp_e
        self.observations: Dict[object, float] = {}
        self.bad = False
        self.valid = False
        self.first_kf = None

    def add_observation(self, kf, weight: float) -> None:
        """PPGGraph.cpp:104-130: valid once seen from 2 different views."""
        if kf in self.observations:
            return
        if not self.observations:
            self.first_kf = kf
        self.observations[kf] = weight
        if len(self.observations) < 2 or self.valid:
            return
        pts = self.mp_s.pos
        pte = self.mp_e.pos
        o1 = self.first_kf.camera_center()
        o2 = kf.camera_center()
        n1 = np.cross(pts - pte, o1)
        n2 = np.cross(pts - pte, o2)
        nn1 = np.linalg.norm(n1)
        nn2 = np.linalg.norm(n2)
        if nn1 < 1e-12 or nn2 < 1e-12:
            return
        if abs(float((n1 / nn1) @ (n2 / nn2))) < 1.0:
            self.valid = True

    def ave_weight(self) -> float:
        """Sum of observation weights — the reference 'aveWeight' actually
        SUMS (PPGGraph.cpp:132-139); the BA information uses it as-is."""
        return float(sum(self.observations.values()))

    def is_bad(self) -> bool:
        if self.mp_s.replaced is not None:
            self.mp_s = self.mp_s.replaced
        if self.mp_e.replaced is not None:
            self.mp_e = self.mp_e.replaced
        return (self.bad or self.mp_s.is_bad() or self.mp_m.is_bad()
                or self.mp_e.is_bad())
