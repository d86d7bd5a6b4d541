"""The global Map: element stores, incremental growth, place-recognition DB.

Copy of ppg_slam_tpu/worldmap/map.py.

Host mirror of the reference PPG-SLAM C++ sources map/Map.* — element
CRUD, the IncreMap keyframe-growth pipeline (observation refresh, recent-point culling,
triangulation against the temporal chain, MapEdge/MapColine creation,
Map.cpp:470-709), the BoW inverted file (Map.h:187, Map.cpp:34-102, 262-466),
the map-change counter, and ApplyScaledRotation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from .elements import MapColine, MapEdge, MapPoint
from .frame import KeyFrame, Rig


class Map:
    imu_ini_time = 8.0  # config IMU.IniTime (set by System)

    def __init__(self, rig: Rig, vocabulary=None):
        import threading

        self.rig = rig
        self.vocabulary = vocabulary
        # the big map-update lock (reference mMutexMapUpdate, Map.h:145) —
        # held by background GBA's host gather/propagate phases; the
        # synchronous pipeline never contends on it
        self.update_lock = threading.RLock()
        # element stores are insertion-ordered dicts, NOT sets: set
        # iteration order is id()-hash order, which varies per process
        # (ASLR) — it leaked into GBA/FIBA residual assembly order and
        # candidate orderings, making two identical runs diverge through
        # float-accumulation order and greedy tie-breaks. Dicts give the
        # same O(1) add/discard with deterministic (insertion) iteration.
        self.keyframes: Dict[KeyFrame, None] = {}
        self.map_points: Dict[MapPoint, None] = {}
        self.map_edges: Dict[MapEdge, None] = {}
        self.map_colines: Dict[MapColine, None] = {}
        self.recent_map_points: List[MapPoint] = []
        self.inverted_file: Dict[int, List[KeyFrame]] = {}
        self.kf_origin: Optional[KeyFrame] = None
        self.max_kf_id = 0
        self.change_idx = 0
        self.last_change_idx = 0
        # global-transform epoch: bumped whenever the WHOLE map is remapped
        # (IMU-init gravity/scale ApplyScaledRotation, loop correction, GBA
        # propagation). A threaded local-mapping BA captures the epoch at
        # gather time and drops its write-back if it changed mid-solve — the
        # effect of the reference's RequestStop/mbAbortBA protocol
        # (Tracking.cpp:1509, LocalMapping.cpp:368-431) without blocking.
        self.transform_epoch = 0

        self.imu_initialized = False
        self.inertial_ba1 = False
        self.inertial_ba2 = False

    # locks are not picklable (worldmap/serialize.py pickles the map graph)
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("update_lock", None)
        return state

    def __setstate__(self, state):
        import threading

        self.__dict__.update(state)
        self.update_lock = threading.RLock()
        self.__dict__.setdefault("transform_epoch", 0)  # pre-epoch pickles
        for name in ("keyframes", "map_points", "map_edges", "map_colines"):
            if isinstance(self.__dict__.get(name), set):  # pre-dict pickles
                self.__dict__[name] = dict.fromkeys(
                    sorted(self.__dict__[name], key=lambda e: e.mnId))

    # -- element CRUD (Map.cpp:34-180) ---------------------------------------
    def add_keyframe(self, kf: KeyFrame) -> None:
        """Insert KF + index its BoW vector into the inverted file."""
        self.keyframes[kf] = None
        self.max_kf_id = max(self.max_kf_id, kf.mnId)
        if self.kf_origin is None:
            self.kf_origin = kf
        if kf.bow_vec:
            for word in kf.bow_vec:
                self.inverted_file.setdefault(word, []).append(kf)

    def erase_keyframe(self, kf: KeyFrame) -> None:
        self.keyframes.pop(kf, None)
        if kf.bow_vec:
            for word in kf.bow_vec:
                lst = self.inverted_file.get(word)
                if lst and kf in lst:
                    lst.remove(kf)

    def add_map_point(self, mp: MapPoint) -> None:
        self.map_points[mp] = None

    def erase_map_point(self, mp: MapPoint) -> None:
        self.map_points.pop(mp, None)

    def add_map_edge(self, me: MapEdge) -> None:
        self.map_edges[me] = None

    def add_map_coline(self, mc: MapColine) -> None:
        self.map_colines[mc] = None

    def all_keyframes(self) -> List[KeyFrame]:
        return [kf for kf in self.keyframes if not kf.is_bad()]

    def all_map_points(self) -> List[MapPoint]:
        return [mp for mp in self.map_points if not mp.is_bad()]

    def n_map_points(self) -> int:
        return sum(1 for mp in self.map_points if not mp.is_bad())

    def n_keyframes(self) -> int:
        return sum(1 for kf in self.keyframes if not kf.is_bad())

    # -- change counter (Map.cpp:181-196) --------------------------------------
    def info_map_change(self) -> None:
        self.change_idx += 1

    def check_map_changed(self) -> bool:
        if self.change_idx > self.last_change_idx:
            self.last_change_idx = self.change_idx
            return True
        return False

    def bump_transform_epoch(self) -> None:
        """Mark a whole-map transform (see transform_epoch above)."""
        self.transform_epoch += 1

    # -- incremental growth (Map.cpp:470-709) -----------------------------------
    def incre_map(self, new_kf: KeyFrame, matcher) -> None:
        for i, mp in enumerate(new_kf.get_map_point_matches()):
            if mp is not None and not mp.is_bad():
                mp.add_observation(new_kf, i)
                mp.update_normal_and_depth()
                mp.compute_distinctive_descriptor()

        # recent-point culling
        cur_id = new_kf.mnId
        kept = []
        for mp in self.recent_map_points:
            if mp.is_bad():
                continue
            if mp.found_ratio() < 0.25:
                mp.set_bad()
                self.erase_map_point(mp)
            elif cur_id - mp.first_kf_id >= 2 and mp.n_observations() <= 2:
                mp.set_bad()
                self.erase_map_point(mp)
            elif cur_id - mp.first_kf_id >= 3:
                continue  # matured: drop from the watch list
            else:
                kept.append(mp)
        self.recent_map_points = kept

        # temporal neighbors (<= 5 previous KFs)
        neighbors = []
        kf = new_kf
        count = 0
        while len(neighbors) <= 5 and kf.prev_kf is not None and count < 5:
            count += 1
            if kf.prev_kf not in neighbors:
                neighbors.append(kf.prev_kf)
            kf = kf.prev_kf

        self.triangulate_new_map_points(new_kf, neighbors, matcher)
        self.create_map_edges(new_kf)
        self.create_map_colines(new_kf)
        new_kf.update_connections()
        self.add_keyframe(new_kf)

    def triangulate_new_map_points(self, new_kf: KeyFrame,
                                   neighbors: List[KeyFrame],
                                   matcher) -> None:
        cam = self.rig.cam
        R1, t1 = new_kf.Rcw, new_kf.tcw
        P1 = np.concatenate([R1, t1[:, None]], 1)
        for kf2 in neighbors:
            matches = matcher.search_for_triangulation(new_kf, kf2)
            if not matches:
                continue
            R2, t2 = kf2.Rcw, kf2.tcw
            P2 = np.concatenate([R2, t2[:, None]], 1)
            idx1 = np.array([m[0] for m in matches])
            idx2 = np.array([m[1] for m in matches])
            xn1 = cam.unproject_np(new_kf.kp[idx1])
            xn2 = cam.unproject_np(kf2.kp[idx2])
            # batched 4x4 DLT
            A = np.stack([
                xn1[:, 0, None] * P1[2] - P1[0],
                xn1[:, 1, None] * P1[2] - P1[1],
                xn2[:, 0, None] * P2[2] - P2[0],
                xn2[:, 1, None] * P2[2] - P2[1],
            ], axis=1)
            _, _, vt = np.linalg.svd(A)
            X4 = vt[:, -1, :]
            w = X4[:, 3]
            ok = np.abs(w) > 1e-12
            X = X4[:, :3] / np.where(ok, w, 1.0)[:, None]

            uv1 = cam.project_np(X @ R1.T + t1)
            uv2 = cam.project_np(X @ R2.T + t2)
            z1 = X @ R1[2] + t1[2]
            z2 = X @ R2[2] + t2[2]
            err1 = np.sum((uv1 - new_kf.kp[idx1]) ** 2, 1)
            err2 = np.sum((uv2 - kf2.kp[idx2]) ** 2, 1)
            good = ok & (z1 > 0) & (z2 > 0) & (err1 <= 5.991) & (err2 <= 5.991)

            for k in np.nonzero(good)[0]:
                i1, i2 = int(idx1[k]), int(idx2[k])
                if new_kf.map_points[i1] is not None or \
                        kf2.map_points[i2] is not None:
                    continue
                mp = MapPoint(X[k], new_kf)
                mp.add_observation(new_kf, i1)
                mp.add_observation(kf2, i2)
                new_kf.add_map_point(mp, i1)
                kf2.add_map_point(mp, i2)
                mp.compute_distinctive_descriptor()
                mp.update_normal_and_depth()
                self.add_map_point(mp)
                self.recent_map_points.append(mp)

    def create_map_edges(self, new_kf: KeyFrame) -> None:
        """Map.cpp:645-685."""
        oc = new_kf.camera_center()
        for lid, (a, b) in enumerate(new_kf.key_edges):
            me = new_kf.get_map_edge(lid)
            if me is not None and not me.is_bad():
                continue
            mp1 = new_kf.get_map_point(int(a))
            mp2 = new_kf.get_map_point(int(b))
            if mp1 is None or mp2 is None or mp1.is_bad() or mp2.is_bad():
                continue
            v = mp1.pos - mp2.pos
            nv = np.linalg.norm(v)
            v1 = oc - mp1.pos
            v2 = oc - mp2.pos
            n1 = np.linalg.norm(v1)
            n2 = np.linalg.norm(v2)
            if nv < 1e-9 or n1 < 1e-9 or n2 < 1e-9:
                continue
            v = v / nv
            if abs(float(v @ v1) / n1) > MapEdge.view_cos_th or \
                    abs(float(v @ v2) / n2) > MapEdge.view_cos_th:
                continue
            me = mp1.get_edge(mp2)
            if me is not None and not me.is_bad():
                new_kf.add_map_edge(me, lid)
                me.add_observation(new_kf, lid)
                me.check_valid()
            else:
                me = MapEdge(mp1, mp2)
                new_kf.add_map_edge(me, lid)
                me.add_observation(new_kf, lid)
                self.add_map_edge(me)

    def create_map_colines(self, new_kf: KeyFrame) -> None:
        """Map.cpp:687-709."""
        for pid in range(new_kf.N):
            mp = new_kf.get_map_point(pid)
            if mp is None or mp.is_bad():
                continue
            for (piv, p1, p2) in new_kf.colines:
                if int(piv) != pid:
                    continue
                mp1 = new_kf.get_map_point(int(p1))
                mp2 = new_kf.get_map_point(int(p2))
                if mp1 is None or mp2 is None or mp1.is_bad() or mp2.is_bad():
                    continue
                mc = mp.add_coline(mp1, mp2, new_kf)
                if mc is not None:
                    self.add_map_coline(mc)

    # -- global rescale after IMU init (Map.cpp:212-243) -----------------------
    def apply_scaled_rotation(self, Rgw: np.ndarray, scale: float,
                              scale_vel: bool = False) -> None:
        """Rotate the world into the gravity frame and rescale: poses,
        velocities, points."""
        self.bump_transform_epoch()
        Rgw = np.asarray(Rgw, np.float32)
        for kf in self.keyframes:
            # Tcw' = (Tgw * Twc_scaled)^-1 = (Rcw Rgw^T, s*tcw) for t_gw = 0
            Rcw = kf.Rcw @ Rgw.T
            tcw = kf.tcw * scale
            kf.set_pose(Rcw, tcw)
            v = Rgw @ kf.velocity
            kf.velocity = (v * scale if scale_vel else v).astype(np.float32)
        for mp in self.map_points:
            mp.pos = (scale * (Rgw @ mp.pos)).astype(np.float32)
            mp.update_normal_and_depth()
        self.info_map_change()

    # -- place recognition (Map.cpp:262-466) ------------------------------------
    def detect_n_best_candidates(self, kf: KeyFrame, n: int) -> List[KeyFrame]:
        """Loop-closure candidates via shared-word counting + covisibility-
        accumulated scores (DetectNBestCandidates, Map.cpp:262-364)."""
        if not kf.bow_vec or self.vocabulary is None:
            return []
        connected = set(kf.get_connected_keyframes())
        words_kf: Dict[KeyFrame, int] = {}
        for word in kf.bow_vec:
            for kfi in self.inverted_file.get(word, []):
                if kfi.place_recognition_query != kf.mnId:
                    kfi.place_recognition_words = 0
                    kfi.place_recognition_query = kf.mnId
                kfi.place_recognition_words += 1
        candidates = [k for k in self.keyframes
                      if k.place_recognition_query == kf.mnId
                      and k not in connected and k is not kf]
        if not candidates:
            return []
        max_common = max(k.place_recognition_words for k in candidates)
        min_common = 0.8 * max_common
        scored = []
        for k in candidates:
            if k.place_recognition_words <= min_common:
                continue
            s = self.vocabulary.score(kf.bow_vec, k.bow_vec)
            k.place_recognition_score = s
            scored.append((s, k))

        # accumulate over covisibility groups, keep best of each
        best: List[tuple] = []
        for s, k in scored:
            acc = s
            best_kf, best_s = k, s
            for k2 in k.get_best_covisibility_keyframes(10):
                if k2.place_recognition_query != kf.mnId:
                    continue
                acc += k2.place_recognition_score
                if k2.place_recognition_score > best_s:
                    best_kf, best_s = k2, k2.place_recognition_score
            best.append((acc, best_kf))
        best.sort(key=lambda p: -p[0])
        out: List[KeyFrame] = []
        for _, k in best:
            if k not in out:
                out.append(k)
            if len(out) >= n:
                break
        return out

    def detect_relocalization_candidates(self, frame) -> List[KeyFrame]:
        """DetectRelocalizationCandidates (Map.cpp:367-466)."""
        if not getattr(frame, "bow_vec", None) or self.vocabulary is None:
            return []
        for word in frame.bow_vec:
            for kfi in self.inverted_file.get(word, []):
                if kfi.reloc_query != frame.mnId:
                    kfi.reloc_words = 0
                    kfi.reloc_query = frame.mnId
                kfi.reloc_words += 1
        candidates = [k for k in self.keyframes if k.reloc_query == frame.mnId]
        if not candidates:
            return []
        max_common = max(k.reloc_words for k in candidates)
        min_common = 0.8 * max_common
        scored = []
        for k in candidates:
            if k.reloc_words <= min_common:
                continue
            s = self.vocabulary.score(frame.bow_vec, k.bow_vec)
            k.reloc_score = s
            scored.append((s, k))
        if not scored:
            return []
        # covisibility accumulation
        groups = []
        for s, k in scored:
            acc = s
            best_kf, best_s = k, s
            for k2 in k.get_best_covisibility_keyframes(10):
                if k2.reloc_query != frame.mnId:
                    continue
                acc += k2.reloc_score
                if k2.reloc_score > best_s:
                    best_kf, best_s = k2, k2.reloc_score
            groups.append((acc, best_kf))
        best_acc = max(g[0] for g in groups)
        th = 0.75 * best_acc
        out = []
        for acc, k in groups:
            if acc > th and k not in out:
                out.append(k)
        return out
