"""Data association — all search/fuse flavors of the reference Matcher.

Copy of ppg_slam_tpu/matching/matcher.py.

Host mirror of the reference's matching/Matcher.{h,cpp} (thresholds
TH_HIGH=0.8, TH_LOW=0.7 L2 descriptor distance, Matcher.cpp:12-13) operating
on worldmap Frame/KeyFrame objects. Projections of whole map-point sets are
vectorized in numpy; windowed candidate lookups go through the 64x48 grid;
ExtendMapMatches implements the paper's PPG seed-growing (Matcher.cpp:203-381)
with its greedy min-weight edge assignment.

Because the reference's FeatureVectors degenerate to the root node (levelsup=4
with L=3 — see bow.vocabulary), SearchByBoW / SearchForTriangulation iterate a
single node containing all keypoints; we implement that directly with full
descriptor-distance matrices (an MXU matmul shape by construction).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..geometry.cameras import CameraModel
from ..worldmap.elements import MapPoint
from ..worldmap.frame import Frame, KeyFrame
from ..worldmap.grid import image_bounds

TH_HIGH = 0.8
TH_LOW = 0.7


def _project_np(cam: CameraModel, Xc: np.ndarray) -> np.ndarray:
    return cam.project_np(Xc)


def desc_dist_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise L2 distances (host BLAS; device matmul for big shapes)."""
    d2 = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
          - 2.0 * (a @ b.T))
    return np.sqrt(np.maximum(d2, 0.0))


class _RowCache:
    """Batched map-point -> frame descriptor distances.

    The association searches used to compute one 256-d L2 norm per
    (candidate, feature) pair in Python (~ms per frame each); this computes
    whole (points x features) distance blocks with one BLAS/MXU matmul
    (desc_dist_matrix) and serves row lookups — SURVEY §7 phase 3's batched
    matching design.
    """

    def __init__(self, frame_desc: np.ndarray):
        self.fd = frame_desc
        self.rows = {}

    def ensure(self, mps) -> None:
        new = [mp for mp in mps
               if mp is not None and mp.mnId not in self.rows]
        if not new:
            return
        D = desc_dist_matrix(np.stack([m.descriptor for m in new]), self.fd)
        for m, row in zip(new, D):
            self.rows[m.mnId] = row

    def row(self, mp) -> np.ndarray:
        r = self.rows.get(mp.mnId)
        if r is None:
            self.ensure([mp])
            r = self.rows[mp.mnId]
        return r


class Matcher:
    def __init__(self, cam: CameraModel, nn_ratio: float = 0.6):
        self.cam = cam
        self.nn_ratio = nn_ratio

    # ------------------------------------------------------------------
    # frame <- last frame projection (Matcher.cpp:31-87)
    # ------------------------------------------------------------------
    def search_by_projection_last_frame(self, frame: Frame, last: Frame,
                                        th: float, dists=None) -> int:
        n = 0
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        mps = [mp for i, mp in enumerate(last.map_points)
               if mp is not None and not last.outlier[i]]
        if not mps or frame.N == 0:
            return 0
        # batch-project all last-frame points + one distance-matrix block
        # (or a device-side gated block: matching/device_match.py)
        X = np.stack([mp.pos for mp in mps])
        Xc = X @ frame.Rcw.T + frame.tcw
        uvs = self.cam.project_np(Xc)
        if dists is None:
            dists = _RowCache(frame.descriptors)
        dists.ensure(mps)
        for k, mp in enumerate(mps):
            if Xc[k, 2] <= 0:
                continue
            uv = uvs[k]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                continue
            cand = frame.features_in_area(uv[0], uv[1], th)
            if not cand:
                continue
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                cur = frame.map_points[idx]
                if cur is not None and cur.n_observations() > 0:
                    continue
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            if best <= TH_HIGH:
                frame.map_points[best_i] = mp
                n += 1
        return n

    # NOTE: the reference's frame <- map-point-set projection flavor
    # (Matcher.cpp:89-200) is dead code there too — its live tracking flow
    # uses ExtendMapMatches, and relocalization uses the KF-set flavor
    # (Tracking.cpp:811,1297). Deliberately not reimplemented.

    # ------------------------------------------------------------------
    # PPG image-map association: seed growing (Matcher.cpp:203-381)
    # ------------------------------------------------------------------
    def extend_map_matches(self, frame: Frame, points: List[MapPoint],
                           th: float, dists=None) -> int:
        n_matches = 0
        cands = [mp for mp in points if not mp.is_bad() and mp.track_in_view]
        cands.sort(key=lambda mp: -len(mp.get_edges()))
        if not cands or frame.N == 0:
            return 0
        if dists is None:
            dists = _RowCache(frame.descriptors)
        dists.ensure(cands)

        for mp in cands:
            if mp.tracked_by_frame == frame.mnId or mp.is_bad():
                continue
            r = th * (2.5 if mp.track_view_cos > 0.998 else 4.0)
            idxs = frame.features_in_area(mp.track_proj_x, mp.track_proj_y, r)
            if not idxs:
                continue
            row = dists.row(mp)
            best, best2, best_i = 1e6, 1e6, -1
            for idx in idxs:
                cur = frame.map_points[idx]
                if cur is not None and cur.n_observations() > 0:
                    continue
                d = row[idx]
                if d < best:
                    best2, best, best_i = best, d, idx
                elif d < best2:
                    best2 = d
            # reference quirk: rejects only if BOTH tests fail (:272-276)
            if best > TH_HIGH and best > self.nn_ratio * best2:
                continue
            frame.map_points[best_i] = mp
            mp.tracked_by_frame = frame.mnId
            n_matches += 1

            # Seed growing through MapEdge <-> KeyEdge pairs. The map side
            # is always the ANCHOR's edge star (the reference evaluates
            # pMP->getEdges() inside the seed loop, Matcher.cpp:295-303):
            # grown keypoints only pair the anchor's other endpoints with
            # their own key edges. A true multi-hop BFS (each seed growing
            # through its own edges) was tried and measured: on repetitive
            # structure it chains wrong associations — absolute-threshold
            # acceptance with no ratio test compounds hop by hop — until
            # pose optimization rejects the whole frame.
            map_edges = mp.get_edges()
            lx_all = [i for i, me in enumerate(map_edges)
                      if not me.is_bad() and me.valid
                      and me.the_other_pt(mp) is not None]
            others = [map_edges[i].the_other_pt(mp) for i in lx_all]
            if others:
                dists.ensure(others)
            seeds = deque([best_i])
            while seeds and lx_all:
                key_id = seeds.popleft()
                key_edges = frame.connected[key_id] if key_id < len(
                    frame.connected) else []
                if not key_edges:
                    continue
                lx = list(lx_all)
                ly = list(range(len(key_edges)))
                key_os = [self._other_pid(frame, key_edges[j], key_id)
                          for j in ly]
                weight = np.full((len(map_edges), len(key_edges)), 1e6,
                                 np.float32)
                for i, mp_o in zip(lx, (map_edges[i].the_other_pt(mp)
                                        for i in lx)):
                    orow = dists.row(mp_o)
                    for j, key_o in zip(ly, key_os):
                        if mp_o is frame.map_points[key_o]:
                            weight[i, j] = -1.0
                        else:
                            weight[i, j] = orow[key_o]
                # greedy min-weight assignment
                while lx and ly:
                    sub = weight[np.ix_(lx, ly)]
                    k = int(np.argmin(sub))
                    mi, mj = divmod(k, len(ly))
                    if sub[mi, mj] > TH_HIGH:
                        break
                    me = map_edges[lx[mi]]
                    key_edge_id = key_edges[ly[mj]]
                    del lx[mi]
                    del ly[mj]
                    mp_o = me.the_other_pt(mp)
                    key_o = self._other_pid(frame, key_edge_id, key_id)
                    if mp_o is None or mp_o.is_bad() or \
                            mp_o.tracked_by_frame == frame.mnId:
                        continue
                    frame.map_points[key_o] = mp_o
                    frame.map_edges[key_edge_id] = me
                    mp_o.tracked_by_frame = frame.mnId
                    # every grown association counts as a match (the
                    # reference counts each, Matcher.cpp:203-381; r1
                    # double-counted the seed instead)
                    n_matches += 1
                    seeds.append(key_o)
        return n_matches

    @staticmethod
    def _other_pid(frame, edge_id: int, pid: int) -> int:
        a, b = frame.key_edges[edge_id]
        return int(b) if int(a) == pid else int(a)

    # ------------------------------------------------------------------
    # BoW searches (degenerate feature vectors -> full matrices)
    # ------------------------------------------------------------------
    def search_by_bow_kf_frame(self, kf: KeyFrame, frame: Frame
                               ) -> Tuple[List[Optional[MapPoint]], int]:
        """(matches aligned to frame keypoints, count) — Matcher.cpp:393-477."""
        matches: List[Optional[MapPoint]] = [None] * frame.N
        rows = [i for i in range(kf.N)
                if kf.map_points[i] is not None
                and not kf.map_points[i].is_bad()]
        if not rows or frame.N == 0:
            return matches, 0
        D = desc_dist_matrix(kf.descriptors[rows], frame.descriptors)
        n = 0
        taken = np.zeros(frame.N, bool)
        for r, i in enumerate(rows):
            d = np.where(taken, 1e6, D[r])
            order = np.argsort(d)
            best_i = int(order[0])
            best = float(d[best_i])
            best2 = float(d[order[1]]) if frame.N > 1 else 1e6
            if best <= TH_LOW and best < self.nn_ratio * best2:
                matches[best_i] = kf.map_points[i]
                taken[best_i] = True
                n += 1
        return matches, n

    def search_by_bow_kf_kf(self, kf1: KeyFrame, kf2: KeyFrame
                            ) -> Tuple[List[Optional[MapPoint]], int]:
        """matches12[i] = kf2's map point for kf1 keypoint i (:663-765)."""
        matches: List[Optional[MapPoint]] = [None] * kf1.N
        rows = [i for i in range(kf1.N)
                if kf1.map_points[i] is not None
                and not kf1.map_points[i].is_bad()]
        cols = [j for j in range(kf2.N)
                if kf2.map_points[j] is not None
                and not kf2.map_points[j].is_bad()]
        if not rows or not cols:
            return matches, 0
        D = desc_dist_matrix(kf1.descriptors[rows], kf2.descriptors[cols])
        taken = np.zeros(len(cols), bool)
        n = 0
        for r, i in enumerate(rows):
            d = np.where(taken, 1e6, D[r])
            order = np.argsort(d)
            best_j = int(order[0])
            best = float(d[best_j])
            best2 = float(d[order[1]]) if len(cols) > 1 else 1e6
            if best <= TH_LOW and best < self.nn_ratio * best2:
                matches[i] = kf2.map_points[cols[best_j]]
                taken[best_j] = True
                n += 1
        return matches, n

    # ------------------------------------------------------------------
    # initialization window search (Matcher.cpp:582-660)
    # ------------------------------------------------------------------
    def search_for_initialization(self, f1: Frame, f2: Frame,
                                  prev_matched: np.ndarray,
                                  window: int = 100
                                  ) -> Tuple[np.ndarray, int]:
        matches12 = np.full(f1.N, -1, np.int32)
        matched_dist = np.full(f2.N, 1e6, np.float32)
        matches21 = np.full(f2.N, -1, np.int32)
        n = 0
        for i1 in range(f1.N):
            cand = f2.features_in_area(prev_matched[i1, 0],
                                       prev_matched[i1, 1], window)
            if not cand:
                continue
            d1 = f1.descriptors[i1]
            best, best2, best_i = 1e6, 1e6, -1
            for i2 in cand:
                d = float(np.linalg.norm(d1 - f2.descriptors[i2]))
                if matched_dist[i2] <= d:
                    continue
                if d < best:
                    best2, best, best_i = best, d, i2
                elif d < best2:
                    best2 = d
            if best <= TH_LOW and best < best2 * self.nn_ratio:
                if matches21[best_i] >= 0:
                    matches12[matches21[best_i]] = -1
                    n -= 1
                matches12[i1] = best_i
                matches21[best_i] = i1
                matched_dist[best_i] = best
                n += 1
        for i1 in range(f1.N):
            if matches12[i1] >= 0:
                prev_matched[i1] = f2.kp[matches12[i1]]
        return matches12, n

    # ------------------------------------------------------------------
    # epipolar-guided triangulation search (Matcher.cpp:767-895)
    # ------------------------------------------------------------------
    def search_for_triangulation(self, kf1: KeyFrame, kf2: KeyFrame
                                 ) -> List[Tuple[int, int]]:
        R1w, t1w = kf1.Rcw, kf1.tcw
        R2w, t2w = kf2.Rcw, kf2.tcw
        Cw = kf1.camera_center()
        C2 = R2w @ Cw + t2w
        ep = _project_np(self.cam, C2[None])[0]
        # T12 = T1w * Tw2
        R12 = R1w @ R2w.T
        t12 = t1w - R12 @ t2w

        rows = [i for i in range(kf1.N) if kf1.map_points[i] is None]
        cols = [j for j in range(kf2.N) if kf2.map_points[j] is None]
        if not rows or not cols:
            return []
        D = desc_dist_matrix(kf1.descriptors[rows], kf2.descriptors[cols])
        kp2 = kf2.kp[cols]
        ep_ok = np.linalg.norm(kp2 - ep[None], axis=1) >= 10.0
        # epipolar line check (Pinhole::epipolarConstrain, th 3.84)
        K = self.cam.K()
        Kinv = np.linalg.inv(K)
        tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]],
                       [-t12[1], t12[0], 0]], np.float32)
        F12 = Kinv.T @ tx @ R12 @ Kinv
        matched2 = np.zeros(len(cols), bool)
        out = []
        for r, i in enumerate(rows):
            kp1 = kf1.kp[i]
            l = F12.T @ np.array([kp1[0], kp1[1], 1.0], np.float32)
            num = kp2 @ l[:2] + l[2]
            den = l[0] ** 2 + l[1] ** 2
            epi_ok = (num * num / max(den, 1e-12)) < 3.84
            d = np.where(matched2 | ~ep_ok | ~epi_ok, 1e6, D[r])
            best_j = int(np.argmin(d))
            if d[best_j] <= TH_LOW:
                out.append((i, cols[best_j]))
                matched2[best_j] = True
        return out

    # ------------------------------------------------------------------
    # duplicate landmark fusion (Matcher.cpp:897-1035)
    # ------------------------------------------------------------------
    def fuse(self, kf: KeyFrame, points: List[MapPoint], th: float = 3.0
             ) -> int:
        n_fused = 0
        Ow = kf.camera_center()
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        live = [mp for mp in points
                if mp is not None and not mp.is_bad()
                and kf not in mp.observations]
        if not live or kf.N == 0:
            return 0
        # batch-project + one distance-matrix block over the fuse set
        X = np.stack([mp.pos for mp in live])
        Xcs = X @ kf.Rcw.T + kf.tcw
        uvs = self.cam.project_np(Xcs)
        dists = _RowCache(kf.descriptors)
        dists.ensure(live)
        for k, mp in enumerate(live):
            if Xcs[k, 2] < 0:
                continue
            uv = uvs[k]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                continue
            po = mp.pos - Ow
            dist = float(np.linalg.norm(po))
            if dist < mp.min_distance_invariance() or \
                    dist > mp.max_distance_invariance():
                continue
            if float(po @ mp.normal) < 0.5 * dist:
                continue
            cand = kf.features_in_area(uv[0], uv[1], th)
            if not cand:
                continue
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                e = kf.kp[idx] - uv
                if float(e @ e) > 5.99:
                    continue
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            if best <= TH_LOW and best_i >= 0:
                cur = kf.get_map_point(best_i)
                if cur is not None:
                    if not cur.is_bad():
                        if cur.n_observations() > mp.n_observations():
                            mp.replace(cur)
                        else:
                            cur.replace(mp)
                else:
                    mp.add_observation(kf, best_i)
                    kf.add_map_point(mp, best_i)
                n_fused += 1
        return n_fused

    def fuse_sim3(self, kf: KeyFrame, Scw_R, Scw_t, Scw_s,
                  points: List[MapPoint], th: float,
                  replace: List[Optional[MapPoint]]) -> int:
        """Fuse with a Sim3 pose (loop correction, Matcher.cpp:1038-...)."""
        Rcw = np.asarray(Scw_R, np.float32)
        tcw = (np.asarray(Scw_t, np.float32) / float(Scw_s))
        Ow = -Rcw.T @ tcw
        already: Set[MapPoint] = {mp for mp in kf.map_points
                                  if mp is not None}
        n_fused = 0
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        # one (points x kf-features) distance-matrix block (MXU-style
        # batched desc distances; SURVEY §7 phase 3) instead of per-pair
        # norms inside the candidate loop
        dists = _RowCache(kf.descriptors)
        dists.ensure([mp for mp in points
                      if mp is not None and not mp.is_bad()
                      and mp not in already])
        for i, mp in enumerate(points):
            if mp is None or mp.is_bad() or mp in already:
                continue
            Xc = Rcw @ mp.pos + tcw
            if Xc[2] < 0:
                continue
            uv = _project_np(self.cam, Xc[None])[0]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                continue
            po = mp.pos - Ow
            dist = float(np.linalg.norm(po))
            if dist < mp.min_distance_invariance() or \
                    dist > mp.max_distance_invariance():
                continue
            if float(po @ mp.normal) < 0.5 * dist:
                continue
            cand = kf.features_in_area(uv[0], uv[1], th)
            if not cand:
                continue
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            if best <= TH_LOW:
                cur = kf.get_map_point(best_i)
                if cur is not None:
                    if not cur.is_bad():
                        replace[i] = cur
                else:
                    mp.add_observation(kf, best_i)
                    kf.add_map_point(mp, best_i)
                n_fused += 1
        return n_fused

    # ------------------------------------------------------------------
    # Sim3 projection search into a KF (loop candidates, Matcher.cpp:479-580)
    # ------------------------------------------------------------------
    def search_by_projection_sim3(self, kf: KeyFrame, Scw_R, Scw_t, Scw_s,
                                  points: List[MapPoint],
                                  matched: List[Optional[MapPoint]],
                                  th: float) -> int:
        Rcw = np.asarray(Scw_R, np.float32)
        tcw = np.asarray(Scw_t, np.float32) / float(Scw_s)
        Ow = -Rcw.T @ tcw
        already = {mp for mp in matched if mp is not None}
        n = 0
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        dists = _RowCache(kf.descriptors)
        dists.ensure([mp for mp in points
                      if not mp.is_bad() and mp not in already])
        for mp in points:
            if mp.is_bad() or mp in already:
                continue
            Xc = Rcw @ mp.pos + tcw
            if Xc[2] < 0:
                continue
            uv = _project_np(self.cam, Xc[None])[0]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                continue
            po = mp.pos - Ow
            dist = float(np.linalg.norm(po))
            if dist < mp.min_distance_invariance() or \
                    dist > mp.max_distance_invariance():
                continue
            if float(po @ mp.normal) < 0.5 * dist:
                continue
            cand = kf.features_in_area(uv[0], uv[1], th)
            if not cand:
                continue
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                if matched[idx] is not None:
                    continue
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            if best <= TH_LOW:
                matched[best_i] = mp
                n += 1
        return n

    # ------------------------------------------------------------------
    # mutual Sim3 search between two KFs (Matcher.cpp:1149-...)
    # ------------------------------------------------------------------
    def search_by_sim3(self, kf1: KeyFrame, kf2: KeyFrame,
                       matches12: List[Optional[MapPoint]],
                       s12: float, R12: np.ndarray, t12: np.ndarray,
                       th: float) -> int:
        """Extend matches between kf1 and kf2 using the current Sim3."""
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        already1 = {mp for mp in matches12 if mp is not None}

        sR21 = (1.0 / s12) * R12.T
        t21 = -sR21 @ t12
        dists1 = _RowCache(kf1.descriptors)
        dists2 = _RowCache(kf2.descriptors)

        def project_into(kf, Rrel, trel, src_kf, mp, dists):
            Xc_src = src_kf.Rcw @ mp.pos + src_kf.tcw
            Xc = Rrel @ Xc_src + trel
            if Xc[2] < 0:
                return None
            uv = _project_np(self.cam, Xc[None])[0]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                return None
            cand = kf.features_in_area(uv[0], uv[1], th)
            if not cand:
                return None
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            return best_i if best <= TH_HIGH else None

        match1 = [-1] * kf1.N  # kf1 kp -> kf2 kp
        match2 = [-1] * kf2.N
        for i, mp in enumerate(kf1.map_points):
            if mp is None or mp.is_bad() or mp in already1:
                continue
            j = project_into(kf2, sR21, t21, kf1, mp, dists2)
            if j is not None:
                match1[i] = j
        for j in range(kf2.N):
            mp = kf2.map_points[j]
            if mp is None or mp.is_bad():
                continue
            i = project_into(kf1, s12 * R12, t12, kf2, mp, dists1)
            if i is not None:
                match2[j] = i
        n = 0
        for i in range(kf1.N):
            j = match1[i]
            if j >= 0 and match2[j] == i:  # mutual agreement
                matches12[i] = kf2.map_points[j]
                n += 1
        return n

    # ------------------------------------------------------------------
    # relocalization projection (Matcher.cpp:1337-...)
    # ------------------------------------------------------------------
    def search_by_projection_reloc(self, frame: Frame, kf: KeyFrame,
                                   found: Set[MapPoint], th: float,
                                   desc_th: float = TH_HIGH) -> int:
        n = 0
        min_x, max_x, min_y, max_y = image_bounds(self.cam)
        dists = _RowCache(frame.descriptors)
        dists.ensure([mp for mp in kf.map_points
                      if mp is not None and not mp.is_bad()
                      and mp not in found])
        for mp in kf.map_points:
            if mp is None or mp.is_bad() or mp in found:
                continue
            Xc = frame.Rcw @ mp.pos + frame.tcw
            if Xc[2] <= 0:
                continue
            uv = _project_np(self.cam, Xc[None])[0]
            if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
                continue
            cand = frame.features_in_area(uv[0], uv[1], th)
            if not cand:
                continue
            row = dists.row(mp)
            best, best_i = 1e6, -1
            for idx in cand:
                if frame.map_points[idx] is not None:
                    continue
                d = row[idx]
                if d < best:
                    best, best_i = d, idx
            if best <= desc_th:
                frame.map_points[best_i] = mp
                n += 1
        return n
