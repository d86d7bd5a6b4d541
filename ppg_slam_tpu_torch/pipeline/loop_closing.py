"""Loop closing — the reference MSLoopClosing (system/src/LoopClosing.cpp).

Port of ppg_slam_tpu/pipeline/loop_closing.py. The host bookkeeping is the
reference package's; the Sim3 RANSAC scores its hypotheses, and
OptimizeSim3, the essential graphs and the global BA after a loop solve, on
the closer's `device` (CUDA unless the caller names another), at the exact
match, node and edge counts (the reference package pads them to pow2
buckets).

Protocol (SURVEY.md §3.3): place recognition requires InertialBA done and
>= 12 KFs; candidates via the BoW inverted file; per-candidate chain
BoW match >= 20 -> Sim3 RANSAC -> projection >= 50 -> OptimizeSim3 >= 20 ->
reprojection >= 80 -> >= 3 covisible spatial confirmations; 3 consecutive
keyframe coincidences confirm the loop; a roll/pitch < 0.008 rad, yaw < 0.349
rad gate validates it (yaw-only correction when inertial). CorrectLoop
propagates the Sim3 to covisibles (poses, points, velocities), fuses
duplicates, runs the 4-DoF/7-DoF essential graph and the global BA with
result propagation (synchronously, or on a background thread with
`threaded_gba`, as the C++ reference runs it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..estimator.ba import (_fetch, _upload, full_inertial_ba,
                            global_bundle_adjustment)
from ..estimator.pose_graph import (
    Graph4DoF,
    Sim3Graph,
    optimize_essential_graph,
    optimize_essential_graph_4dof,
    optimize_sim3,
)
from ..geometry import so3
from ..matching import Matcher, Sim3Solver
from ..worldmap import KeyFrame, Map, MapPoint


class Sim3T:
    """Plain (R, t, s) Sim3 with compose/inverse/map (host numpy)."""

    __slots__ = ("R", "t", "s")

    def __init__(self, R, t, s=1.0):
        self.R = np.asarray(R, np.float32)
        self.t = np.asarray(t, np.float32)
        self.s = float(s)

    @staticmethod
    def from_pose(Rcw, tcw):
        return Sim3T(Rcw, tcw, 1.0)

    def compose(self, o: "Sim3T") -> "Sim3T":
        return Sim3T(self.R @ o.R, self.s * (self.R @ o.t) + self.t,
                     self.s * o.s)

    def inverse(self) -> "Sim3T":
        Rt = self.R.T
        si = 1.0 / self.s
        return Sim3T(Rt, -si * (Rt @ self.t), si)

    def map(self, X: np.ndarray) -> np.ndarray:
        return self.s * (X @ self.R.T) + self.t

    def to_se3(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.R.copy(), (self.t / self.s).astype(np.float32)


class LoopClosing:
    def __init__(self, wmap: Map, local_mapper=None, active: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.map = wmap
        self.local_mapper = local_mapper
        self.active = active
        self.debug = False  # gate-level detection logging
        self.queue: List[KeyFrame] = []
        # continuation state (LoopClosing.h)
        self.num_coincidences = 0
        self.num_not_found = 0
        self.loop_detected = False
        self.last_current_kf: Optional[KeyFrame] = None
        self.matched_kf: Optional[KeyFrame] = None
        self.Slw: Optional[Sim3T] = None
        self.loop_mps: List[MapPoint] = []
        self.loop_matched_mps: List[Optional[MapPoint]] = []
        self.current_kf: Optional[KeyFrame] = None
        self.n_loops_closed = 0

        # background-GBA protocol (reference LoopClosing.cpp:1050,
        # mbRunningGBA/mbStopGBA + RunGlobalBundleAdjustment thread).
        # threaded_gba=False keeps the deterministic synchronous path.
        self.threaded_gba = False
        self.gba_running = False
        self.stop_gba = False
        self._gba_thread = None
        self._gba_loop_kf = 0
        self.gba_error: Optional[BaseException] = None  # a failed GBA thread

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: KeyFrame) -> None:
        if self.threaded_gba:
            self.poll_gba()  # apply a finished background GBA (safe point)
        if kf.mnId != 0:
            self.queue.append(kf)
        else:
            self.map.add_keyframe(kf)
        self.process_all()

    def process_all(self) -> None:
        while self.queue:
            found = self.new_detect_common_regions()
            if found and self.loop_detected:
                self._validate_and_correct()

    def reset(self) -> None:
        self.queue.clear()
        self.num_coincidences = 0
        self.num_not_found = 0
        self.loop_detected = False

    # ------------------------------------------------------------------
    def new_detect_common_regions(self) -> bool:
        from ..utils import profiler

        with profiler.timer("loop_closing.detect"):
            return self._new_detect_common_regions_impl()

    def _new_detect_common_regions_impl(self) -> bool:
        kf = self.queue.pop(0)
        self.current_kf = kf
        kf.set_not_erase()
        wm = self.map
        if not self.active or not wm.inertial_ba1 or wm.n_keyframes() < 12:
            wm.add_keyframe(kf)
            kf.set_erase()
            return False

        detected_in_kf = False
        if self.num_coincidences > 0 and self.last_current_kf is not None:
            # continuation: refine Scw from the relative pose to the last
            # confirming KF (LoopClosing.cpp:216-255)
            Rcl = kf.Rcw @ self.last_current_kf.Rcw.T
            tcl = kf.tcw - Rcl @ self.last_current_kf.tcw
            Scl = Sim3T(Rcl, tcl, 1.0)
            Scw = Scl.compose(self.Slw)
            ok, n_matches, matched, Scw_new = \
                self._detect_and_refine_from_last_kf(kf, self.matched_kf, Scw)
            if ok:
                detected_in_kf = True
                self.num_coincidences += 1
                self.last_current_kf.set_erase()
                self.last_current_kf = kf
                self.Slw = Scw_new
                self.loop_matched_mps = matched
                self.loop_detected = self.num_coincidences >= 3
                self.num_not_found = 0
            else:
                self.num_not_found += 1
                if self.num_not_found >= 2:
                    self._clear_continuation()
        if self.loop_detected:
            wm.add_keyframe(kf)
            return True

        if not detected_in_kf:
            candidates = wm.detect_n_best_candidates(kf, 3)
            if candidates:
                self.loop_detected = self._detect_from_bow(kf, candidates)
        wm.add_keyframe(kf)
        if self.loop_detected:
            return True
        kf.set_erase()
        return False

    def _clear_continuation(self) -> None:
        if self.last_current_kf is not None:
            self.last_current_kf.set_erase()
        if self.matched_kf is not None:
            self.matched_kf.set_erase()
        self.num_coincidences = 0
        self.num_not_found = 0
        self.loop_matched_mps = []
        self.loop_mps = []

    # ------------------------------------------------------------------
    def _gather_window_points(self, matched_kf: KeyFrame) -> List[MapPoint]:
        """Covisibility-window map points of the matched KF
        (FindMatchesByProjection, LoopClosing.cpp:707-...)."""
        cov = matched_kf.get_best_covisibility_keyframes(10)
        kfs = [matched_kf] + cov
        pts, seen = [], set()
        for k in kfs:
            for mp in k.map_points:
                if mp is not None and not mp.is_bad() and mp.mnId not in seen:
                    seen.add(mp.mnId)
                    pts.append(mp)
        return pts

    def _project_matches(self, kf: KeyFrame, Scw: Sim3T,
                         points: List[MapPoint], th: int
                         ) -> Tuple[int, List[Optional[MapPoint]]]:
        matcher = Matcher(self.map.rig.cam, 0.75)
        matched: List[Optional[MapPoint]] = [None] * kf.N
        n = matcher.search_by_projection_sim3(kf, Scw.R, Scw.t, Scw.s,
                                              points, matched, th)
        return n, matched

    def _detect_and_refine_from_last_kf(self, kf: KeyFrame,
                                        matched_kf: KeyFrame, Scw: Sim3T):
        """DetectAndReffineSim3FromLastKF (LoopClosing.cpp:326-387)."""
        points = self._gather_window_points(matched_kf)
        self.loop_mps = points
        n, matched = self._project_matches(kf, Scw, points, th=8)
        if self.debug:
            print(f"    [lc] cont KF{kf.mnId}<-KF{matched_kf.mnId}: n={n}")
        if n < 30:
            return False, n, matched, Scw
        # optimize the relative Sim3 (scale fixed for inertial)
        S_new, n_opt = self._optimize_sim3_pair(kf, matched_kf, matched, Scw)
        if self.debug:
            print(f"    [lc] cont KF{kf.mnId}: n_opt={n_opt}")
        if n_opt <= 50:
            return False, n, matched, Scw
        n2, matched2 = self._project_matches(kf, S_new, points, th=5)
        if self.debug:
            print(f"    [lc] cont KF{kf.mnId}: n2={n2}")
        if n2 < 100:
            return False, n2, matched2, Scw
        return True, n2, matched2, S_new

    def _optimize_sim3_pair(self, kf1: KeyFrame, kf2: KeyFrame,
                            matches1: List[Optional[MapPoint]], Scw: Sim3T
                            ) -> Tuple[Sim3T, int]:
        """OptimizeSim3 wrapper: S12 between camera frames, th2 = 10."""
        idxs = [i for i, mp in enumerate(matches1) if mp is not None]
        if len(idxs) < 10:
            return Scw, 0
        # The observations are the keypoints in the pixels the camera model
        # projects to, kf.kp: undistorted on the pinhole, distorted on
        # Kannala-Brandt, whose project() applies the fisheye distortion
        # (tracking.py's pose solves take the same). The JAX package reads
        # kp_un here and in _detect_from_bow, which on Kannala-Brandt
        # compares a distorted projection with an undistorted pixel, so a
        # fisheye loop keeps too few Sim3 inliers to close
        # (tests/test_torch_fisheye_loop.py).
        X1, X2, uv1, uv2 = [], [], [], []
        for i in idxs:
            mp2 = matches1[i]
            mp1 = kf1.map_points[i]
            idx2 = mp2.get_index_in_keyframe(kf2)
            if idx2 < 0:
                continue
            src = mp1 if (mp1 is not None and not mp1.is_bad()) else mp2
            X1.append(kf1.Rcw @ src.pos + kf1.tcw)
            X2.append(kf2.Rcw @ mp2.pos + kf2.tcw)
            uv1.append(kf1.kp[i])
            uv2.append(kf2.kp[idx2])
        if len(X1) < 10:
            return Scw, 0
        # init S12 = Scw * Swm (camera1 <- camera2)
        Smw = Sim3T.from_pose(kf2.Rcw, kf2.tcw)
        S12_0 = Scw.compose(Smw.inverse())
        fix_scale = self.map.inertial_ba1
        args = _upload([S12_0.R, S12_0.t, np.float32(S12_0.s)]
                       + [np.asarray(a, np.float32)
                          for a in (X1, X2, uv1, uv2)], self.device)
        R, t, s, _, n_in = optimize_sim3(
            *args, self.map.rig.cam, self.map.rig.cam,
            fix_scale=fix_scale, th2=10.0)
        R, t, s, n_in = _fetch(R, t, s, n_in)
        S12 = Sim3T(R, t, float(s))
        S_new = S12.compose(Smw)
        return S_new, int(n_in)

    # ------------------------------------------------------------------
    def _detect_from_bow(self, kf: KeyFrame,
                         candidates: List[KeyFrame]) -> bool:
        """DetectCommonRegionsFromBoW (LoopClosing.cpp:389-694)."""
        wm = self.map
        connected = set(kf.get_connected_keyframes())
        matcher_bow = Matcher(wm.rig.cam, 0.9)
        best = None  # (n_final, matched_kf, Scw, points, matched_mps)
        for cand in candidates:
            if cand is None or cand.is_bad():
                continue
            cov = cand.get_best_covisibility_keyframes(10)
            cov_kfs = [cand] + cov
            if any(c in connected for c in cov_kfs):
                continue
            # merged BoW matches over the candidate window
            matched_points: List[Optional[MapPoint]] = [None] * kf.N
            matched_src: List[Optional[KeyFrame]] = [None] * kf.N
            seen_mp: Set[int] = set()
            n_bow = 0
            best_bow_kf, best_bow_n = cand, 0
            for c in cov_kfs:
                if c.is_bad():
                    continue
                m, n = matcher_bow.search_by_bow_kf_kf(kf, c)
                if n > best_bow_n:
                    best_bow_n, best_bow_kf = n, c
                for i, mp in enumerate(m):
                    if mp is None or mp.is_bad() or mp.mnId in seen_mp:
                        continue
                    if matched_points[i] is None:
                        seen_mp.add(mp.mnId)
                        matched_points[i] = mp
                        matched_src[i] = c
                        n_bow += 1
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: n_bow={n_bow}")
            if n_bow < 20:
                continue
            # Sim3 RANSAC between kf and the best window KF
            idxs = [i for i, mp in enumerate(matched_points)
                    if mp is not None and kf.map_points[i] is not None
                    and not kf.map_points[i].is_bad()]
            if len(idxs) < 15:
                continue
            X1 = np.stack([kf.Rcw @ kf.map_points[i].pos + kf.tcw
                           for i in idxs])
            X2 = np.stack([best_bow_kf.Rcw @ matched_points[i].pos
                           + best_bow_kf.tcw for i in idxs])
            uv1 = kf.kp[idxs]  # kf.kp: see _optimize_sim3_pair
            uv2 = np.stack([
                matched_points[i].pos[:2] * 0  # placeholder, filled below
                for i in idxs])
            ok_rows = []
            for r, i in enumerate(idxs):
                j = matched_points[i].get_index_in_keyframe(best_bow_kf)
                if j >= 0:
                    uv2[r] = best_bow_kf.kp[j]
                    ok_rows.append(r)
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: idxs={len(idxs)} rows={len(ok_rows)}")
            if len(ok_rows) < 15:
                continue
            rows = np.asarray(ok_rows)
            solver = Sim3Solver(X1[rows], X2[rows], uv1[rows], uv2[rows],
                                wm.rig.cam, fix_scale=wm.inertial_ba1,
                                min_inliers=15, device=self.device)
            T, inl, n_in, no_more = solver.iterate(300)
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: sim3 n_in={n_in} ok={T is not None}")
            if T is None:
                continue
            R12, t12, s12 = solver.get_estimates()
            Scm = Sim3T(R12, t12, s12)
            Smw = Sim3T.from_pose(best_bow_kf.Rcw, best_bow_kf.tcw)
            Scw = Scm.compose(Smw)
            # window points + projection check chain
            points = self._gather_window_points(best_bow_kf)
            n_proj, matched = self._project_matches(kf, Scw, points, th=8)
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: n_proj={n_proj}/{len(points)}")
            if n_proj < 50:
                continue
            S_new, n_opt = self._optimize_sim3_pair(kf, best_bow_kf, matched,
                                                    Scw)
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: n_opt={n_opt}")
            if n_opt < 20:
                continue
            n_final, matched_final = self._project_matches(kf, S_new, points,
                                                           th=5)
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: n_final={n_final}")
            if n_final < 80:
                continue
            # spatial confirmation by >= 3 covisible KFs of the current KF
            n_kfs = 0
            for kf_j in kf.get_best_covisibility_keyframes(10):
                Rjc = kf_j.Rcw @ kf.Rcw.T
                tjc = kf_j.tcw - Rjc @ kf.tcw
                Sjw = Sim3T(Rjc, tjc, 1.0).compose(S_new)
                n_j, _ = self._project_matches(kf_j, Sjw, points, th=8)
                if n_j >= 30:
                    n_kfs += 1
                if n_kfs >= 3:
                    break
            if self.debug:
                print(f"    [lc] cand KF{cand.mnId}: spatial n_kfs={n_kfs}")
            if n_kfs < 3:
                continue
            if best is None or n_final > best[0]:
                best = (n_final, best_bow_kf, S_new, points, matched_final)

        if best is None:
            if candidates:
                self.num_not_found += 1
            return False
        n_final, matched_kf, Scw, points, matched_mps = best
        self.matched_kf = matched_kf
        self.last_current_kf = kf
        self.Slw = Scw
        self.loop_mps = points
        self.loop_matched_mps = matched_mps
        self.num_coincidences = 1
        self.num_not_found = 0
        kf.set_not_erase()
        matched_kf.set_not_erase()
        return self.num_coincidences >= 3

    # ------------------------------------------------------------------
    def _validate_and_correct(self) -> None:
        """Rotation gate + CorrectLoop (LoopClosing.cpp:84-135, 801-1057)."""
        kf = self.current_kf
        Scw = self.Slw
        # Sww_new = Twc ∘ Scw (world alignment error of the loop)
        Twc = Sim3T(kf.Rcw.T, -kf.Rcw.T @ kf.tcw, 1.0)
        Sww = Twc.compose(Scw)
        tr = float(np.trace(Sww.R))
        valid_rot = np.isfinite(Sww.R).all() and -1.0 <= tr <= 3.0
        phi = (so3.log(Sww.R.astype(np.float32))
               if valid_rot else np.zeros(3))
        if self.debug:
            print(f"    [lc] validate KF{kf.mnId}: phi={np.round(phi, 4)} "
                  f"valid_rot={valid_rot}")
        if abs(phi[0]) < 0.008 and abs(phi[1]) < 0.008 and abs(phi[2]) < 0.349:
            if self.map.inertial_ba1:
                phi_yaw = np.float32([0.0, 0.0, phi[2]])
                R_new = so3.exp(phi_yaw).astype(np.float32)
                Sww_new = Sim3T(R_new, Sww.t, 1.0)
                Scw = Twc.inverse().compose(Sww_new)
            self.Slw = Scw
            self.correct_loop()
        self._clear_continuation()
        self.loop_detected = False

    def correct_loop(self) -> None:
        from ..utils import profiler

        profiler.count("loops_closed")
        with profiler.timer("loop_closing.correct"):
            return self._correct_loop_impl()

    def _correct_loop_impl(self) -> None:
        wm = self.map
        wm.bump_transform_epoch()  # invalidate in-flight threaded local BAs
        kf = self.current_kf
        # a running background GBA is obsolete once a new loop corrects the
        # map — kill it (reference CorrectLoop :810-834, mbStopGBA)
        if self.gba_running:
            self.stop_gba = True
            if self._gba_thread is not None:
                self._gba_thread.join()
                self._gba_thread = None
            self.gba_running = False
        Scw = self.Slw
        kf.update_connections()
        connected = kf.get_connected_keyframes() + [kf]

        Twc = Sim3T(kf.Rcw.T, -kf.Rcw.T @ kf.tcw, 1.0)
        corrected: Dict[KeyFrame, Sim3T] = {kf: Scw}
        non_corrected: Dict[KeyFrame, Sim3T] = {
            kf: Sim3T.from_pose(kf.Rcw, kf.tcw)}
        Rcw, tcw = Scw.to_se3()
        kf.set_pose(Rcw, tcw)
        imu_init = wm.imu_initialized
        for kfi in connected:
            if kfi is kf:
                continue
            Ric = kfi.Rcw @ Twc.R
            tic = kfi.Rcw @ Twc.t + kfi.tcw
            Sic = Sim3T(Ric, tic, 1.0)
            Siw_corr = Sic.compose(Scw)
            corrected[kfi] = Siw_corr
            non_corrected[kfi] = Sim3T.from_pose(kfi.Rcw, kfi.tcw)
            Rw, tw = Siw_corr.to_se3()
            kfi.set_pose(Rw, tw)
        for kfi, Siw_corr in corrected.items():
            Swi_corr = Siw_corr.inverse()
            Siw_old = non_corrected[kfi]
            for mp in kfi.map_points:
                if mp is None or mp.is_bad() or \
                        mp.corrected_by_kf == kf.mnId:
                    continue
                mp.pos = Swi_corr.map(Siw_old.map(mp.pos[None]))[0].astype(
                    np.float32)
                mp.corrected_by_kf = kf.mnId
                mp.corrected_reference = kfi.mnId
                mp.update_normal_and_depth()
            if imu_init:
                Rcor = Swi_corr.R @ Siw_old.R
                kfi.velocity = (Rcor @ kfi.velocity).astype(np.float32)
            kfi.update_connections()
        wm.info_map_change()

        # fuse loop-matched duplicates (:887-906)
        for i, loop_mp in enumerate(self.loop_matched_mps):
            if loop_mp is None:
                continue
            cur_mp = kf.get_map_point(i)
            if cur_mp is not None:
                cur_mp.replace(loop_mp)
            else:
                kf.add_map_point(loop_mp, i)
                loop_mp.add_observation(kf, i)
                loop_mp.compute_distinctive_descriptor()

        # SearchAndFuse over corrected covisibles (:1059-1098)
        matcher = Matcher(wm.rig.cam, 0.8)
        for kfi, Siw_corr in corrected.items():
            replace: List[Optional[MapPoint]] = [None] * len(self.loop_mps)
            matcher.fuse_sim3(kfi, Siw_corr.R, Siw_corr.t, Siw_corr.s,
                              self.loop_mps, 4.0, replace)
            for j, rep in enumerate(replace):
                if rep is not None:
                    rep.replace(self.loop_mps[j])

        # new loop connections for the essential graph
        loop_connections: Dict[KeyFrame, Set[KeyFrame]] = {}
        for kfi in connected:
            prev_neigh = list(kfi.ordered_connected)
            kfi.update_connections()
            s = set(kfi.get_connected_keyframes())
            for p in prev_neigh:
                s.discard(p)
            for p in connected:
                s.discard(p)
            loop_connections[kfi] = s

        from ..utils import profiler

        with profiler.timer("loop_closing.essential_graph"):
            self._optimize_essential_graph(loop_connections, corrected,
                                           non_corrected)
        self.matched_kf.add_loop_edge(kf)
        kf.add_loop_edge(self.matched_kf)

        if not wm.imu_initialized or wm.n_keyframes() < 200:
            if self.threaded_gba:
                self.start_gba_thread(kf.mnId)
            else:
                self.run_global_ba(kf.mnId)
        self.n_loops_closed += 1

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, loop_connections, corrected,
                                  non_corrected) -> None:
        """Edge-set construction (OptimizerGraph.cpp:31-353 / :638-962)."""
        wm = self.map
        kfs = sorted(wm.all_keyframes(), key=lambda k: k.mnId)
        idx = {k.mnId: i for i, k in enumerate(kfs)}
        n = len(kfs)
        min_weight = 100

        # collect unique edges (i, j, Sji from current/non-corrected poses)
        pairs: Set[Tuple[int, int]] = set()
        ii, jj, SR, St, Ss = [], [], [], [], []

        def pose_sim3(k: KeyFrame) -> Sim3T:
            return non_corrected.get(k, Sim3T.from_pose(k.Rcw, k.tcw))

        def add_edge(ka: KeyFrame, kb: KeyFrame, use_corrected=False):
            a, b = idx.get(ka.mnId), idx.get(kb.mnId)
            if a is None or b is None or a == b:
                return
            key = (min(a, b), max(a, b))
            if key in pairs:
                return
            pairs.add(key)
            Sa = (corrected.get(ka, pose_sim3(ka)) if use_corrected
                  else pose_sim3(ka))
            Sb = (corrected.get(kb, pose_sim3(kb)) if use_corrected
                  else pose_sim3(kb))
            Sba = Sb.compose(Sa.inverse())
            ii.append(a)
            jj.append(b)
            SR.append(Sba.R)
            St.append(Sba.t)
            Ss.append(Sba.s)

        cur, matched = self.current_kf, self.matched_kf
        # new loop connections (weight >= 100, except the cur<->matched pair)
        for kfi, conns in loop_connections.items():
            for kfj in conns:
                if (kfi is cur and kfj is matched) or \
                        (kfj is cur and kfi is matched) or \
                        kfi.get_weight(kfj) >= min_weight:
                    add_edge(kfi, kfj, use_corrected=True)
        # explicit loop edges, covisibility >= 100, temporal chain
        for k in kfs:
            for le in k.loop_edges:
                add_edge(k, le)
            for cov in k.get_covisibles_by_weight(min_weight):
                add_edge(k, cov)
            if k.prev_kf is not None:
                add_edge(k, k.prev_kf)

        if not ii:
            return
        graph_fixed = np.zeros(n, bool)
        graph_fixed[idx[matched.mnId]] = True
        dev = self.device
        ij = [torch.as_tensor(np.asarray(v, np.int64), device=dev)
              for v in (ii, jj)]

        if wm.imu_initialized:
            # 4-DoF: body poses, measurements Ti<-j from current poses.
            # The vertices are the bodies, so each camera measurement
            # becomes the bodies' Tbi<-bj = Tbc Tci<-cj Tcb (ORB-SLAM3's
            # Edge4DoF compares camera poses, which its vertices derive from
            # the bodies). The JAX package gives the camera measurement to
            # the body vertices: with a camera mounted off the body's axes
            # (every shipped config's T_b_c1) no edge holds at the current
            # poses, and the graph turns and throws the keyframes
            # (tests/test_torch_fisheye_loop.py).
            rig = wm.rig
            Rwb = np.stack([k.imu_rotation() for k in kfs]).astype(np.float32)
            twb = np.stack([k.imu_position() for k in kfs]).astype(np.float32)
            dRij = np.empty((len(ii), 3, 3), np.float32)
            dtij = np.empty((len(ii), 3), np.float32)
            for k_, (R_, t_, s_) in enumerate(zip(SR, St, Ss)):
                # Sji maps i->j (camera); Edge4DoF wants Ti<-j: invert
                Sij = Sim3T(R_, t_, s_).inverse()
                Rc, tc = Sij.to_se3()
                dRij[k_] = rig.Rbc @ Rc @ rig.Rcb
                dtij[k_] = rig.Rbc @ (Rc @ rig.tcb + tc) + rig.tbc
            Rwb, twb, dRij, dtij, fixed = _upload(
                [Rwb, twb, dRij, dtij, graph_fixed], dev)
            Rf, tf = _fetch(*optimize_essential_graph_4dof(
                Rwb, twb, Graph4DoF(*ij, dRij, dtij), fixed))
            old = [(k.Rcw.copy(), k.tcw.copy()) for k in kfs]
            for i, k in enumerate(kfs):
                Rbw = Rf[i].T
                tbw = -Rbw @ tf[i]
                k.set_pose(rig.Rcb @ Rbw, rig.Rcb @ tbw + rig.tcb)
            self._correct_points_after_graph(kfs, old)
        else:
            Rcw = np.stack([k.Rcw for k in kfs]).astype(np.float32)
            tcw = np.stack([k.tcw for k in kfs]).astype(np.float32)
            scw = np.ones(n, np.float32)
            for k, S in corrected.items():
                i = idx.get(k.mnId)
                if i is not None:
                    Rcw[i], tcw[i], scw[i] = S.R, S.t, S.s
            up = _upload([Rcw, tcw, scw, np.stack(SR), np.stack(St),
                          np.asarray(Ss, np.float32), graph_fixed], dev)
            Rf, tf, sf = _fetch(*optimize_essential_graph(
                *up[:3], Sim3Graph(*ij, *up[3:6]), up[6],
                fix_scale=wm.inertial_ba1))
            old = [(k.Rcw.copy(), k.tcw.copy()) for k in kfs]
            for i, k in enumerate(kfs):
                k.set_pose(Rf[i], tf[i] / sf[i])  # [sR t] -> [R t/s]
            self._correct_points_after_graph(kfs, old, sf)
        # edge/coline cleanup (:312-331)
        for mp in wm.all_map_points():
            mp.remove_coline_outliers()
        for me in list(wm.map_edges):
            if not me.is_bad():
                me.check_valid()
        wm.info_map_change()

    def _correct_points_after_graph(self, kfs, old_poses, scales=None):
        """MP correction via their reference KF old->new transform
        (OptimizerGraph.cpp:283-310)."""
        idx = {k.mnId: i for i, k in enumerate(kfs)}
        for mp in self.map.all_map_points():
            ref = None
            if mp.corrected_by_kf == self.current_kf.mnId:
                ref_id = mp.corrected_reference
                for k in kfs:
                    if k.mnId == ref_id:
                        ref = k
                        break
            if ref is None:
                ref = next(iter(mp.observations), None)
            if ref is None or ref.mnId not in idx:
                continue
            i = idx[ref.mnId]
            R_old, t_old = old_poses[i]
            Xc = R_old @ mp.pos + t_old
            if scales is not None:
                Xc = Xc / scales[i]
            mp.pos = (ref.Rcw.T @ (Xc - ref.tcw)).astype(np.float32)
            mp.update_normal_and_depth()

    # ------------------------------------------------------------------
    def run_global_ba(self, loop_kf_id: int) -> None:
        """RunGlobalBundleAdjustment + propagation (LoopClosing.cpp:1139-1289),
        synchronous: solve, then apply scratch directly."""
        self._solve_gba(loop_kf_id, abort_check=None)
        self._apply_gba(loop_kf_id)

    # -- background-GBA protocol ---------------------------------------
    def start_gba_thread(self, loop_kf_id: int) -> None:
        """Spawn GBA on a background thread (reference LoopClosing.cpp:1050).
        Results are applied by poll_gba() at the next safe point; a newer
        loop kills the run via stop_gba (CorrectLoop :810-834)."""
        import threading

        self.stop_gba = False
        self.gba_running = True
        self._gba_loop_kf = loop_kf_id
        self._gba_thread = threading.Thread(
            target=self._gba_worker, args=(loop_kf_id,), daemon=True)
        self._gba_thread.start()

    def _gba_worker(self, loop_kf_id: int) -> None:
        try:
            self._solve_gba(loop_kf_id,
                            abort_check=lambda: self.stop_gba)
        except Exception as e:  # a dying GBA thread must not take the
            import traceback    # pipeline down: its run is discarded

            traceback.print_exc()
            self.gba_error = e
            self.stop_gba = True

    def poll_gba(self, wait: bool = False) -> bool:
        """Apply finished background-GBA results. Called from the pipeline
        thread (the reference applies from the GBA thread after stopping
        LocalMapping; here the pipeline polls at keyframe boundaries, which
        is the same safe point). Returns True if results were applied."""
        if not self.gba_running or self._gba_thread is None:
            return False
        if wait:
            self._gba_thread.join()
        elif self._gba_thread.is_alive():
            return False
        self._gba_thread = None
        self.gba_running = False
        if self.stop_gba:
            return False  # killed: scratch discarded
        with self.map.update_lock:
            self._apply_gba(self._gba_loop_kf)
        return True

    def _solve_gba(self, loop_kf_id: int, abort_check) -> Optional[dict]:
        """The loop GBA into the gba_* fields; returns the BA entry point's
        summary (None where there was nothing to solve)."""
        from ..utils import profiler

        with profiler.timer("loop_closing.gba"):
            return self._solve_gba_impl(loop_kf_id, abort_check)

    def _solve_gba_impl(self, loop_kf_id: int,
                        abort_check) -> Optional[dict]:
        wm = self.map
        lock = wm.update_lock if self.threaded_gba else None
        if wm.imu_initialized:
            return full_inertial_ba(wm, iters=50, loop_kf=loop_kf_id,
                                    b_init=False, abort_check=abort_check,
                                    map_lock=lock, device=self.device)
        return global_bundle_adjustment(wm, iters=10, loop_kf=loop_kf_id,
                                        abort_check=abort_check,
                                        map_lock=lock, device=self.device)

    def _apply_gba(self, loop_kf_id: int) -> None:
        """Propagate GBA scratch to the live map (LoopClosing.cpp:1189-1289):
        stamped KFs take their optimized pose; KFs created while GBA ran are
        corrected through their temporal predecessor (the reference walks the
        spanning tree with mTcwBefGBA), and unstamped MapPoints follow their
        reference KF's before->after transform."""
        wm = self.map
        wm.bump_transform_epoch()  # invalidate in-flight threaded local BAs
        kfs = sorted(wm.all_keyframes(), key=lambda k: k.mnId)
        before = {k.mnId: (k.Rcw.copy(), k.tcw.copy()) for k in kfs}
        corrected = set()  # KFs updated in this pass (stamped or chained)
        for kf in kfs:
            if kf.ba_global_for_kf == loop_kf_id and kf.gba_Rcw is not None:
                kf.set_pose(kf.gba_Rcw, kf.gba_tcw)
                if kf.gba_vel is not None:
                    kf.velocity = kf.gba_vel.copy()
                if kf.gba_bias is not None:
                    kf.bias = kf.gba_bias.copy()
                corrected.add(kf.mnId)
            else:
                # mid-GBA keyframe: T_new = T_rel(prev_before) * Tprev_new.
                # Ascending-mnId order means a predecessor that was itself
                # mid-GBA has already been chained through by the time we
                # reach this KF (the reference walks spanning-tree children,
                # LoopClosing.cpp:1213), so accept both GBA-stamped and
                # already-corrected predecessors.
                prev = kf.prev_kf
                while prev is not None and prev.mnId not in before:
                    prev = prev.prev_kf
                if prev is None or (prev.ba_global_for_kf != loop_kf_id
                                    and prev.mnId not in corrected):
                    continue
                Rp_b, tp_b = before[prev.mnId]
                R_old, t_old = before[kf.mnId]
                R_rel = R_old @ Rp_b.T
                t_rel = t_old - R_rel @ tp_b
                R_new = R_rel @ prev.Rcw
                t_new = R_rel @ prev.tcw + t_rel
                # world-frame velocity correction v' = Rwc_new @ Rcw_old @ v
                # (LoopClosing.cpp:1217, Tracking.cpp:1624)
                dRw = R_new.T @ R_old
                kf.velocity = (dRw @ kf.velocity).astype(np.float32) \
                    if kf.velocity is not None else kf.velocity
                kf.set_pose(R_new.astype(np.float32),
                            t_new.astype(np.float32))
                corrected.add(kf.mnId)
        for mp in wm.all_map_points():
            if mp.is_bad():
                continue
            if mp.ba_global_for_kf == loop_kf_id and mp.gba_pos is not None:
                mp.pos = mp.gba_pos.copy()
                mp.update_normal_and_depth()
            else:
                # correct via its reference KF's before/after pose
                ref = next(iter(mp.observations), None)
                if ref is None or ref.mnId not in before:
                    continue
                R_b, t_b = before[ref.mnId]
                Xc = R_b @ mp.pos + t_b
                mp.pos = (ref.Rcw.T @ (Xc - ref.tcw)).astype(np.float32)
                mp.update_normal_and_depth()
        wm.info_map_change()
