"""Per-frame tracking — the reference MSTracking (system/src/Tracking.cpp).

Port of ppg_slam_tpu/pipeline/tracking.py. The state machine, the keyframe
policy, the IMU-init schedule and the scale-trim policy are the reference's,
unchanged; its device calls (two-view reconstruction, pose and
pose-inertial optimization, inertial initialization and the BA entry
points) run on `device` (CUDA unless the caller names another), each
reading its results back in one transfer.

State machine NO_IMAGES_YET -> NOT_INITIALIZED -> OK -> RECENTLY_LOST -> LOST
(Tracking.h:25-31). Per-frame flow mirrors Track() (:251-482): IMU
preintegration of the queue, monocular initialization, IMU initialization +
scale refinement scheduling, motion-model / reference-KF / IMU-predicted
tracking, local-map tracking with PPG ExtendMapMatches, keyframe policy,
relative-pose trajectory log.

Device work per frame: the PPG extractor, the gated descriptor match (with
device-resident descriptors), one pose optimization (pose-only LM or the
2-frame VI filter), at the exact number of matches.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..estimator.ba import _fetch, _upload
from ..estimator.pose_opt import (
    FrameVIState,
    PoseInertialReplay,
    PreintData,
    Prior15,
    pose_inertial_optimization,
    pose_optimization,
)
from ..geometry.two_view import make_ransac_sets, two_view_reconstruct
from ..imu import GRAVITY_VALUE, Preintegrated
from ..matching import Matcher
from ..worldmap import Frame, KeyFrame, Map, MapPoint, Rig
from ..worldmap.elements import MapEdge

# tracking states (Tracking.h:25-31)
NO_IMAGES_YET = -1
NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3


def _small_transform(Rwg: np.ndarray, scale: float,
                     max_ds: float = 0.05, max_ang: float = 0.035) -> bool:
    """True when a candidate whole-map (rotation, scale) correction is
    bounded-impact: <=5% rescale and <=2 deg rotation. Such annealing-size
    corrections apply unconditionally (reference ScaleRefinement semantics)
    — only LARGE transforms go through the full-objective acceptance gate,
    which exists to refuse catastrophic mis-estimates (0.2-0.5x collapses,
    wrong gravity rotations) on live maps."""
    ang = float(np.arccos(np.clip(
        (np.trace(np.asarray(Rwg, np.float64)) - 1.0) / 2.0, -1.0, 1.0)))
    return abs(float(scale) - 1.0) <= max_ds and ang <= max_ang


# Whole-map scale-TRIM band (r5): the closed-form inertial-init scale is
# applied only inside this log-symmetric band — see the policy comment in
# initialize_imu. Shared by init/VIBA/refine so the system has ONE notion
# of how far a single closed-form estimate may move the map.
SCALE_TRIM_LO = 0.7
SCALE_TRIM_HI = 1.0 / 0.7
# Cumulative SHRINK budget across all applied whole-map trims: the
# attenuation bias proposes spurious shrinks persistently, so even
# in-band trims random-walk the scale DOWN monotonically (captured:
# 0.888 x 0.901 x 0.968 = x0.77 across three healthy-looking events on a
# near-metric map). Growth extends the budget; total shrink below
# SCALE_SHRINK_BUDGET of the running product is refused.
SCALE_SHRINK_BUDGET = 0.85


def _trim_accepts(scale: float, cum: float) -> bool:
    """True when a whole-map scale trim is inside the per-event band AND
    the cumulative shrink budget (cum = product of scales applied so
    far). The single decision function behind init/VIBA/refine applies."""
    floor = max(SCALE_TRIM_LO, SCALE_SHRINK_BUDGET / max(cum, 1e-6))
    return floor <= float(scale) <= SCALE_TRIM_HI


def _sqrtm_psd_np(H):
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    w = np.clip(w, 0, None)
    return ((V * np.sqrt(w)) @ V.T).astype(np.float32)


class Tracking:
    # Minimum IMU-data span (s) before the FIRST closed-form inertial init
    # runs (reference floor: 2.0 s, Tracking.cpp:1503). The first init
    # applies its scale UNCONDITIONALLY (the monocular map has no metric
    # scale yet — reference semantics), so its quality is decided entirely
    # by this window's excitation-vs-noise ratio: r5 live loop-corridor
    # captures measured first-init scales of 0.427/0.715/0.736 with the
    # 2 s floor (each one seeding an unrecoverable collapse once the IMU
    # coast hit a turn) vs 0.996+ on windows whose accel curvature spans
    # a full excitation period. Rigs/benches with soft early excitation
    # should raise this the same way the reference's per-dataset IniTime
    # (5-10 s, config/*.yaml) tunes the VIBA1 schedule.
    min_init_window_s = 2.0

    def __init__(self, wmap: Map, extractor, local_mapper=None,
                 insert_kfs_lost: bool = True, device=None):
        """device: where the tracker's solves run (two-view, pose,
        pose-inertial, inertial init, the BA entry points it calls, the
        preintegration and the device matcher); CUDA unless the caller
        names another (raises where no CUDA device is present)."""
        self.device = resolve_device(device)
        self.map = wmap
        self.rig: Rig = wmap.rig
        self.extractor = extractor
        self.local_mapper = local_mapper
        # state-transition observability (VERDICT r4 #3): every state
        # change is recorded with the frame timestamp so a not-OK run can
        # be diagnosed from the bench/e2e artifact alone
        self.state_events: List[dict] = []
        self._state = NO_IMAGES_YET
        self.matcher_cls = Matcher
        self.insert_kfs_lost = insert_kfs_lost

        self.imu_queue: List[np.ndarray] = []  # rows (ax..az, wx..wz, t)
        self.preint_from_kf: Optional[Preintegrated] = None
        self.last_kf: Optional[KeyFrame] = None
        self.ref_kf: Optional[KeyFrame] = None
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        self.init_frame: Optional[Frame] = None
        self.prev_matched: Optional[np.ndarray] = None
        self.init_matches: Optional[np.ndarray] = None
        self.ready_to_init = False
        self.velocity = None  # (R, t) of Tcl motion model
        self.t_init = 0.0
        self._last_refine_kf_id = -1
        self._applied_scale_cum = 1.0  # see SCALE_SHRINK_BUDGET
        self.time_lost = 0.0
        self.last_reloc_frame_id = -1000000
        self.matches_inliers = 0
        self.map_updated = False
        self.last_bias = np.zeros(6, np.float32)

        # trajectory log (Tracking.h:90-93)
        self.rel_poses: List[tuple] = []   # (Rcr, tcr)
        self.references: List[KeyFrame] = []
        self.frame_times: List[float] = []
        self.lost_flags: List[bool] = []

        self.local_keyframes: List[KeyFrame] = []
        self.local_points: List[MapPoint] = []
        self.n_resets = 0
        # observability: every IMU-init / scale-refinement event (timestamp,
        # kind, estimated scale, #KFs, applied?) — the live bench prints
        # this tail so scale annealing is evidence, not narrative
        self.init_events: List[dict] = []
        self.on_map_event = None  # optional callback(event_dict)
        # optional offline viewer (reference MSViewing; viz/viewer.py)
        self.viewer = None
        # device-side gated matching (created lazily on the first frame
        # extracted with desc_transfer="device"; matching/device_match.py)
        self._dev_matcher = None
        # pose_inertial_optimization's CUDA graphs (created at the first
        # inertial frame on a CUDA device)
        self._pose_replay = None

    @property
    def state(self) -> int:
        return self._state

    def _preint(self, bias) -> Preintegrated:
        """A new preintegration at `bias`, integrating on the tracker's
        device."""
        return Preintegrated(bias, self.rig.nga, self.rig.nga_walk,
                             device=self.device)

    @state.setter
    def state(self, value: int) -> None:
        old = getattr(self, "_state", None)
        self._state = value
        if old is not None and old != value:
            t = None
            for src in (getattr(self, "current", None),
                        getattr(self, "last_frame", None)):
                if src is not None:
                    t = float(src.timestamp)
                    break
            self.state_events.append(
                dict(t=t, from_state=old, to_state=value))

    # ------------------------------------------------------------------
    def resume_from_map(self) -> None:
        """Resume tracking against a pre-populated (loaded) map: start LOST
        and relocalize into it instead of running monocular initialization.
        The reference has no persistence at all (SURVEY.md §5); this is the
        checkpoint/resume half of the rebuild's map serialization
        (worldmap/serialize.py). Assumes the resumed feed's clock continues
        the saved run's (same dataset epoch)."""
        if self.map.n_keyframes() == 0:
            return
        kfs = sorted(self.map.all_keyframes(), key=lambda k: k.mnId)
        self.last_kf = kfs[-1]
        self.ref_kf = kfs[-1]
        self.last_bias = kfs[-1].bias.copy()
        self.preint_from_kf = self._preint(self.last_bias)
        self.state = LOST

    # ------------------------------------------------------------------
    def grab_imu(self, measurements: np.ndarray) -> None:
        """measurements rows: (ax, ay, az, wx, wy, wz, t)."""
        for m in np.atleast_2d(measurements):
            self.imu_queue.append(np.asarray(m, np.float64))

    def grab_image(self, image: np.ndarray, timestamp: float,
                   feats=None) -> Frame:
        """Per-frame entry. feats: precomputed FrameFeatures (the async
        front-end path — frontend/prefetch.py dispatched this frame's
        extraction while earlier frames were being tracked); None extracts
        synchronously (the reference's in-ctor extraction, Frame.cpp:50-78).
        """
        from ..utils import profiler

        if feats is None:
            with profiler.timer("tracking.extract"):
                feats = self.extractor.extract(image)
        frame = Frame(feats, timestamp, self.rig)
        frame.prev_frame = self.last_frame
        self.current = frame
        if self.viewer is not None:
            # step-by-step debug gate (reference Tracking.cpp:254-259)
            self.viewer.wait_step()
        with profiler.timer("tracking.track"):
            self.track()
        profiler.count("frames")
        if self.viewer is not None:
            # reference MSViewing::UpdateFrame (Viewer.cpp:410-447)
            ini = (self.init_frame.kp
                   if self.init_frame is not None else None)
            self.viewer.update_frame(frame, self.state, image=image,
                                     ini_pos=ini,
                                     ini_matches=self.init_matches)
        return frame

    # ------------------------------------------------------------------
    def track(self) -> None:
        # The reference holds Map::mMutexMapUpdate across the per-frame
        # pose-estimation and map-mutation section (Tracking.cpp:333); the
        # whole step runs under the re-entrant map update lock so a
        # background-GBA thread's gather/apply phases (loop_closing.py)
        # always see a consistent map snapshot. Single-threaded pipelines
        # pay only an uncontended RLock acquire. The measured wait
        # ("tracking.lock_wait") is the overlap diagnostic for the threaded
        # mapper: solve phases run unlocked, so a healthy deployment shows
        # near-zero wait here while BAs are in flight.
        import time as _time

        from ..utils import profiler

        t0 = _time.perf_counter()
        with self.map.update_lock:
            profiler.add_time("tracking.lock_wait",
                              _time.perf_counter() - t0)
            self._track_impl()

    def _track_impl(self) -> None:
        frame = self.current
        if self.state != NO_IMAGES_YET and self.last_frame is not None and (
                self.last_frame.timestamp > frame.timestamp
                or frame.timestamp > self.last_frame.timestamp + 1.0):
            self.imu_queue.clear()
            self.reset()
            return
        if self.last_kf is not None:
            frame.bias = self.last_kf.bias.copy()
        if self.state == NO_IMAGES_YET:
            self.state = NOT_INITIALIZED
        self.preintegrate_imu()

        if self.state == NOT_INITIALIZED:
            self.monocular_initialization()
            if self.state == OK:
                self._log_pose(frame)
            else:
                self.last_frame = frame
            return

        # IMU initialization scheduling (Track() :304-325)
        if not self.map.imu_initialized:
            self.initialize_imu(prior_g=1e2, prior_a=1e10, fiba=True)
        else:
            if self.last_kf is not None and self.last_kf.prev_kf is not None:
                dist = np.linalg.norm(self.last_kf.prev_kf.camera_center()
                                      - self.last_kf.camera_center())
                if dist > 0.05:
                    self.t_init += (self.last_kf.timestamp
                                    - self.last_kf.prev_kf.timestamp)
            if not self.map.inertial_ba1 and self.t_init > Map.imu_ini_time:
                self.map.inertial_ba1 = True
                self.initialize_imu(prior_g=1.0, prior_a=1e5, fiba=True)
            nkf = self.map.n_keyframes()
            if (nkf <= 100 and nkf % 20 == 0 and self.last_kf is not None
                    and self.last_kf.mnId != self._last_refine_kf_id
                    and self.state == OK):
                # dedup: nkf%20==0 holds across consecutive frames until a
                # new KF lands; re-running refine on the identical map state
                # is pure waste (same estimate, same gate decision).
                # state==OK: coasting/lost frames now create keyframes
                # (reference insert_kfs_lost), and a refine estimated over
                # a map whose tail is IMU dead-reckoning is garbage-in
                # (r5 live capture: refine at 0.12 + conformal 0.25x fired
                # mid-coast and quartered an already-collapsed map)
                self._last_refine_kf_id = self.last_kf.mnId
                self.scale_refinement()

        self.map_updated = self.map.check_map_changed()
        self._check_replaced_in_last_frame()

        ok = False
        if not self.map.imu_initialized:
            if frame.mnId < self.last_reloc_frame_id + 2:
                ok = self.track_reference_keyframe()
            else:
                ok = self.track_with_motion_model()
                if not ok:
                    ok = self.track_reference_keyframe()
        else:
            ok = self.predict_state_imu()

        if self.state == LOST:
            # LOST with an established map: relocalize instead of resetting
            if self.map.n_keyframes() > 10 and self.relocalization():
                self.state = OK
                ok = True
                self.time_lost = frame.timestamp
            else:
                self._log_pose(frame)
                self.last_frame = frame
                return

        if not ok:
            self.state = LOST
            self._maybe_reset_on_lost()
            return

        if frame.ref_kf is None:
            frame.ref_kf = self.ref_kf
        if self.state != LOST and ok:
            ok = self.track_local_map()

        if self.state != LOST and ok:
            self.time_lost = frame.timestamp
            self.state = OK
        elif self.map.imu_initialized:
            self.state = RECENTLY_LOST
            # coast on IMU first (cheap and accurate short-term); once the
            # coast has run > 1 s, also try to re-anchor visually (the
            # reference ships the full Relocalization pipeline but never
            # calls it from Track — SURVEY §5; wired here)
            if (frame.timestamp - self.time_lost > 1.0
                    and self.map.n_keyframes() > 10
                    and self.relocalization()):
                ok = True
                self.state = OK
                self.time_lost = frame.timestamp
            elif frame.timestamp - self.time_lost < 5.0:
                ok = True
                self.predict_state_imu()
            else:
                self.state = LOST
                self._maybe_reset_on_lost()
                return
        else:
            if self.map.n_keyframes() > 10 and self.relocalization():
                ok = True
                self.state = OK
                self.time_lost = frame.timestamp
            else:
                self.state = LOST
                self._maybe_reset_on_lost()
                return

        if self.state != LOST:
            if self.map.imu_initialized and ok and \
                    frame.mnId > self.last_reloc_frame_id + 30:
                self.last_bias = frame.bias.copy()
            if ok or self.state == RECENTLY_LOST:
                # motion model
                if self.last_frame is not None and self.last_frame.has_pose \
                        and frame.has_pose:
                    Rlw, tlw = self.last_frame.Rcw, self.last_frame.tcw
                    Rv = frame.Rcw @ Rlw.T
                    tv = frame.tcw - Rv @ tlw
                    self.velocity = (Rv, tv)
                # clean VO matches
                for i in range(frame.N):
                    mp = frame.map_points[i]
                    if mp is not None and mp.n_observations() < 1:
                        frame.outlier[i] = False
                        frame.map_points[i] = None
                if self.need_new_keyframe() and (
                        ok or (self.insert_kfs_lost
                               and self.state == RECENTLY_LOST)):
                    self.create_new_keyframe()
                for i in range(frame.N):
                    if frame.map_points[i] is not None and frame.outlier[i]:
                        frame.map_points[i] = None
                self._log_pose(frame)
            if frame.ref_kf is None:
                frame.ref_kf = self.ref_kf
            self.last_frame = frame

        if self.state == LOST:
            self._maybe_reset_on_lost()

    def _maybe_reset_on_lost(self) -> None:
        if self.map.n_keyframes() <= 10 or not self.map.imu_initialized:
            self.reset()

    # ------------------------------------------------------------------
    # relocalization (Tracking.cpp:1179-1345)
    # ------------------------------------------------------------------
    def relocalization(self) -> bool:
        from ..utils import profiler

        profiler.count("relocalization_attempts")
        with profiler.timer("tracking.relocalization"):
            return self._relocalization_impl()

    def _relocalization_impl(self) -> bool:
        """BoW candidates -> PnP RANSAC -> pose optimization -> projection
        widening. The reference ships this full pipeline but never invokes
        it from Track() (LOST -> reset instead, SURVEY §5); the rebuild
        wires it into the RECENTLY_LOST/LOST paths so tracking loss with an
        established map recovers without a map reset."""
        frame = self.current
        wm = self.map
        if wm.vocabulary is None or frame is None or frame.N == 0:
            return False
        if frame.bow_vec is None:
            frame.bow_vec, frame.feat_vec = wm.vocabulary.transform(
                frame.descriptors)
        candidates = wm.detect_relocalization_candidates(frame)
        if not candidates:
            return False

        from ..matching.pnp import PnPSolver

        matcher = self.matcher_cls(self.rig.cam, 0.75)
        solvers, cand_matches, discarded = [], [], []
        for kf in candidates:
            matches, n = matcher.search_by_bow_kf_frame(kf, frame)
            if n < 15:
                solvers.append(None)
                cand_matches.append(None)
                continue
            idxs = [i for i, mp in enumerate(matches) if mp is not None]
            Xw = np.stack([matches[i].pos for i in idxs])
            uv = frame.kp[idxs]  # the camera model's pixels (see above)
            s = PnPSolver(Xw, uv, self.rig.cam, probability=0.99,
                          min_inliers=10, max_iterations=300, min_set=6,
                          epsilon=0.5, th2=5.991)
            solvers.append((s, idxs))
            cand_matches.append(matches)

        matcher2 = self.matcher_cls(self.rig.cam, 0.9)
        for _round in range(30):
            alive = False
            for ci, entry in enumerate(solvers):
                if entry is None:
                    continue
                s, idxs = entry
                ok, Rcw, tcw, inliers, n_in, no_more = s.iterate(5)
                if no_more:
                    solvers[ci] = None
                if not ok:
                    alive = alive or not no_more
                    continue
                alive = True
                frame.set_pose(Rcw, tcw)
                frame.has_pose = True
                matches = cand_matches[ci]
                found = set()
                for j, i in enumerate(idxs):
                    frame.map_points[i] = matches[i] if inliers[j] else None
                    if inliers[j]:
                        found.add(matches[i])
                n_good = self._run_pose_optimization(frame)
                if n_good < 10:
                    continue
                for i in range(frame.N):
                    if frame.outlier[i]:
                        frame.map_points[i] = None
                if n_good < 50:  # projection widening (Tracking.cpp:1280-…)
                    n_add = matcher2.search_by_projection_reloc(
                        frame, candidates[ci], found, th=10, desc_th=1.0)
                    if n_good + n_add >= 50:
                        n_good = self._run_pose_optimization(frame)
                        if 30 < n_good < 50:
                            found = {mp for i, mp in
                                     enumerate(frame.map_points)
                                     if mp is not None}
                            matcher2.search_by_projection_reloc(
                                frame, candidates[ci], found, th=3,
                                desc_th=0.9)
                            n_good = self._run_pose_optimization(frame)
                if n_good >= 50:
                    self.last_reloc_frame_id = frame.mnId
                    self.ref_kf = candidates[ci]
                    frame.ref_kf = candidates[ci]
                    return True
            if not alive:
                break
        return False

    def _log_pose(self, frame: Frame) -> None:
        ref = frame.ref_kf
        if frame.has_pose and ref is not None:
            Rcr = frame.Rcw @ ref.Rcw.T
            tcr = frame.tcw - Rcr @ ref.tcw
            self.rel_poses.append((Rcr, tcr))
            self.references.append(ref)
            self.frame_times.append(frame.timestamp)
            self.lost_flags.append(self.state == LOST)
        elif self.rel_poses:
            self.rel_poses.append(self.rel_poses[-1])
            self.references.append(self.references[-1])
            self.frame_times.append(self.frame_times[-1])
            self.lost_flags.append(self.state == LOST)

    def _check_replaced_in_last_frame(self) -> None:
        if self.last_frame is None:
            return
        for i, mp in enumerate(self.last_frame.map_points):
            if mp is not None and mp.replaced is not None:
                self.last_frame.map_points[i] = mp.replaced

    # ------------------------------------------------------------------
    # IMU handling (Tracking.cpp:81-236)
    # ------------------------------------------------------------------
    def preintegrate_imu(self) -> None:
        from ..utils import profiler

        with profiler.timer("tracking.preintegrate"):
            return self._preintegrate_imu_impl()

    def _preintegrate_imu_impl(self) -> None:
        frame = self.current
        if frame.prev_frame is None or not self.imu_queue:
            frame.imu_predicted = False
            return
        prev_t = frame.prev_frame.timestamp
        cur_t = frame.timestamp
        per = 1.0 / self.rig.freq
        meas = []
        while self.imu_queue:
            m = self.imu_queue[0]
            if m[6] < prev_t - per:
                self.imu_queue.pop(0)
            elif m[6] < cur_t - per:
                meas.append(m)
                self.imu_queue.pop(0)
            else:
                meas.append(m)
                break
        n = len(meas) - 1
        if n <= 0:
            return
        # trapezoid integration with boundary interpolation (:133-171)
        accs, gyrs, dts = [], [], []
        for i in range(n):
            a0, w0, t0 = meas[i][:3], meas[i][3:6], meas[i][6]
            a1, w1, t1 = meas[i + 1][:3], meas[i + 1][3:6], meas[i + 1][6]
            if i == 0 and i < n - 1:
                tab = t1 - t0
                tini = t0 - prev_t
                acc = (a0 + a1 - (a1 - a0) * (tini / tab)) * 0.5
                gyr = (w0 + w1 - (w1 - w0) * (tini / tab)) * 0.5
                tstep = t1 - prev_t
            elif i < n - 1:
                acc = (a0 + a1) * 0.5
                gyr = (w0 + w1) * 0.5
                tstep = t1 - t0
            elif i > 0:
                tab = t1 - t0
                tend = t1 - cur_t
                acc = (a0 + a1 - (a1 - a0) * (tend / tab)) * 0.5
                gyr = (w0 + w1 - (w1 - w0) * (tend / tab)) * 0.5
                tstep = cur_t - t0
            else:  # single interval
                acc, gyr, tstep = a0, w0, cur_t - prev_t
            accs.append(acc)
            gyrs.append(gyr)
            dts.append(tstep)
        accs = np.asarray(accs, np.float32)
        gyrs = np.asarray(gyrs, np.float32)
        dts = np.asarray(dts, np.float32)

        if self.preint_from_kf is None:
            self.preint_from_kf = self._preint(np.zeros(6))
        self.preint_from_kf.integrate_measurements(accs, gyrs, dts)
        pf = self._preint(self.last_frame.bias if self.last_frame is not None
                          else np.zeros(6))
        pf.integrate_measurements(accs, gyrs, dts)
        frame.preint_frame = pf
        frame.preint_kf = self.preint_from_kf
        frame.imu_predicted = True

    def predict_state_imu(self) -> bool:
        """PredictStateIMU (Tracking.cpp:194-236)."""
        frame = self.current
        if frame.prev_frame is None:
            return False
        gz = np.float32([0, 0, -GRAVITY_VALUE])
        if self.map_updated and self.last_kf is not None and \
                self.preint_from_kf is not None and self.preint_from_kf.dT > 0:
            kf = self.last_kf
            p = self.preint_from_kf
            Rwb1 = kf.imu_rotation()
            twb1 = kf.imu_position()
            v1 = kf.velocity
            t12 = p.dT
            b = kf.bias
            Rwb2 = Rwb1 @ p.delta_rotation(b)
            twb2 = (twb1 + v1 * t12 + 0.5 * t12 * t12 * gz
                    + Rwb1 @ p.delta_position(b))
            v2 = v1 + gz * t12 + Rwb1 @ p.delta_velocity(b)
            frame.set_imu_pose_velocity(Rwb2, twb2, v2)
            frame.bias = b.copy()
            frame.has_pose = True
            return True
        if not self.map_updated and frame.preint_frame is not None and \
                frame.preint_frame.dT > 0 and self.last_frame is not None \
                and self.last_frame.has_pose:
            lf = self.last_frame
            p = frame.preint_frame
            Rwb1 = lf.imu_rotation()
            twb1 = lf.imu_position()
            v1 = lf.velocity
            t12 = p.dT
            b = lf.bias
            Rwb2 = Rwb1 @ p.delta_rotation(b)
            twb2 = (twb1 + v1 * t12 + 0.5 * t12 * t12 * gz
                    + Rwb1 @ p.delta_position(b))
            v2 = v1 + gz * t12 + Rwb1 @ p.delta_velocity(b)
            frame.set_imu_pose_velocity(Rwb2, twb2, v2)
            frame.bias = b.copy()
            frame.has_pose = True
            return True
        return False

    # ------------------------------------------------------------------
    # monocular initialization (Tracking.cpp:488-731)
    # ------------------------------------------------------------------
    def monocular_initialization(self) -> None:
        frame = self.current
        if not self.ready_to_init:
            if frame.N > 50:
                self.init_frame = frame
                self.last_frame = frame
                # the grid's pixels, as the matcher updates them (kp_un,
                # the JAX package's, is another space on Kannala-Brandt)
                self.prev_matched = frame.kp.copy()
                self.preint_from_kf = self._preint(np.zeros(6))
                frame.preint_kf = self.preint_from_kf
                self.ready_to_init = True
            return
        if frame.N <= 50 or (self.last_frame.timestamp
                             - self.init_frame.timestamp) > 1.0:
            self.ready_to_init = False
            return
        matcher = self.matcher_cls(self.rig.cam, 0.9)
        matches12, n = matcher.search_for_initialization(
            self.init_frame, frame, self.prev_matched, window=50)
        if n < 50:
            self.ready_to_init = False
            return

        # two-view reconstruction on the matched pairs
        pairs = [(i, j) for i, j in enumerate(matches12) if j >= 0]
        ii = np.asarray([i for i, _ in pairs])
        jj = np.asarray([j for _, j in pairs])
        sets = make_ransac_sets(np.arange(len(pairs)), seed=self.n_resets)
        p1, p2, K, sets = _upload(
            [self.init_frame.kp_un[ii].astype(np.float32),
             frame.kp_un[jj].astype(np.float32),
             np.asarray(self.rig.cam.K(), np.float32), sets], self.device)
        res = two_view_reconstruct(p1, p2, torch.ones_like(p1[:, 0],
                                                           dtype=torch.bool),
                                   sets, K)
        ok, R21, t21, X, tri = _fetch(*res)
        if not ok:
            return
        tri = tri > 0.5
        self.init_frame.set_pose(np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32))
        self.init_frame.has_pose = True
        frame.set_pose(R21, t21)
        frame.has_pose = True
        self.create_initial_map(pairs, tri, X)

    def create_initial_map(self, pairs, tri, X) -> None:
        from ..estimator.ba import global_bundle_adjustment

        frame = self.current
        wm = self.map
        kf_ini = KeyFrame(self.init_frame, wm)
        kf_cur = KeyFrame(frame, wm)
        kf_ini.bow_vec, kf_ini.feat_vec = (wm.vocabulary.transform(
            kf_ini.descriptors) if wm.vocabulary else (None, None))
        kf_cur.bow_vec, kf_cur.feat_vec = (wm.vocabulary.transform(
            kf_cur.descriptors) if wm.vocabulary else (None, None))
        wm.add_keyframe(kf_ini)
        wm.add_keyframe(kf_cur)

        for k, (i, j) in enumerate(pairs):
            if not tri[k]:
                continue
            mp = MapPoint(X[k], kf_cur)
            kf_ini.add_map_point(mp, i)
            kf_cur.add_map_point(mp, j)
            mp.add_observation(kf_ini, i)
            mp.add_observation(kf_cur, j)
            mp.compute_distinctive_descriptor()
            mp.update_normal_and_depth()
            frame.map_points[j] = mp
            wm.add_map_point(mp)

        # initial MapEdges + colines on kf_cur (:565-600)
        oc = kf_cur.camera_center()
        for lid, (a, b) in enumerate(kf_cur.key_edges):
            mp1 = kf_cur.get_map_point(int(a))
            mp2 = kf_cur.get_map_point(int(b))
            if mp1 is None or mp2 is None or mp1.is_bad() or mp2.is_bad():
                continue
            v = mp1.pos - mp2.pos
            nv = np.linalg.norm(v)
            v1 = oc - mp1.pos
            v2 = oc - mp2.pos
            if nv < 1e-9:
                continue
            v = v / nv
            c1 = abs(float(v @ v1) / max(np.linalg.norm(v1), 1e-9))
            c2 = abs(float(v @ v2) / max(np.linalg.norm(v2), 1e-9))
            if c1 > MapEdge.view_cos_th or c2 > MapEdge.view_cos_th:
                continue
            me = MapEdge(mp1, mp2)
            me.add_observation(kf_cur, lid)
            kf_cur.add_map_edge(me, lid)
            wm.add_map_edge(me)
        for (piv, a, b) in kf_cur.colines:
            mp = kf_cur.get_map_point(int(piv))
            mp1 = kf_cur.get_map_point(int(a))
            mp2 = kf_cur.get_map_point(int(b))
            if mp is None or mp1 is None or mp2 is None:
                continue
            mc = mp.add_coline(mp1, mp2, kf_cur)
            if mc is not None:
                wm.add_map_coline(mc)

        kf_ini.update_connections()
        kf_cur.update_connections()
        global_bundle_adjustment(wm, iters=20, device=self.device)

        # median-depth rescale to 4 / median (:645-690)
        depths = []
        for mp in kf_ini.map_points:
            if mp is not None:
                depths.append(float(kf_ini.Rcw[2] @ mp.pos + kf_ini.tcw[2]))
        if not depths or kf_cur.tracked_map_points(1) < 50:
            self.reset()
            return
        median_depth = sorted(depths)[(len(depths) - 1) // 2]
        if median_depth < 0:
            self.reset()
            return
        inv_md = 4.0 / median_depth
        kf_cur.set_pose(kf_cur.Rcw, kf_cur.tcw * inv_md)
        for mp in kf_ini.map_points:
            if mp is not None:
                mp.pos = mp.pos * inv_md
                mp.update_normal_and_depth()
        for me in wm.map_edges:
            if not me.is_bad():
                me.check_valid()
        for mp in kf_ini.map_points:
            if mp is not None and not mp.is_bad():
                mp.remove_coline_outliers()

        kf_cur.prev_kf = kf_ini
        kf_ini.next_kf = kf_cur
        kf_cur.preintegrated = self.preint_from_kf
        self.preint_from_kf = self._preint(np.zeros(6))

        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf_ini)
            self.local_mapper.insert_keyframe(kf_cur)

        frame.set_pose(kf_cur.Rcw, kf_cur.tcw)
        self.last_kf = kf_cur
        self.ref_kf = kf_cur
        frame.ref_kf = kf_cur
        self.last_frame = frame
        self.local_keyframes = [kf_cur]
        self.local_points = wm.all_map_points()
        wm.info_map_change()
        self.state = OK

    # ------------------------------------------------------------------
    # frame tracking (Tracking.cpp:752-855)
    # ------------------------------------------------------------------
    def _run_pose_optimization(self, frame: Frame) -> int:
        from ..utils import profiler

        with profiler.timer("tracking.pose_opt"):
            return self._run_pose_optimization_impl(frame)

    def _run_pose_optimization_impl(self, frame: Frame) -> int:
        # The observations of the pose solves (and of relocalization's PnP)
        # are the keypoints in the pixels the camera model projects to,
        # frame.kp: undistorted on the pinhole, distorted on Kannala-Brandt,
        # whose project() applies the fisheye distortion, as the BA and the
        # matcher's projections use them. The JAX package reads kp_un here,
        # which on Kannala-Brandt holds a distorted projection against an
        # undistorted pixel, so most matches there fail the chi2 test and
        # tracking is lost after the init (tests/test_torch_distorted.py).
        matched = [(i, mp) for i, mp in enumerate(frame.map_points)
                   if mp is not None]
        if len(matched) < 3:
            return 0
        X = np.stack([mp.pos for _, mp in matched]).astype(np.float32)
        uv = frame.kp[[i for i, _ in matched]].astype(np.float32)
        Rcw, tcw, X, uv = _upload([np.asarray(frame.Rcw, np.float32),
                                   np.asarray(frame.tcw, np.float32), X, uv],
                                  self.device)
        out = pose_optimization(Rcw, tcw, X, uv,
                                torch.ones_like(X[:, 0], dtype=torch.bool),
                                self.rig.cam)
        # ONE fetch for everything the host reads
        Rf, tf, inl, n_in = _fetch(*out)
        frame.set_pose(Rf, tf)
        frame.has_pose = True
        for k, (i, mp) in enumerate(matched):
            frame.outlier[i] = not inl[k] > 0.5
        return int(n_in)

    def _run_pose_inertial(self, frame: Frame, fix_prev: bool) -> int:
        from ..utils import profiler

        with profiler.timer("tracking.pose_inertial"):
            return self._run_pose_inertial_impl(frame, fix_prev)

    def _run_pose_inertial_impl(self, frame: Frame, fix_prev: bool) -> int:
        from ..utils import profiler

        matched = [(i, mp) for i, mp in enumerate(frame.map_points)
                   if mp is not None]
        # the exact number of matches (at least one row, invalid when
        # nothing matched)
        n = max(len(matched), 1)
        X = np.zeros((n, 3), np.float32)
        uv = np.zeros((n, 2), np.float32)
        valid = np.zeros(n, bool)
        close = np.zeros(n, bool)
        for k, (i, mp) in enumerate(matched):
            X[k] = mp.pos
            uv[k] = frame.kp[i]
            valid[k] = True
            close[k] = 0 < mp.track_depth < 10.0

        def state(R, t, v, bias):
            return [R, t, v, bias[:3], bias[3:]]

        if fix_prev:
            src = self.last_kf
            p = self.preint_from_kf
            prior = [np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3),
                     np.zeros(3), np.zeros((15, 15))]
            prior_valid = False
        else:
            src = self.last_frame
            p = frame.preint_frame
            if src.prior is not None:
                pr = src.prior
                prior = [pr["R"], pr["t"], pr["v"], pr["bg"], pr["ba"],
                         pr["H"]]
            else:
                prior = state(src.imu_rotation(), src.imu_position(),
                              src.velocity, src.bias) + [np.eye(15) * 1e2]
            prior_valid = True
        prev = state(src.imu_rotation(), src.imu_position(), src.velocity,
                     src.bias)
        if p is None or p.dT <= 0:
            return self._run_pose_optimization(frame)
        st = p.state
        C = np.asarray(st.C, np.float64)
        preint = [st.dR, st.dV, st.dP, st.JRg, st.JVg, st.JVa, st.JPg,
                  st.JPa, p.b, _sqrtm_psd_inv(C[:9, :9]),
                  _sqrtm_psd_inv(C[9:12, 9:12]),
                  _sqrtm_psd_inv(C[12:15, 12:15]), np.float32(st.dT)]
        curr = state(frame.imu_rotation(), frame.imu_position(),
                     frame.velocity, frame.bias)
        replay = self._pose_inertial_replay(n)
        if replay is not None:
            c, inlier, n_in, new_prior = replay(
                curr, prev, preint, prior, prior_valid, X, uv, valid, close,
                self.rig.Rcb, self.rig.tcb, fix_prev=fix_prev)
        else:
            host = curr + prev + preint + prior + [X, uv, self.rig.Rcb,
                                                   self.rig.tcb]
            dev = _upload([np.asarray(a, np.float32) for a in host] + [
                valid, close, np.asarray(prior_valid)], self.device)
            curr, prev = FrameVIState(*dev[:5]), FrameVIState(*dev[5:10])
            preint = PreintData(*dev[10:23])
            prior = Prior15(*dev[23:29], valid=dev[35])
            X, uv, Rcb, tcb, valid, close = dev[29:35]
            c, inlier, n_in, new_prior = pose_inertial_optimization(
                curr, prev, preint, prior, X, uv, valid, close, Rcb, tcb,
                self.rig.cam, fix_prev=fix_prev)
        # ONE fetch for everything the host reads below
        R, t, v, bg, ba, inl, n_in, prior_H = _fetch(*c, inlier, n_in,
                                                     new_prior.H)
        # a non-finite prior makes the next call's eigh raise
        profiler.count("pose_inertial.prior_nonfinite",
                       int(not np.isfinite(prior_H).all()))
        frame.set_imu_pose_velocity(R, t, v)
        frame.bias = np.concatenate([bg, ba])
        frame.has_pose = True
        frame.prior = dict(R=R, t=t, v=v, bg=bg, ba=ba, H=prior_H)
        for k, (i, mp) in enumerate(matched):
            frame.outlier[i] = not inl[k] > 0.5
        return int(n_in)

    def _pose_inertial_replay(self, n: int):
        """The CUDA-graph replay of pose_inertial_optimization for a call
        with n observations, or None: on the CPU, and past the capacity, the
        extractor's keypoint cap (a frame's matches are at most its
        keypoints), which is counted ("pose_inertial.eager")."""
        from ..ops.nms import MAX_KEYPOINTS
        from ..utils import profiler

        if self.device.type != "cuda":
            return None
        if self._pose_replay is None:
            self._pose_replay = PoseInertialReplay(
                self.rig.cam, getattr(self.extractor, "max_kp",
                                      MAX_KEYPOINTS), self.device)
        if n > self._pose_replay.capacity:
            profiler.count("pose_inertial.eager")
            return None
        return self._pose_replay

    def track_reference_keyframe(self) -> bool:
        frame = self.current
        # The first frame after resume_from_map has no last frame to start
        # the pose from (the JAX package reads last_frame.Rcw and raises
        # there); it fails here and goes to relocalization.
        if self.ref_kf is None or self.last_frame is None:
            return False
        if frame.bow_vec is None and self.map.vocabulary is not None:
            frame.bow_vec, frame.feat_vec = self.map.vocabulary.transform(
                frame.descriptors)
        matcher = self.matcher_cls(self.rig.cam, 0.7)
        matches, n = matcher.search_by_bow_kf_frame(self.ref_kf, frame)
        if n < 15:
            return False
        frame.map_points = matches
        frame.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        frame.has_pose = True
        self._run_pose_optimization(frame)
        n_map = 0
        for i in range(frame.N):
            if frame.map_points[i] is not None:
                if frame.outlier[i]:
                    mp = frame.map_points[i]
                    frame.map_points[i] = None
                    frame.outlier[i] = False
                    mp.track_in_view = False
                elif frame.map_points[i].n_observations() > 0:
                    n_map += 1
        # NOTE: the reference never increments its inlier counter here
        # (Tracking.cpp:766-781 always returns false); we count properly.
        return n_map >= 10

    def track_with_motion_model(self) -> bool:
        frame = self.current
        if self.velocity is None:
            return False
        matcher = self.matcher_cls(self.rig.cam, 0.9)
        Rv, tv = self.velocity
        frame.set_pose(Rv @ self.last_frame.Rcw,
                       Rv @ self.last_frame.tcw + tv)
        frame.has_pose = True
        frame.map_points = [None] * frame.N
        th = 15
        from ..utils import profiler

        with profiler.timer("tracking.match"):
            # ONE device match with the WIDE (2*th) gate serves both
            # passes: the matcher's spatial gate is the host-side
            # features_in_area(th) window, and the device rows are only
            # consulted at those indices — a wide-rect row is a superset,
            # so the narrow pass reads identical distances (up to the
            # per-query K-cap, counted in rows.overflow)
            dists = self._device_rows_for_last_frame(frame, 2 * th)
            n = matcher.search_by_projection_last_frame(
                frame, self.last_frame, th, dists=dists)
            if n < 20:
                frame.map_points = [None] * frame.N
                n = matcher.search_by_projection_last_frame(
                    frame, self.last_frame, 2 * th, dists=dists)
        if n < 20:
            return False
        self._run_pose_optimization(frame)
        n_map = 0
        for i in range(frame.N):
            if frame.map_points[i] is not None:
                if frame.outlier[i]:
                    mp = frame.map_points[i]
                    frame.map_points[i] = None
                    frame.outlier[i] = False
                    mp.track_in_view = False
                elif frame.map_points[i].n_observations() > 0:
                    n_map += 1
                    frame.map_points[i].tracked_by_frame = frame.mnId
        return n_map >= 10

    # ------------------------------------------------------------------
    # local map tracking (Tracking.cpp:856-1008)
    # ------------------------------------------------------------------
    def track_local_map(self) -> bool:
        from ..utils import profiler

        with profiler.timer("tracking.local_map"):
            return self._track_local_map_impl()

    def _track_local_map_impl(self) -> bool:
        frame = self.current
        self.update_local_map()
        self.search_local_points()
        if not self.map.imu_initialized or \
                frame.mnId <= self.last_reloc_frame_id + self.rig.cam.fps:
            self._run_pose_optimization(frame)
        else:
            self._run_pose_inertial(frame, fix_prev=self.map_updated)
        self.matches_inliers = 0
        for i in range(frame.N):
            mp = frame.map_points[i]
            if mp is not None and not frame.outlier[i]:
                mp.increase_found()
                if mp.n_observations() > 0:
                    self.matches_inliers += 1
        if frame.mnId < self.last_reloc_frame_id + self.rig.cam.fps and \
                self.matches_inliers < 20:
            return False
        if self.matches_inliers > 10 and self.state == RECENTLY_LOST:
            return True
        if (self.matches_inliers < 5 and self.map.imu_initialized) or \
                (self.matches_inliers < 20 and not self.map.imu_initialized):
            return False
        return True

    def update_local_map(self) -> None:
        frame = self.current
        counter = {}
        src = frame if (not self.map.imu_initialized
                        or frame.mnId < self.last_reloc_frame_id + 2) \
            else self.last_frame
        for i in range(src.N):
            mp = src.map_points[i]
            if mp is not None and not mp.is_bad():
                for kf in mp.observations:
                    counter[kf] = counter.get(kf, 0) + 1
            elif mp is not None:
                src.map_points[i] = None
        self.local_keyframes = []
        seen = set()
        for kf, cnt in counter.items():
            if not kf.is_bad():
                self.local_keyframes.append(kf)
                seen.add(kf.mnId)
        base = list(self.local_keyframes)
        for kf in base:
            if len(self.local_keyframes) > 80:
                break
            for nb in kf.get_best_covisibility_keyframes(10):
                if not nb.is_bad() and nb.mnId not in seen:
                    self.local_keyframes.append(nb)
                    seen.add(nb.mnId)
                    break
        if len(self.local_keyframes) < 80:
            kf = self.last_kf
            for _ in range(20):
                if kf is None:
                    break
                if kf.mnId not in seen and not kf.is_bad():
                    self.local_keyframes.append(kf)
                    seen.add(kf.mnId)
                kf = kf.prev_kf
        # local points
        self.local_points = []
        pseen = set()
        for kf in reversed(self.local_keyframes):
            for mp in kf.map_points:
                if mp is not None and not mp.is_bad() and \
                        mp.mnId not in pseen:
                    pseen.add(mp.mnId)
                    self.local_points.append(mp)

    def search_local_points(self) -> None:
        from ..utils import profiler

        with profiler.timer("tracking.match"):
            self._search_local_points_impl()

    def _search_local_points_impl(self) -> None:
        frame = self.current
        frame.check_in_frustum_batch(
            [mp for mp in self.local_points if not mp.is_bad()], 0.5)
        matcher = self.matcher_cls(self.rig.cam, 0.8)
        th = 10
        if self.map.imu_initialized:
            th = 3 if self.map.inertial_ba1 else 6
        if frame.mnId < self.last_reloc_frame_id + 2:
            th = 5
        if self.state in (LOST, RECENTLY_LOST):
            th = 15
        dists = self._device_rows_for_extend(frame, self.local_points, th)
        matcher.extend_map_matches(frame, self.local_points, th, dists=dists)

    # -- device-side gated matching (matching/device_match.py) ----------
    def _get_device_matcher(self):
        if self._dev_matcher is None:
            from ..matching.device_match import DeviceMatcher

            self._dev_matcher = DeviceMatcher(device=self.device)
        return self._dev_matcher

    def _device_rows_for_extend(self, frame, points, th):
        """Gate queries for extend_map_matches: anchors use the matcher's
        exact per-point window (radius th * 2.5/4.0 around the frustum
        projection); PPG seed-growing partners (2 edge hops) get a wide
        window around their own projection — growth pairs the reference
        accepts ungated land within it unless they would be pose-opt
        outliers anyway. Returns None (host dense matching) when the frame
        descriptors were transferred to host."""
        if frame.feats.desc_dev is None:
            return None
        from ..utils import profiler

        with profiler.timer("tracking.device_match"):
            dm = self._get_device_matcher()
            queries = []
            anchors = []
            for mp in points:
                if mp.is_bad() or not mp.track_in_view:
                    continue
                r = th * (2.5 if mp.track_view_cos > 0.998 else 4.0)
                queries.append((mp, mp.track_proj_x, mp.track_proj_y, r))
                anchors.append(mp)
            seen = {mp.mnId for mp in anchors}
            partners = []
            # growth pairs only the ANCHOR's edge star (matcher growth
            # semantics, Matcher.cpp:295-303) -> 1 hop of partners suffices
            for mp in anchors:
                for me in mp.get_edges():
                    if me.is_bad() or not me.valid:
                        continue
                    o = me.the_other_pt(mp)
                    if o is None or o.is_bad() or o.mnId in seen:
                        continue
                    seen.add(o.mnId)
                    partners.append(o)
            r_grow = max(15.0, 8.0 * th)
            if partners:
                X = np.stack([o.pos for o in partners])
                Xc = X @ frame.Rcw.T + frame.tcw
                uvs = self.rig.cam.project_np(Xc)
                for o, zc, uv in zip(partners, Xc[:, 2], uvs):
                    if zc <= 0:
                        continue
                    queries.append((o, float(uv[0]), float(uv[1]), r_grow))
            dm.ensure_bank([q[0] for q in queries])
            return dm.gated_rows(frame, queries)

    def _device_rows_for_last_frame(self, frame, th):
        """Gate queries mirroring search_by_projection_last_frame's windows
        (radius = th around each last-frame point's projection)."""
        if frame.feats.desc_dev is None:
            return None
        from ..utils import profiler

        last = self.last_frame
        with profiler.timer("tracking.device_match"):
            dm = self._get_device_matcher()
            mps = [mp for i, mp in enumerate(last.map_points)
                   if mp is not None and not last.outlier[i]]
            if not mps:
                return None
            X = np.stack([mp.pos for mp in mps])
            Xc = X @ frame.Rcw.T + frame.tcw
            uvs = self.rig.cam.project_np(Xc)
            queries = [(mp, float(uv[0]), float(uv[1]), float(th))
                       for mp, zc, uv in zip(mps, Xc[:, 2], uvs) if zc > 0]
            dm.ensure_bank([q[0] for q in queries])
            return dm.gated_rows(frame, queries)

    # ------------------------------------------------------------------
    # keyframe policy (Tracking.cpp:913-972)
    # ------------------------------------------------------------------
    def need_new_keyframe(self) -> bool:
        # The reference policy is PURE timing + mapper-idle
        # (Tracking.cpp:913-941) — deliberately NO inlier gate: keyframes
        # created while RECENTLY_LOST (coasting on IMU, Track():431) carry
        # fresh detections at IMU-predicted poses, and IncreMap's epipolar
        # triangulation between consecutive coasting KFs is exactly how
        # unmapped territory gets mapped so tracking can re-acquire. An r4
        # inlier>=15 gate here made insert_kfs_lost dead code and the r5
        # live corridor unrecoverable after its 180-deg turns (inl=0 for
        # 5 s, KFs frozen, LOST).
        lm = self.local_mapper
        urgent = self.state == RECENTLY_LOST and self.map.imu_initialized
        if lm is not None and not lm.accepts_keyframe_now(urgent=urgent):
            # policy rationale (incl. the documented divergence from the
            # reference's skip-while-busy gate) lives in
            # LocalMapping.accepts_keyframe_now
            return False
        if self.last_kf is None:
            return True
        return (self.current.timestamp - self.last_kf.timestamp) >= 0.1

    def create_new_keyframe(self) -> None:
        from ..utils import profiler

        with profiler.timer("tracking.keyframe"):
            self._create_new_keyframe_impl()

    def _create_new_keyframe_impl(self) -> None:
        frame = self.current
        wm = self.map
        kf = KeyFrame(frame, wm)
        if wm.vocabulary is not None:
            kf.bow_vec, kf.feat_vec = wm.vocabulary.transform(kf.descriptors)
        kf.bias = frame.bias.copy()
        self.ref_kf = kf
        frame.ref_kf = kf
        if self.last_kf is not None:
            kf.prev_kf = self.last_kf
            self.last_kf.next_kf = kf
        kf.preintegrated = self.preint_from_kf
        matcher = self.matcher_cls(self.rig.cam, 0.6)
        wm.incre_map(kf, matcher)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.preint_from_kf = self._preint(kf.bias)
        self.last_kf = kf

    # ------------------------------------------------------------------
    # IMU initialization (Tracking.cpp:1479-1742)
    # ------------------------------------------------------------------
    def _temporal_keyframes(self) -> List[KeyFrame]:
        if self.last_kf is None:
            return []
        out = [self.last_kf]
        while out[-1].prev_kf is not None:
            out.append(out[-1].prev_kf)
        out.reverse()
        return out

    def initialize_imu(self, prior_g: float, prior_a: float,
                       fiba: bool) -> None:
        from ..utils import profiler

        wm = self.map
        if wm.n_keyframes() < 10:
            return
        kfs = self._temporal_keyframes()
        if len(kfs) < 10:
            return
        if self.last_kf.timestamp - kfs[0].timestamp < \
                self.min_init_window_s:
            return
        with profiler.timer("tracking.imu_init"):
            self._initialize_imu_window(kfs, prior_g, prior_a, fiba)

    def _initialize_imu_window(self, kfs, prior_g: float, prior_a: float,
                               fiba: bool) -> None:
        """initialize_imu past its gates, over the temporal window kfs."""
        from ..estimator.ba import full_inertial_ba
        from ..estimator.inertial_init import inertial_optimization
        from ..geometry import so3
        from ..utils import profiler

        wm = self.map
        if not wm.imu_initialized:
            # Pre-init visual consolidation (r5): the closed-form gravity/
            # scale estimator assumes locally-CONVERGED keyframe poses —
            # the reference's real-time g2o mapper guarantees that; our
            # consumer thread under a slow link skips/aborts LBAs (bounded
            # drought), leaving pre-init poses noisy, and the estimator's
            # attenuation bias grows with exactly that pose noise
            # (measured: threaded first-init scales 0.43-0.74 on data
            # where synchronous-mapper runs estimate 0.996). One short
            # visual-only GBA over the <=25-KF pre-init map equalizes
            # pose quality regardless of the worker's backlog state —
            # it is also the r4 #4 threaded-vs-serial variance killer at
            # the moment it matters most.
            from ..estimator.ba import global_bundle_adjustment

            global_bundle_adjustment(wm, iters=15,
                                     map_lock=wm.update_lock,
                                     device=self.device)
            dir_g = np.zeros(3, np.float64)
            for kf in kfs:
                if kf.preintegrated is None or kf.prev_kf is None:
                    continue
                dir_g -= kf.prev_kf.imu_rotation() @ \
                    kf.preintegrated.delta_velocity()
                vel = (kf.imu_position() - kf.prev_kf.imu_position()) \
                    / max(kf.preintegrated.dT, 1e-6)
                kf.velocity = vel.astype(np.float32)
                kf.prev_kf.velocity = vel.astype(np.float32)
            nrm = np.linalg.norm(dir_g)
            if nrm < 1e-8:
                Rwg = np.eye(3, dtype=np.float32)
            else:
                dir_g = dir_g / nrm
                gI = np.float64([0, 0, -1])
                v = np.cross(gI, dir_g)
                nv = np.linalg.norm(v)
                ang = np.arccos(np.clip(gI @ dir_g, -1, 1))
                if nv < 1e-8:
                    Rwg = np.eye(3, dtype=np.float32)
                else:
                    Rwg = so3.exp(
                        (v * ang / nv).astype(np.float32)).astype(np.float32)
        else:
            Rwg = np.eye(3, dtype=np.float32)

        prob, states = self._build_inertial_init_problem(kfs)
        if prob is None:
            return
        R, t, v, bg0, ba0, Rwg0, s0 = _upload(
            list(states) + [np.asarray(a, np.float32) for a in (
                self.last_kf.bias[:3], self.last_kf.bias[3:], Rwg, 1.0)],
            self.device)
        out = inertial_optimization(
            R, t, v, bg0, ba0, Rwg0, s0, prob, prior_g=float(prior_g),
            prior_a=float(prior_a), iters=60)
        # ONE fetch for everything the host reads below
        v_f, bg, ba, Rwg_f, scale, hist = _fetch(*out)
        scale = float(scale)
        first_init = not wm.imu_initialized
        # FULL-OBJECTIVE acceptance gate on the whole-map transform (r5,
        # VERDICT r4 #2): the closed-form init estimator was measured
        # applying 0.29-0.50x scale collapses on the live corridor via
        # this (previously ungated) VIBA1 path, stalling KF creation for
        # the whole return leg. First init applies UNCONDITIONALLY — the
        # monocular map has no metric scale yet, so there is nothing to
        # "worsen" (reference semantics, Tracking.cpp:1479-1695); later
        # passes (VIBA1/VIBA2) must not be allowed to collapse an
        # already-metric map, so the candidate is checked against the
        # total visual-inertial chi2 exactly like scale_refinement's.
        # SCALE-TRIM policy (r5, deliberate divergence from the
        # reference's unconditional apply — documented from instrumented
        # live captures): the closed-form scale estimate is attenuation-
        # biased near the visual noise floor, and the bias contaminates
        # the whitened objective itself, so neither the estimate nor a
        # full-objective gate can referee LARGE corrections (measured:
        # first-init 0.657 applied onto a 0.97-of-metric map; VIBA1
        # 0.316 where truth was x1.75, gate-approved). The estimator is
        # therefore treated as a TRIM instrument: scale applies only
        # inside the log-symmetric band [0.7, 1.43] — on identifiable
        # data a genuinely-off gauge converges through repeated in-band
        # trims (init + VIBA1/2 + refine every 20 KFs compound to >3x),
        # while on degenerate data the map keeps its current consistent
        # gauge, the stable failure mode. The gravity ROTATION (reliably
        # estimated) applies in full either way on first init.
        apply_ok = (scale >= 1e-1
                    and _trim_accepts(scale, self._applied_scale_cum))
        c0 = c1 = None
        if (apply_ok and not first_init and abs(scale - 1.0) > 1e-5
                and not _small_transform(Rwg_f, scale)):
            from ..estimator.ba import whole_map_transform_gain

            gain = whole_map_transform_gain(wm, Rwg_f.T, scale,
                                            device=self.device)
            if gain is not None:
                c0, c1 = gain
                apply_ok = c1 <= c0 * 1.001
        ev = dict(t=float(self.last_kf.timestamp),
                  kind=("init" if first_init else "viba1"),
                  scale=scale, n_kfs=len(kfs), applied=apply_ok,
                  chi2_first=float(hist[0]), chi2_last=float(hist[-1]),
                  gate_c0=c0, gate_c1=c1,
                  bg=np.asarray(bg).tolist() if scale >= 1e-1 else None)
        self.init_events.append(ev)
        if self.on_map_event is not None:
            self.on_map_event(ev)
        if scale < 1e-1:
            return
        vf = np.asarray(v_f)
        if apply_ok:
            # apply: rotate gravity to -z, rescale
            if abs(scale - 1.0) > 1e-5:
                wm.apply_scaled_rotation(Rwg_f.T, scale, scale_vel=True)
                self._update_frame_imu(scale)
                self._applied_scale_cum *= float(scale)
            vels = (vf @ Rwg_f) * scale  # rows Rwg_f.T @ vf[i] * scale
        elif first_init:
            # scale refused (outside the trim band) but this is the FIRST
            # init: the gravity rotation is reliably estimated and the
            # whole inertial pipeline needs gravity at -z — apply the
            # ROTATION alone and leave the scale at the current gauge
            wm.apply_scaled_rotation(Rwg_f.T, 1.0, scale_vel=True)
            self._update_frame_imu(1.0)
            vels = vf @ Rwg_f
        else:
            # transform refused: velocities were estimated in the CURRENT
            # world frame — write them back unrotated/unscaled so the map
            # stays self-consistent; FIBA below still repairs via its
            # conformal interleave
            vels = vf
        bias = np.concatenate([np.asarray(bg), np.asarray(ba)]).astype(
            np.float32)
        for i, kf in enumerate(kfs):
            kf.velocity = vels[i].astype(np.float32)
            kf.bias = bias.copy()
            if kf.preintegrated is not None:
                kf.preintegrated.set_new_bias(bias)
                kf.preintegrated.reintegrate()
        wm.imu_initialized = True
        if fiba:
            with profiler.timer("tracking.full_inertial_ba"):
                full_inertial_ba(wm, iters=100, loop_kf=0,
                                 b_init=(prior_a != 0), prior_g=prior_g,
                                 prior_a=prior_a,
                                 conformal_shrink_cum=0.6 if first_init
                                 else 1.0, device=self.device)
        # whole-map transform: invalidate any in-flight threaded local BA
        # (the reference RequestStops local mapping around InitializeIMU,
        # Tracking.cpp:1509)
        wm.bump_transform_epoch()
        wm.info_map_change()
        if first_init:
            self.t_init = 0.0

    def _build_inertial_init_problem(self, kfs):
        from ..estimator.inertial_init import InertialInitProblem

        links = []
        for kf in kfs:
            if kf.prev_kf is None or kf.preintegrated is None:
                continue
            links.append(kf)
        if len(links) < 3:
            return None, None
        idx = {kf.mnId: i for i, kf in enumerate(kfs)}
        L = len(links)
        data = dict(kf1=[], kf2=[], dR=[], dV=[], dP=[], JRg=[], JVg=[],
                    JVa=[], JPg=[], JPa=[], b0=[], sqi=[], dt=[])
        for kf in links:
            st = kf.preintegrated.state
            C = np.asarray(st.C, np.float64)
            data["kf1"].append(idx[kf.prev_kf.mnId])
            data["kf2"].append(idx[kf.mnId])
            data["dR"].append(np.asarray(st.dR))
            data["dV"].append(np.asarray(st.dV))
            data["dP"].append(np.asarray(st.dP))
            data["JRg"].append(np.asarray(st.JRg))
            data["JVg"].append(np.asarray(st.JVg))
            data["JVa"].append(np.asarray(st.JVa))
            data["JPg"].append(np.asarray(st.JPg))
            data["JPa"].append(np.asarray(st.JPa))
            data["b0"].append(kf.preintegrated.b.copy())
            data["sqi"].append(_sqrtm_psd_inv(C[:9, :9]))
            data["dt"].append(np.float32(st.dT))
        # the exact state and link counts (the reference's pow2 buckets are
        # an XLA workaround)
        host = [np.asarray(data["kf1"], np.int64),
                np.asarray(data["kf2"], np.int64)] + [
            np.stack(data[k]).astype(np.float32)
            for k in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
                      "b0", "sqi", "dt")] + [np.ones(L, bool)]
        prob = InertialInitProblem(*_upload(host, self.device))
        R = np.stack([kf.imu_rotation() for kf in kfs]).astype(np.float32)
        t = np.stack([kf.imu_position() for kf in kfs]).astype(np.float32)
        v = np.stack([kf.velocity for kf in kfs]).astype(np.float32)
        return prob, (R, t, v)

    def _update_frame_imu(self, scale: float) -> None:
        """UpdateFrameIMU (Tracking.cpp:1401-...): rescale the relative-pose
        trajectory log and refresh the last frame's IMU state."""
        self.rel_poses = [(R, t * scale) for (R, t) in self.rel_poses]
        if self.last_frame is None:
            return
        lf = self.last_frame
        if lf.preint_kf is not None and self.last_kf is not None \
                and lf.preint_kf.dT > 0:
            gz = np.float32([0, 0, -GRAVITY_VALUE])
            kf = self.last_kf
            p = lf.preint_kf
            Rwb1 = kf.imu_rotation()
            twb1 = kf.imu_position()
            v1 = kf.velocity
            t12 = p.dT
            lf.set_imu_pose_velocity(
                Rwb1 @ p.delta_rotation(),
                twb1 + v1 * t12 + 0.5 * t12 * t12 * gz
                + Rwb1 @ p.delta_position(),
                v1 + gz * t12 + Rwb1 @ p.delta_velocity())

    def scale_refinement(self) -> None:
        from ..estimator.inertial_init import inertial_optimization

        kfs = self._temporal_keyframes()
        if len(kfs) < 5:
            return
        prob, states = self._build_inertial_init_problem(kfs)
        if prob is None:
            return
        z3 = np.zeros(3, np.float32)
        R, t, v, bg0, ba0, Rwg0, s0 = _upload(
            list(states) + [z3, z3, np.eye(3, dtype=np.float32),
                            np.float32(1.0)], self.device)
        out = inertial_optimization(
            R, t, v, bg0, ba0, Rwg0, s0, prob, prior_g=0.0, prior_a=0.0,
            fix_vel_bias=True, iters=30)
        _, _, _, Rwg_f, scale, hist = _fetch(*out)
        scale = float(scale)
        applied = False
        c0 = c1 = None
        if scale >= 1e-1 and abs(scale - 1.0) > 0.002:
            # FULL-OBJECTIVE acceptance gate (r4/r5): the velocities-fixed
            # closed-form estimator is attenuation-biased near the visual
            # noise floor and was measured applying a gravity-rotation +
            # scale that exploded the whitened inertial chi2 from 2.6e4
            # to 2.1e8 on a live corridor (a wrong ROTATION is then
            # unrepairable by any scale-only search). LARGE candidate
            # transforms are therefore checked against the total
            # visual-inertial chi2 and refused if they worsen it. SMALL
            # candidates (<=5% scale, <=2 deg rotation) apply
            # unconditionally, reference semantics (ScaleRefinement,
            # Tracking.cpp:1701-1742): they are bounded-impact annealing
            # corrections, and the r4 strict gate was measured refusing
            # the tiny gravity re-alignment the frozen pre-init map
            # segment needs — later KFs get pulled to TRUE gravity by
            # inertial tracking while the early segment keeps its
            # init-time error, so a ~1 deg relative pitch offset builds
            # up across the map and the loop-closure yaw-only gate
            # (roll/pitch < 0.008 rad) rejects every loop (r5 bisect of
            # the red test_loop_closing fixture).
            Rwg_f = np.asarray(Rwg_f, np.float32)
            if _small_transform(Rwg_f, scale):
                accept = True
            elif not _trim_accepts(scale, self._applied_scale_cum):
                # scale-TRIM band (r5): the serial live corridor showed a
                # 0.228x refine estimate PASSING the full-objective gate —
                # near the visual noise floor the attenuation bias
                # contaminates the whitened objective itself, so the gate
                # agrees with the biased optimum and s_align collapsed to
                # 0.45 (ATE 2.65 m). ScaleRefinement runs every 20 KFs on
                # an already-metric map: a beyond-trim "correction" there
                # means the velocities-fixed estimator is degenerate, not
                # that the scale is that far off (see the initialize_imu
                # policy comment). Refuse.
                accept = False
            else:
                from ..estimator.ba import whole_map_transform_gain

                gain = whole_map_transform_gain(self.map, Rwg_f.T, scale,
                                                device=self.device)
                if gain is None:
                    accept = True  # too small to evaluate: ref semantics
                else:
                    c0, c1 = gain
                    accept = c1 <= c0 * 1.001
            if accept:
                self.map.apply_scaled_rotation(Rwg_f.T, scale,
                                               scale_vel=True)
                self._update_frame_imu(scale)
                self._applied_scale_cum *= float(scale)
                applied = True
        ev = dict(t=float(self.last_kf.timestamp), kind="refine",
                  scale=scale, n_kfs=len(kfs), applied=applied,
                  chi2_first=float(hist[0]), chi2_last=float(hist[-1]),
                  gate_c0=c0, gate_c1=c1)
        self.init_events.append(ev)
        if self.on_map_event is not None:
            self.on_map_event(ev)
        if scale < 1e-1:
            return
        # full-objective conformal correction (r4): the closed-form
        # velocities-fixed estimator above is attenuation-biased when the
        # per-link curvature signal sits near the visual noise floor
        # (measured dragging live corridor runs toward scale collapse);
        # re-optimize the one-dimensional scale mode against the TOTAL
        # visual-inertial chi2 and apply the difference.
        from ..estimator.ba import conformal_scale_refine

        # live path: trim band + cumulative shrink budget (see the
        # initialize_imu policy comment) — the default wider band is for
        # deliberate offline repair of a known-misscaled map
        s_conf = conformal_scale_refine(
            self.map,
            lo=max(SCALE_TRIM_LO,
                   SCALE_SHRINK_BUDGET / self._applied_scale_cum),
            hi=SCALE_TRIM_HI, device=self.device)
        if abs(s_conf - 1.0) > 1e-3:
            self._update_frame_imu(s_conf)
            self._applied_scale_cum *= float(s_conf)
        ev2 = dict(t=float(self.last_kf.timestamp), kind="conformal",
                   scale=s_conf, n_kfs=len(kfs),
                   applied=abs(s_conf - 1.0) > 1e-3)
        self.init_events.append(ev2)
        if self.on_map_event is not None:
            self.on_map_event(ev2)
        self.map.info_map_change()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """System reset (Tracking.cpp:1351-1384): clear the map and state."""
        self.n_resets += 1
        wm = self.map
        wm.bump_transform_epoch()  # drop any in-flight threaded local BA
        wm.keyframes.clear()
        wm.map_points.clear()
        wm.map_edges.clear()
        wm.map_colines.clear()
        wm.recent_map_points.clear()
        wm.inverted_file.clear()
        wm.kf_origin = None
        wm.imu_initialized = False
        wm.inertial_ba1 = False
        wm.inertial_ba2 = False
        self.state = NO_IMAGES_YET
        self.last_kf = None
        self.ref_kf = None
        self.last_frame = None
        self.init_frame = None
        self.ready_to_init = False
        self.velocity = None
        self.t_init = 0.0
        self._applied_scale_cum = 1.0
        self.preint_from_kf = None
        from ..worldmap import reset_ids
        reset_ids()  # reference: KeyFrame/Frame::nNextId = 0 (:1364-1365)
        if self.local_mapper is not None:
            self.local_mapper.reset()


def _sqrtm_psd_inv(M: np.ndarray) -> np.ndarray:
    """sqrt of the PSD-projected inverse (whitening factor)."""
    M = 0.5 * (M + M.T)
    info = np.linalg.inv(M + 1e-14 * np.eye(len(M)))
    w, V = np.linalg.eigh(0.5 * (info + info.T))
    w = np.clip(w, 0, None)
    return ((V * np.sqrt(w)) @ V.T).astype(np.float32)
