"""Frame and KeyFrame.

Copy of ppg_slam_tpu/worldmap/frame.py over the port's FrameFeatures.

Host mirrors of the reference PPG-SLAM C++ sources map/Frame.* and
feature/KeyFrame.*. Poses are stored as world-to-camera (Rcw, tcw) numpy pairs; IMU state as body pose
(derived via the rig extrinsics), velocity and bias — matching the reference's
GetPose/GetImuPose split (KeyFrame.h:38-241, Frame.h:42-236).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np

from ..frontend.extractor import FrameFeatures
from ..geometry.cameras import CameraModel
from .elements import MapEdge, MapPoint
from .grid import FeatureGrid, image_bounds

_frame_ids = itertools.count()
_kf_ids = itertools.count()


def reset_frame_ids() -> None:
    """Reset the global Frame/KeyFrame id counters (the reference does
    KeyFrame::nNextId = 0; Frame::nNextId = 0 on system reset,
    Tracking.cpp:1364-1365)."""
    global _frame_ids, _kf_ids
    _frame_ids = itertools.count()
    _kf_ids = itertools.count()


class Rig:
    """Camera + IMU extrinsics (reference IMU::Calib Tbc, System.cpp:85-98)."""

    __slots__ = ("cam", "Rbc", "tbc", "Rcb", "tcb", "nga", "nga_walk", "freq")

    def __init__(self, cam: CameraModel, Tbc: np.ndarray = None,
                 noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5,
                 walk_acc=3e-3, freq=200.0):
        self.cam = cam
        Tbc = np.eye(4, dtype=np.float32) if Tbc is None else np.asarray(
            Tbc, np.float32)
        self.Rbc = Tbc[:3, :3].copy()
        self.tbc = Tbc[:3, 3].copy()
        self.Rcb = self.Rbc.T.copy()
        self.tcb = (-self.Rbc.T @ self.tbc).astype(np.float32)
        sf = np.sqrt(freq)
        self.nga = np.array([(noise_gyro * sf) ** 2] * 3
                            + [(noise_acc * sf) ** 2] * 3, np.float32)
        self.nga_walk = np.array([(walk_gyro / sf) ** 2] * 3
                                 + [(walk_acc / sf) ** 2] * 3, np.float32)
        self.freq = freq


class PoseState:
    """Shared pose/IMU state logic for Frame and KeyFrame."""

    def set_pose(self, Rcw: np.ndarray, tcw: np.ndarray) -> None:
        self.Rcw = np.asarray(Rcw, np.float32).copy()
        self.tcw = np.asarray(tcw, np.float32).copy()
        self._cc = None

    def camera_center(self) -> np.ndarray:
        # cached: hot in per-frame frustum checks and per-point
        # normal/depth updates (invalidated by every pose setter)
        cc = getattr(self, "_cc", None)
        if cc is None:
            cc = self._cc = (-self.Rcw.T @ self.tcw).astype(np.float32)
        return cc

    # -- IMU (body) pose -----------------------------------------------------
    def set_imu_pose_velocity(self, Rwb, twb, v) -> None:
        """Reference SetImuPoseVelocity: set body pose + velocity, derive Tcw
        via the rig extrinsics (Tcw = Tcb * Tbw)."""
        Rwb = np.asarray(Rwb, np.float32)
        twb = np.asarray(twb, np.float32)
        rig = self.rig
        Rbw = Rwb.T
        tbw = -Rbw @ twb
        self.Rcw = (rig.Rcb @ Rbw).astype(np.float32)
        self.tcw = (rig.Rcb @ tbw + rig.tcb).astype(np.float32)
        self._cc = None
        self.velocity = np.asarray(v, np.float32).copy()

    def imu_rotation(self) -> np.ndarray:
        """Rwb = (Rcb Rbw)^T ... = Rwc Rcb^T? Tbw = Tbc * Tcw."""
        rig = self.rig
        Rbw = rig.Rbc @ self.Rcw
        return Rbw.T.astype(np.float32)

    def imu_position(self) -> np.ndarray:
        rig = self.rig
        tbw = rig.Rbc @ self.tcw + rig.tbc
        Rbw = rig.Rbc @ self.Rcw
        return (-Rbw.T @ tbw).astype(np.float32)


class Frame(PoseState):
    """Per-image frame (reference map/Frame.*)."""

    def __init__(self, feats: FrameFeatures, timestamp: float, rig: Rig):
        self.mnId = next(_frame_ids)
        self.timestamp = timestamp
        self.rig = rig
        self.feats = feats
        self.N = feats.n_kp
        self.kp = feats.kp_pos            # mPos (== undistorted for pinhole)
        self.kp_un = feats.kp_pos_un      # mPosUn
        self._descriptors = feats.desc    # None while device-resident
        self.key_edges = feats.edges
        self.edge_scores = feats.edge_score
        self.colines = feats.colines
        self.connected = feats.connected
        self.grid = FeatureGrid(rig.cam, feats.kp_pos)

        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self.velocity = np.zeros(3, np.float32)
        self.bias = np.zeros(6, np.float32)  # [bg, ba]
        self.has_pose = False
        self.has_velocity = False

        self.map_points: List[Optional[MapPoint]] = [None] * self.N
        self.map_edges: List[Optional[MapEdge]] = [None] * len(feats.edges)
        self.outlier = np.zeros(self.N, bool)

        self.bow_vec = None
        self.feat_vec = None
        self.preint_kf = None      # Preintegrated from last KF
        self.preint_frame = None   # Preintegrated from last frame
        self.prev_frame: Optional["Frame"] = None
        self.prior = None          # marginalization prior (Prior15 host copy)
        self.ref_kf: Optional["KeyFrame"] = None
        self.imu_predicted = False

    @property
    def descriptors(self) -> np.ndarray:
        """Host descriptor matrix. In the device-matching configuration
        (PPGExtractor desc_transfer="device") descriptors live on the device
        and this property pulls them over on first host use — keyframe
        construction and the init/reloc fallback paths; steady-state
        tracking matches through the device distance service instead
        (matching/device_match.py)."""
        if self._descriptors is None:
            self._descriptors = self.feats.descriptors
        return self._descriptors

    @property
    def has_host_descriptors(self) -> bool:
        return self._descriptors is not None or self.feats.desc is not None

    # -- frustum check (Frame.cpp:223-260) -----------------------------------
    def check_in_frustum(self, mp: MapPoint, view_cos_limit: float) -> bool:
        mp.track_in_view = False
        mp.track_proj_x = -1.0
        mp.track_proj_y = -1.0
        mp.track_depth = -1.0
        P = mp.pos
        Pc = self.Rcw @ P + self.tcw
        if Pc[2] < 0.0:
            return False
        uv = self.rig.cam.project_np(Pc)
        min_x, max_x, min_y, max_y = image_bounds(self.rig.cam)
        if not (min_x <= uv[0] < max_x and min_y <= uv[1] < max_y):
            return False
        po = P - self.camera_center()
        dist = float(np.linalg.norm(po))
        if dist < mp.min_distance_invariance() or \
                dist > mp.max_distance_invariance():
            return False
        nrm = np.linalg.norm(mp.normal)
        view_cos = float(po @ mp.normal) / (dist * nrm) if nrm > 1e-9 else 1.0
        if view_cos < view_cos_limit:
            return False
        mp.track_in_view = True
        mp.track_proj_x = float(uv[0])
        mp.track_proj_y = float(uv[1])
        mp.track_depth = dist
        mp.track_view_cos = view_cos
        mp.increase_visible()
        return True

    def check_in_frustum_batch(self, mps, view_cos_limit: float) -> None:
        """Vectorized check_in_frustum over a list of map points — identical
        semantics (Frame::isInFrustum, Frame.cpp), one numpy pass instead of
        per-point Python math (the per-frame local-map loop runs this over
        hundreds of points on the tracking critical path)."""
        if not mps:
            return
        P = np.stack([mp.pos for mp in mps]).astype(np.float32)
        nrm = np.stack([mp.normal for mp in mps]).astype(np.float32)
        dmin = np.fromiter((mp.min_distance_invariance() for mp in mps),
                           np.float32, len(mps))
        dmax = np.fromiter((mp.max_distance_invariance() for mp in mps),
                           np.float32, len(mps))
        Pc = P @ self.Rcw.T + self.tcw
        z = Pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = self.rig.cam.project_np(Pc)
        min_x, max_x, min_y, max_y = image_bounds(self.rig.cam)
        po = P - self.camera_center()
        dist = np.linalg.norm(po, axis=1)
        nn = np.linalg.norm(nrm, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            view_cos = np.where(nn > 1e-9,
                                np.einsum("ij,ij->i", po, nrm)
                                / np.maximum(dist * nn, 1e-12), 1.0)
        ok = ((z >= 0.0)
              & (uv[:, 0] >= min_x) & (uv[:, 0] < max_x)
              & (uv[:, 1] >= min_y) & (uv[:, 1] < max_y)
              & (dist >= dmin) & (dist <= dmax)
              & (view_cos >= view_cos_limit)
              & np.isfinite(uv).all(axis=1))
        for k, mp in enumerate(mps):
            if ok[k]:
                mp.track_in_view = True
                mp.track_proj_x = float(uv[k, 0])
                mp.track_proj_y = float(uv[k, 1])
                mp.track_depth = float(dist[k])
                mp.track_view_cos = float(view_cos[k])
                mp.increase_visible()
            else:
                mp.track_in_view = False
                mp.track_proj_x = -1.0
                mp.track_proj_y = -1.0
                mp.track_depth = -1.0

    def features_in_area(self, x, y, r) -> List[int]:
        return self.grid.features_in_area(x, y, r)


class KeyFrame(PoseState):
    """Keyframe (reference feature/KeyFrame.*): deep copy of a Frame +
    covisibility graph + temporal chain + lifecycle."""

    def __init__(self, frame: Frame, world_map):
        self.mnId = next(_kf_ids)
        self.frame_id = frame.mnId
        self.timestamp = frame.timestamp
        self.rig = frame.rig
        self.map = world_map
        self.N = frame.N
        self.kp = frame.kp
        self.kp_un = frame.kp_un
        self.descriptors = frame.descriptors
        self.key_edges = frame.key_edges
        self.edge_scores = frame.edge_scores
        self.colines = frame.colines
        self.connected = frame.connected
        self.grid = frame.grid

        self.Rcw = frame.Rcw.copy()
        self.tcw = frame.tcw.copy()
        self.velocity = frame.velocity.copy()
        self.bias = frame.bias.copy()

        self.map_points: List[Optional[MapPoint]] = list(frame.map_points)
        self.map_edges: List[Optional[MapEdge]] = [None] * len(frame.key_edges)

        self.preintegrated = None  # from prev KF
        self.prev_kf: Optional["KeyFrame"] = None
        self.next_kf: Optional["KeyFrame"] = None

        self.connections: Dict["KeyFrame", int] = {}
        self.ordered_connected: List["KeyFrame"] = []
        self.ordered_weights: List[int] = []
        self.loop_edges: List["KeyFrame"] = []

        self.bow_vec = None   # dict word -> value
        self.feat_vec = None  # dict node -> [kp indices]

        self.bad = False
        self.not_erase = False
        self.to_be_erased = False
        self.Tcp = None  # pose relative to prev KF when culled

        # loop / GBA scratch (reference KeyFrame.h:160-180)
        self.gba_Rcw = None
        self.gba_tcw = None
        self.gba_vel = None
        self.gba_bias = None
        self.ba_global_for_kf = -1
        self.loop_query = -1
        self.loop_words = 0
        self.loop_score = 0.0
        self.reloc_query = -1
        self.reloc_words = 0
        self.reloc_score = 0.0
        self.ba_local_for_kf = -1
        self.ba_fixed_for_kf = -1
        self.fuse_target_for_kf = -1
        self.place_recognition_query = -1
        self.place_recognition_words = 0
        self.place_recognition_score = 0.0
        self.merge_corrected_for_kf = -1
        self.n_merge_corrected = -1

    # -- covisibility (KeyFrame.cpp:297-384) ---------------------------------
    def add_connection(self, kf: "KeyFrame", weight: int) -> None:
        self.connections[kf] = weight
        self._sort_connections()

    def erase_connection(self, kf: "KeyFrame") -> None:
        if kf in self.connections:
            del self.connections[kf]
            self._sort_connections()

    def _sort_connections(self) -> None:
        pairs = sorted(self.connections.items(), key=lambda p: -p[1])
        self.ordered_connected = [p[0] for p in pairs]
        self.ordered_weights = [p[1] for p in pairs]

    def update_connections(self, up_parent: bool = True) -> None:
        counter: Dict["KeyFrame", int] = {}
        for mp in self.map_points:
            if mp is None or mp.is_bad():
                continue
            for kf in mp.observations:
                if kf.mnId == self.mnId or kf.is_bad():
                    continue
                counter[kf] = counter.get(kf, 0) + 1
        if not counter:
            return
        th = 5
        n_max, kf_max = 0, None
        pairs = []
        for kf, n in counter.items():
            if n > n_max:
                n_max, kf_max = n, kf
            if n >= th:
                pairs.append((n, kf))
                kf.add_connection(self, n)
        if not pairs:
            pairs.append((n_max, kf_max))
            kf_max.add_connection(self, n_max)
        pairs.sort(key=lambda p: -p[0])
        self.connections = counter
        self.ordered_connected = [p[1] for p in pairs]
        self.ordered_weights = [p[0] for p in pairs]

    def get_best_covisibility_keyframes(self, n: int) -> List["KeyFrame"]:
        return self.ordered_connected[:n]

    def get_covisibles_by_weight(self, w: int) -> List["KeyFrame"]:
        return [kf for kf, wt in zip(self.ordered_connected,
                                     self.ordered_weights) if wt >= w]

    def get_connected_keyframes(self) -> List["KeyFrame"]:
        return list(self.connections.keys())

    def get_weight(self, kf: "KeyFrame") -> int:
        return self.connections.get(kf, 0)

    # -- map points ----------------------------------------------------------
    def add_map_point(self, mp: MapPoint, idx: int) -> None:
        self.map_points[idx] = mp

    def get_map_point(self, idx: int) -> Optional[MapPoint]:
        return self.map_points[idx]

    def erase_map_point_by_index(self, idx: int) -> None:
        self.map_points[idx] = None

    def get_map_point_matches(self) -> List[Optional[MapPoint]]:
        return list(self.map_points)

    def tracked_map_points(self, min_obs: int) -> int:
        n = 0
        for mp in self.map_points:
            if mp is not None and not mp.is_bad() \
                    and mp.n_observations() >= min_obs:
                n += 1
        return n

    # -- map edges -----------------------------------------------------------
    def add_map_edge(self, me: MapEdge, idx: int) -> None:
        self.map_edges[idx] = me

    def get_map_edge(self, idx: int) -> Optional[MapEdge]:
        return self.map_edges[idx]

    # -- lifecycle (KeyFrame.cpp:425-460) -------------------------------------
    def is_bad(self) -> bool:
        return self.bad

    def set_not_erase(self) -> None:
        self.not_erase = True

    def set_erase(self) -> None:
        if not self.loop_edges:
            self.not_erase = False
        if self.to_be_erased:
            self.set_bad_flag()

    def set_bad_flag(self) -> None:
        if self.not_erase:
            self.to_be_erased = True
            return
        if self.prev_kf is None or self.next_kf is None:
            return  # never cull the chain endpoints
        for kf in list(self.connections):
            kf.erase_connection(self)
        for mp in self.map_points:
            if mp is not None:
                mp.erase_observation(self)
        if self.next_kf.preintegrated is not None and \
                self.preintegrated is not None:
            self.next_kf.preintegrated.merge_previous(self.preintegrated)
        # relative pose to the previous KF (used by trajectory recovery)
        Rcp = self.Rcw @ self.prev_kf.Rcw.T
        tcp = self.tcw - Rcp @ self.prev_kf.tcw
        self.Tcp = (Rcp, tcp)
        self.next_kf.prev_kf = self.prev_kf
        self.prev_kf.next_kf = self.next_kf
        self.bad = True
        self.map.erase_keyframe(self)

    def features_in_area(self, x, y, r) -> List[int]:
        return self.grid.features_in_area(x, y, r)

    def add_loop_edge(self, kf: "KeyFrame") -> None:
        self.not_erase = True
        if kf not in self.loop_edges:
            self.loop_edges.append(kf)
