"""Offline viewer — the reference MSViewing rebuilt headless: a port of
ppg_slam_tpu/viz/viewer.py over the port's map, drawn by the numpy
rasterizer of viz/render.py and written with datasets/png.py.

The reference (system/src/Viewer.cpp, 958 LoC) runs a
Pangolin GL window + OpenCV frame window on its own thread, with menu
toggles (follow/top view, show points/colines/edges/KFs/graph/inertial,
unfaded, step-by-step debug) and time-based alpha fading of map elements.

This rebuild keeps the same draw content and options but renders
deterministically to numpy/PNG (no display, no thread):

  * ``update_frame(frame, state, image)``   — reference UpdateFrame
    (Viewer.cpp:410-447): snapshot the current frame's features, matches,
    outliers, pose, and state.
  * ``draw_frame()``                        — reference DrawFrame
    (Viewer.cpp:258-358): colines red, key-edges green with endpoint dots,
    tracked map points yellow, init-phase match lines, text bar with
    KF/MP/match counts.
  * ``draw_map()``                          — reference Run loop draw pass
    (Viewer.cpp:187-205): current camera frustum, keyframe axes,
    covisibility graph (w>=10) + loop edges, inertial (temporal) chain,
    map points faded by age, map edges (current = bright green, old = faded
    blue), colines red.
  * follow-camera and top-view projections  — Viewer.cpp:96-179 (focal 500
    camera view at offset (0,-1,-3); focal 3000 top view along gravity).
  * step-by-step debug gate                 — Viewer.cpp:92-93 + mbStep,
    consumed by Tracking at frame start (Tracking.cpp:254-259).

Fading uses frame timestamps instead of wall clock (deterministic offline):
alpha = (20 - age)/20 clamped at age>=18 to 0.1 (Viewer.cpp:470-479).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from ..datasets.png import write_png
from .render import Canvas3D, _colors, draw_discs, draw_lines, draw_text_bar

# tracking states (pipeline/tracking.py mirrors the reference Tracking.h:25-31)
_NO_IMAGES_YET, _NOT_INITIALIZED, _OK, _RECENTLY_LOST, _LOST = -1, 0, 1, 2, 3


class Viewer:
    """MSViewing-shaped offline renderer over the live Map."""

    def __init__(self, wmap, out_dir: Optional[str] = None,
                 render_every: int = 1, width: int = 1024, height: int = 768,
                 show_points: bool = True, show_colines: bool = True,
                 show_edges: bool = True, show_keyframes: bool = True,
                 show_graph: bool = False, show_inertial: bool = True,
                 unfaded: bool = False, follow_camera: bool = True,
                 top_view: bool = False):
        self.map = wmap
        self.out_dir = out_dir
        self.render_every = max(int(render_every), 1)
        self.width, self.height = width, height
        self.show_points = show_points
        self.show_colines = show_colines
        self.show_edges = show_edges
        self.show_keyframes = show_keyframes
        self.show_graph = show_graph
        self.show_inertial = show_inertial
        self.unfaded = unfaded
        self.follow_camera = follow_camera
        self.top_view = top_view

        # step-by-step debug (reference mbStepByStep/mbStep)
        self.step_by_step = False
        self._step = False
        self.step_hook: Optional[Callable[["Viewer"], None]] = None

        # frame snapshot (reference UpdateFrame members)
        self._image: Optional[np.ndarray] = None
        self._kp_pos: Optional[np.ndarray] = None
        self._key_edges: Optional[np.ndarray] = None
        self._colines: Optional[np.ndarray] = None
        self._outlier: Optional[np.ndarray] = None
        self._map_points: List = []
        self._state = _NO_IMAGES_YET
        self._Rcw = np.eye(3, dtype=np.float32)
        self._tcw = np.zeros(3, np.float32)
        self._has_pose = False
        self._cur_frame_id = -1
        self._cur_ts = 0.0
        self._n_tracked = 0
        self._ini_pos: Optional[np.ndarray] = None
        self._ini_matches: Optional[np.ndarray] = None
        self._n_updates = 0

        # element-creation timestamps for fading (reference stores
        # chrono::steady_clock startTime on MapPoint/MapEdge; here the
        # viewer stamps elements the first time it sees them, in frame time)
        self._birth: dict = {}

        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------------
    # step-by-step debug gate (reference Viewer.cpp:92-93 -> Tracking.cpp:254-259)
    # ------------------------------------------------------------------
    def step(self) -> None:
        self._step = True

    def wait_step(self) -> None:
        """Called by Tracking at the top of Track(). In the reference this
        busy-waits on the viewer thread; offline, it invokes ``step_hook``
        (if any) until ``step()`` has been called, else proceeds."""
        if not self.step_by_step:
            return
        while not self._step:
            if self.step_hook is None:
                break
            self.step_hook(self)
        self._step = False

    # ------------------------------------------------------------------
    def update_frame(self, frame, state: int,
                     image: Optional[np.ndarray] = None,
                     ini_pos: Optional[np.ndarray] = None,
                     ini_matches: Optional[np.ndarray] = None) -> None:
        """Snapshot current-frame data (reference UpdateFrame,
        Viewer.cpp:410-447) and render if due."""
        self._image = None if image is None else np.asarray(image)
        self._kp_pos = frame.kp.copy()
        self._key_edges = np.asarray(frame.key_edges).reshape(-1, 2)
        self._colines = np.asarray(frame.colines).reshape(-1, 3)
        self._outlier = frame.outlier.copy()
        self._map_points = list(frame.map_points)
        self._state = int(state)
        if frame.has_pose:
            self._Rcw = frame.Rcw.copy()
            self._tcw = frame.tcw.copy()
            self._has_pose = True
        self._cur_frame_id = frame.mnId
        self._cur_ts = float(frame.timestamp)
        if state == _NOT_INITIALIZED:
            self._ini_pos = ini_pos
            self._ini_matches = ini_matches
        self._n_updates += 1
        if self.out_dir and (self._n_updates % self.render_every == 0):
            self.render(tag=f"{self._n_updates:06d}")

    # ------------------------------------------------------------------
    def _age(self, key, kind: str) -> float:
        birth = self._birth.setdefault((kind, key), self._cur_ts)
        return 0.0 if self.unfaded else max(self._cur_ts - birth, 0.0)

    @staticmethod
    def _fade(ts: float) -> float:
        # Viewer.cpp:474-479: >=18 s -> alpha 0.1, else (20-ts)/20
        return 0.1 if ts >= 18.0 else (20.0 - ts) / 20.0

    # ------------------------------------------------------------------
    def draw_frame(self) -> np.ndarray:
        """2-D overlay of the current frame (reference DrawFrame,
        Viewer.cpp:258-358). Returns (H+20, W, 3) uint8."""
        kp_h = int(np.max(self._kp_pos[:, 1]) + 20) if len(self._kp_pos) \
            else 480
        kp_w = int(np.max(self._kp_pos[:, 0]) + 20) if len(self._kp_pos) \
            else 640
        if self._image is not None and self._image.shape[0] >= kp_h * 0.5 \
                and self._image.shape[1] >= kp_w * 0.5:
            im = self._image
            img = (np.repeat(im[..., None], 3, axis=2)
                   if im.ndim == 2 else im[..., :3]).astype(np.uint8)
        else:
            # no usable image (synthetic feed): keypoint-extent canvas
            img = np.full((kp_h, kp_w, 3), 96, np.uint8)
        kp = np.asarray(self._kp_pos, np.float64)

        def lines(a, b, color, width):
            draw_lines(img, a, b, _colors(color, None, len(a)), width)

        # initialization-phase match lines (reference draws ini matches)
        if (self._state == _NOT_INITIALIZED and self._ini_pos is not None
                and self._ini_matches is not None):
            ij = [(i, j) for i, j in enumerate(self._ini_matches)
                  if 0 <= j < len(kp) and i < len(self._ini_pos)]
            if ij:
                i, j = np.asarray(ij).T
                lines(np.asarray(self._ini_pos, np.float64)[i], kp[j],
                      (0, 255, 0), 1)

        # colines: red segments between the two outer points (Viewer.cpp:305-317)
        if self.show_colines and self._colines is not None:
            c = self._colines
            c = c[(c[:, 1] < len(kp)) & (c[:, 2] < len(kp))]
            lines(kp[c[:, 1]], kp[c[:, 2]], (255, 20, 20), 2)

        # key edges: green segments + filled endpoint dots (Viewer.cpp:320-334)
        if self.show_edges and self._key_edges is not None:
            e = self._key_edges
            e = e[(e[:, 0] < len(kp)) & (e[:, 1] < len(kp))]
            lines(kp[e[:, 0]], kp[e[:, 1]], (0, 255, 0), 1)
            ends = kp[e.reshape(-1)]
            draw_discs(img, ends, 3, _colors((0, 255, 0), None, len(ends)))

        # tracked map points: yellow circles, count inliers (Viewer.cpp:336-351)
        self._n_tracked = 0
        tracked = []
        for i, mp in enumerate(self._map_points):
            if mp is None or mp.is_bad():
                continue
            if self._outlier is not None and i < len(self._outlier) \
                    and self._outlier[i]:
                continue
            tracked.append(i)
            self._n_tracked += 1
        if self.show_points and tracked:
            draw_discs(img, kp[tracked], 3,
                       _colors((255, 255, 0), None, len(tracked)),
                       outline=True)

        # text bar (reference DrawTextInfo, Viewer.cpp:370-408)
        if self._state == _NO_IMAGES_YET:
            text = " WAITING FOR IMAGES"
        elif self._state == _NOT_INITIALIZED:
            text = " TRYING TO INITIALIZE"
        elif self._state == _OK:
            text = (f" KFs: {len(self.map.all_keyframes())}, "
                    f"MPs: {len(self.map.all_map_points())}, "
                    f"Matches: {self._n_tracked}")
        elif self._state == _RECENTLY_LOST:
            text = " TRACK LOST (coasting on IMU)"
        else:
            text = " TRACK LOST. TRYING TO RELOCALIZE"
        return draw_text_bar(img, text)

    # ------------------------------------------------------------------
    def _camera_view(self, canvas: Canvas3D) -> None:
        """Set the canvas view per the reference render states
        (Viewer.cpp:96-179)."""
        Rwc = self._Rcw.T
        Ow = -Rwc @ self._tcw
        if self.top_view and self.map.imu_initialized:
            # top view: along gravity (world z after IMU alignment),
            # focal 3000, eye 10 m above the camera (Viewer.cpp:148-155)
            canvas.f = 3000.0
            eye = Ow + np.array([0.0, 0.01, 10.0], np.float32)
            canvas.set_view(eye, Ow, np.array([0.0, 0.0, 1.0]))
        elif self.follow_camera and self._has_pose:
            # camera view: eye at (0,-1,-3) in camera coords (Viewer.cpp:97-99)
            eye = Ow + Rwc @ np.array([0.0, -1.0, -3.0], np.float32)
            up = Rwc @ np.array([0.0, -1.0, 0.0], np.float32)
            canvas.set_view(eye, Ow, up)
        else:
            # static overview: frame the whole map
            pts = [mp.pos for mp in self.map.all_map_points()
                   if not mp.is_bad()]
            c = np.mean(pts, axis=0) if pts else np.zeros(3)
            r = (np.max(np.linalg.norm(np.asarray(pts) - c, axis=1))
                 if pts else 5.0)
            eye = c + np.array([0.0, -1.0, -2.5]) * max(r, 1.0)
            canvas.set_view(eye, c, np.array([0.0, -1.0, 0.0]))

    def draw_map(self) -> np.ndarray:
        """3-D map render (reference Run loop draw pass, Viewer.cpp:187-205).
        Returns (height, width, 3) uint8."""
        canvas = Canvas3D(self.width, self.height)
        self._camera_view(canvas)
        now = self._cur_ts

        kfs = [kf for kf in self.map.all_keyframes() if not kf.is_bad()]
        centers = {kf: kf.camera_center() for kf in kfs}

        # covisibility graph w>=10 + loop edges (Viewer.cpp:679-714)
        if self.show_graph:
            a, b = [], []
            for kf in kfs:
                for kf2 in kf.get_covisibles_by_weight(10):
                    if kf2 in centers:
                        a.append(centers[kf])
                        b.append(centers[kf2])
                for kf2 in kf.loop_edges:
                    if kf2.mnId >= kf.mnId and kf2 in centers:
                        a.append(centers[kf])
                        b.append(centers[kf2])
            if a:
                canvas.lines(np.asarray(a), np.asarray(b), (0, 155, 0),
                             alpha=np.full(len(a), 0.6))

        # inertial temporal chain (Viewer.cpp:717-738)
        if self.show_inertial and self.map.imu_initialized:
            a, b = [], []
            for kf in kfs:
                nxt = kf.next_kf
                if nxt is not None and nxt in centers:
                    a.append(centers[kf])
                    b.append(centers[nxt])
            if a:
                canvas.lines(np.asarray(a), np.asarray(b), (255, 0, 255),
                             alpha=np.full(len(a), 0.6))

        # keyframe axes (Viewer.cpp:651-676)
        if self.show_keyframes:
            for kf in kfs:
                canvas.axes(kf.Rcw.T, centers[kf], scale=0.1)

        # map points, age-faded black dots (Viewer.cpp:449-482)
        if self.show_points:
            mps = [mp for mp in self.map.all_map_points() if not mp.is_bad()]
            if mps:
                pos = np.asarray([mp.pos for mp in mps])
                alpha = np.asarray([self._fade(self._age(mp.mnId, "mp"))
                                    for mp in mps])
                canvas.points(pos, (0, 0, 0), size=2, alpha=alpha)

        # map edges: current bright green w2, old faded blue w1 + endpoint
        # dots (Viewer.cpp:550-620)
        if self.show_edges:
            cur_a, cur_b, old_a, old_b, old_alpha = [], [], [], [], []
            for me in list(self.map.map_edges):
                if me.is_bad() or not me.valid:
                    continue
                p1, p2 = me.mp_s.pos, me.mp_e.pos
                if me.tracked_frame_id == self._cur_frame_id:
                    cur_a.append(p1)
                    cur_b.append(p2)
                else:
                    old_a.append(p1)
                    old_b.append(p2)
                    old_alpha.append(self._fade(self._age(me.mnId, "me")))
            if old_a:
                al = np.asarray(old_alpha)
                canvas.lines(np.asarray(old_a), np.asarray(old_b),
                             (51, 51, 153), width=1, alpha=al)
                ends = np.concatenate([old_a, old_b])
                canvas.points(ends, (0, 0, 0), size=3,
                              alpha=np.concatenate([al, al]))
            if cur_a:
                canvas.lines(np.asarray(cur_a), np.asarray(cur_b),
                             (0, 255, 0), width=2)

        # colines: red segments outer->outer + black triplet dots
        # (Viewer.cpp:495-537)
        if self.show_colines:
            a, b, dots = [], [], []
            for mp in self.map.all_map_points():
                if mp.is_bad():
                    continue
                for mc in mp.get_colines():
                    if mc.is_bad() or not mc.valid:
                        continue
                    a.append(mc.mp_s.pos)
                    b.append(mc.mp_e.pos)
                    dots += [mc.mp_s.pos, mc.mp_m.pos, mc.mp_e.pos]
            if a:
                canvas.lines(np.asarray(a), np.asarray(b), (255, 0, 0),
                             width=2)
                canvas.points(np.asarray(dots), (0, 0, 0), size=3)

        # current camera frustum, blue (Viewer.cpp:749-797)
        if self._has_pose:
            Rwc = self._Rcw.T
            Ow = -Rwc @ self._tcw
            canvas.frustum(Rwc, Ow, (0, 0, 255))
        _ = now
        return canvas.array()

    # ------------------------------------------------------------------
    def render(self, tag: str) -> None:
        """Write frame_<tag>.png + map_<tag>.png to out_dir."""
        if not self.out_dir:
            return
        write_png(os.path.join(self.out_dir, f"frame_{tag}.png"),
                  self.draw_frame())
        write_png(os.path.join(self.out_dir, f"map_{tag}.png"),
                  self.draw_map())
