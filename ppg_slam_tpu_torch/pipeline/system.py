"""System facade (the reference System, system/src/System.cpp) and its
settings files: a port of ppg_slam_tpu/pipeline/system.py.

`System` loads the vocabulary and the settings, builds the map, the
extractor and the pipeline modules, routes frames and IMU, and writes the
TUM-format trajectories. Everything it builds runs on its `device` (CUDA
unless the caller names another).

The settings are OpenCV FileStorage YAML (`%YAML:1.0`). OpenCV is not a
dependency of the port, so `load_settings` parses the subset the configs use:
`Key: value` scalars (numbers and quoted strings) and `!!opencv-matrix` blocks
(rows / cols / dt / a bracketed `data` list that may span lines). Numbers come
back as float, as FileStorage's `real()` returns them; matrices as numpy
arrays of the block's `dt` type.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any, Dict, Optional

import numpy as np

from ..device import resolve_device
from ..geometry.cameras import CAM_FISHEYE, CAM_PINHOLE, CameraModel

_MAT_DTYPES = {"f": np.float32, "d": np.float64, "i": np.int32,
               "u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16}


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside a quoted string."""
    out, quote = [], None
    for ch in line:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            break
        out.append(ch)
    return "".join(out).rstrip()


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    try:
        return float(text)
    except ValueError:
        return text


def parse_opencv_yaml(text: str) -> Dict[str, Any]:
    """Top-level keys of an OpenCV FileStorage YAML document."""
    lines = [_strip_comment(ln) for ln in text.splitlines()]
    out: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.startswith("%") or line.startswith("---"):
            continue
        if line[0].isspace():
            raise ValueError(f"unexpected indented line: {line!r}")
        key, sep, rest = line.partition(":")
        if not sep:
            raise ValueError(f"not a key: value line: {line!r}")
        rest = rest.strip()
        if not rest.startswith("!!opencv-matrix"):
            out[key.strip()] = _scalar(rest)
            continue
        fields: Dict[str, str] = {}
        while i < len(lines) and (not lines[i].strip() or lines[i][0].isspace()):
            body = lines[i].strip()
            i += 1
            if not body:
                continue
            fkey, _, fval = body.partition(":")
            fval = fval.strip()
            if fval.startswith("["):
                while "]" not in fval:
                    fval += " " + lines[i].strip()
                    i += 1
            fields[fkey.strip()] = fval
        rows, cols = int(fields["rows"]), int(fields["cols"])
        data = [float(v) for v in
                re.split(r"[,\s]+", fields["data"].strip("[] ")) if v]
        arr = np.asarray(data, _MAT_DTYPES[fields["dt"].strip()])
        out[key.strip()] = arr.reshape(rows, cols)
    return out


def load_settings(path: str) -> dict:
    """Parse the reference's OpenCV-YAML settings files (configs/*.yaml)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = parse_opencv_yaml(f.read())

    def rd(key, default=None):
        return doc.get(key, default)

    out = {"camera_type": rd("Camera.type", "PinHole")}
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4", "p1", "p2",
              "width", "height", "fps"):
        out[k] = rd(f"Camera.{k}", 0.0)
    out["Tbc"] = rd("IMU.T_b_c1")
    out["noise_gyro"] = rd("IMU.NoiseGyro", 1.7e-4)
    out["noise_acc"] = rd("IMU.NoiseAcc", 2e-3)
    out["walk_gyro"] = rd("IMU.GyroWalk", 1.9e-5)
    out["walk_acc"] = rd("IMU.AccWalk", 3e-3)
    out["imu_freq"] = rd("IMU.Frequency", 200.0)
    out["imu_ini_time"] = rd("IMU.IniTime", 8.0)
    out["view_cos_th"] = rd("ViewCosTh", 0.85)
    return out


def camera_from_settings(s: dict) -> CameraModel:
    if s["camera_type"] == "KannalaBrandt8":
        return CameraModel(
            kind=CAM_FISHEYE, fx=s["fx"], fy=s["fy"], cx=s["cx"], cy=s["cy"],
            dist=(s["k1"], s["k2"], s["k3"], s["k4"]),
            width=int(s["width"]), height=int(s["height"]),
            fps=s["fps"] or 20.0)
    return CameraModel(
        kind=CAM_PINHOLE, fx=s["fx"], fy=s["fy"], cx=s["cx"], cy=s["cy"],
        dist=(s["k1"], s["k2"], s["p1"], s["p2"]),
        width=int(s["width"]), height=int(s["height"]), fps=s["fps"] or 20.0)


class System:
    def __init__(self, vocabulary_path: Optional[str], settings_path: str,
                 weights_path: Optional[str] = None, use_viewer: bool = False,
                 active_loop_closing: bool = True,
                 viewer_out_dir: Optional[str] = None,
                 viewer_every: int = 10,
                 async_frontend: bool = False, prefetch_batch: int = 4,
                 prefetch_depth: int = 2,
                 threaded_gba: bool = False,
                 async_mapping: bool = False,
                 desc_transfer: str = "f32", compute_dtype: str = "f32",
                 load_map_path: Optional[str] = None, device=None):
        """The reference signature, plus `device`. active_loop_closing:
        place recognition, loop correction and the global BA after a loop
        (pipeline/loop_closing.py). threaded_gba: that global BA on a
        background thread with kill/propagate (LoopClosing.cpp:1050).
        async_mapping: local mapping on its own consumer thread (the
        reference's thread deployment). desc_transfer="device" +
        compute_dtype="bf16" is the serving configuration (descriptors stay
        on the device for gated matching). load_map_path: resume from a map
        saved by save_map(); tracking starts LOST and relocalizes into it.
        async_frontend: extract frames ahead of tracking through a
        FramePrefetcher (feed_frame() them in order first). use_viewer:
        render the offline viewer's PNGs to viewer_out_dir every
        viewer_every frames."""
        from ..bow import Vocabulary
        from ..frontend.extractor import PPGExtractor
        from ..worldmap import Map, Rig
        from ..worldmap.elements import MapEdge
        from .local_mapping import LocalMapping
        from .loop_closing import LoopClosing
        from .tracking import Tracking

        self.device = resolve_device(device)
        s = load_settings(settings_path)
        cam = camera_from_settings(s)
        MapEdge.view_cos_th = float(s["view_cos_th"])
        Map.imu_ini_time = float(s["imu_ini_time"])
        rig = Rig(cam, Tbc=s["Tbc"], noise_gyro=s["noise_gyro"],
                  noise_acc=s["noise_acc"], walk_gyro=s["walk_gyro"],
                  walk_acc=s["walk_acc"], freq=s["imu_freq"])
        voc = (Vocabulary.load(vocabulary_path)
               if vocabulary_path and os.path.exists(vocabulary_path)
               else None)
        if load_map_path:
            from ..worldmap.serialize import load_map

            self.map = load_map(load_map_path, vocabulary=voc, rig=rig,
                                device=self.device)
            if voc is None:
                print("WARNING: resuming from a map without a vocabulary — "
                      "relocalization needs BoW place recognition, so "
                      "tracking cannot re-anchor into the loaded map",
                      file=sys.stderr)
        else:
            self.map = Map(rig, vocabulary=voc)
        self.extractor = PPGExtractor(cam, weights_path,
                                      desc_transfer=desc_transfer,
                                      compute_dtype=compute_dtype,
                                      device=self.device)
        self.prefetcher = None
        if async_frontend:
            from ..frontend.prefetch import FramePrefetcher

            self.prefetcher = FramePrefetcher(self.extractor,
                                              batch=prefetch_batch,
                                              depth=prefetch_depth)
        self.loop_closing = LoopClosing(self.map,
                                        active=active_loop_closing,
                                        device=self.device)
        self.loop_closing.threaded_gba = threaded_gba
        # the abort poll (chunked BA) is only useful when a background GBA
        # thread can request interruption
        self.local_mapping = LocalMapping(self.map,
                                          loop_closer=self.loop_closing,
                                          threaded=threaded_gba,
                                          device=self.device)
        if async_mapping:
            self.local_mapping.start()
        self.tracking = Tracking(self.map, self.extractor,
                                 local_mapper=self.local_mapping,
                                 device=self.device)
        if load_map_path:
            self.tracking.resume_from_map()
        self.local_mapping.tracking = self.tracking
        self.loop_closing.local_mapper = self.local_mapping
        self.viewer = None
        if use_viewer:
            from ..viz import Viewer

            self.viewer = Viewer(self.map, out_dir=viewer_out_dir,
                                 render_every=viewer_every)
            self.tracking.viewer = self.viewer

    # ------------------------------------------------------------------
    def feed_frame(self, image: np.ndarray) -> None:
        """Async front-end: stage a FUTURE frame's extraction (its device
        work overlaps host tracking). Call ahead of track_monocular in feed
        order; a no-op when async_frontend is off."""
        if self.prefetcher is not None:
            self.prefetcher.feed(image)

    def track_monocular(self, image: np.ndarray, timestamp: float,
                        imu: Optional[np.ndarray] = None):
        """System::TrackMonocular (System.cpp:122-143). imu rows:
        (ax, ay, az, wx, wy, wz, t). A finished background GBA is applied
        first (a safe point). With async_frontend, `image` must have been
        feed_frame()'d (in order); its features come from the prefetcher."""
        self.poll_background()
        if imu is not None and len(imu):
            self.tracking.grab_imu(imu)
        feats = self.prefetcher.get() if self.prefetcher is not None else None
        return self.tracking.grab_image(image, timestamp, feats=feats)

    def poll_background(self) -> None:
        """Apply finished background-GBA results at a safe point (the
        per-frame analog of the reference's propagation after the GBA
        thread finishes, LoopClosing.cpp:1139-1289)."""
        if self.loop_closing.threaded_gba:
            self.loop_closing.poll_gba()

    @property
    def state(self) -> int:
        return self.tracking.state

    # ------------------------------------------------------------------
    # trajectory writers (reference Viewer.cpp:853-959, TUM body-frame format)
    # ------------------------------------------------------------------
    def save_trajectory(self, path: str) -> None:
        from ..geometry import so3

        tr = self.tracking
        rig = self.map.rig
        with open(path, "w") as f:
            for (Rcr, tcr), ref, ts, lost in zip(
                    tr.rel_poses, tr.references, tr.frame_times,
                    tr.lost_flags):
                if lost:
                    continue
                kf = ref
                Rrw, trw = np.eye(3, dtype=np.float32), np.zeros(
                    3, np.float32)
                while kf.is_bad() and kf.Tcp is not None:
                    Rcp, tcp = kf.Tcp
                    Rrw = Rcp @ Rrw  # accumulate relative chain
                    trw = Rcp @ trw + tcp
                    kf = kf.prev_kf
                Rcw = Rcr @ Rrw @ kf.Rcw
                tcw = Rcr @ (Rrw @ kf.tcw + trw) + tcr
                # body pose Twb = (Tbc * Tcw)^-1
                Rbw = rig.Rbc @ Rcw
                tbw = rig.Rbc @ tcw + rig.tbc
                Rwb = Rbw.T
                twb = -Rwb @ tbw
                q = so3.matrix_to_quat(Rwb.astype(np.float32))
                f.write(f"{ts:.9f} {twb[0]:.9f} {twb[1]:.9f} {twb[2]:.9f} "
                        f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")

    def save_keyframe_trajectory(self, path: str) -> None:
        from ..geometry import so3

        kfs = sorted(self.map.all_keyframes(), key=lambda k: k.mnId)
        with open(path, "w") as f:
            for kf in kfs:
                Rwb = kf.imu_rotation()
                twb = kf.imu_position()
                q = so3.matrix_to_quat(Rwb.astype(np.float32))
                f.write(f"{kf.timestamp:.9f} {twb[0]:.9f} {twb[1]:.9f} "
                        f"{twb[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} "
                        f"{q[3]:.9f}\n")

    def save_map(self, path: str) -> None:
        """Checkpoint the full map (worldmap/serialize.py); resume with
        System(load_map_path=path)."""
        from ..worldmap.serialize import save_map

        with self.map.update_lock:
            save_map(self.map, path)

    def shutdown(self, out_dir: str = ".", save_map_path: str = "") -> None:
        """Drain and join the local-mapping consumer thread and wait for a
        background GBA, then write CameraTrajectory.txt and
        KeyFrameTrajectory.txt to out_dir, and the map to save_map_path."""
        self.local_mapping.stop()
        if self.loop_closing.threaded_gba:
            self.loop_closing.poll_gba(wait=True)
        self.save_trajectory(os.path.join(out_dir, "CameraTrajectory.txt"))
        self.save_keyframe_trajectory(
            os.path.join(out_dir, "KeyFrameTrajectory.txt"))
        if save_map_path:
            self.save_map(save_map_path)
