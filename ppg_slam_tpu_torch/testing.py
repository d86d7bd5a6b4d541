"""Fixtures and bounds that the port's tests and chip_smoke.py share.

Imports neither jax nor ppg_slam_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

# lscore = rate * score, and the fused line_validate kernel sums a score's
# <= 126 non-negative samples in another order than PyTorch's reduction: two
# orders differ by at most 2 (n - 1) units of the sum's last place (250 at
# n = 126), plus the division and product's roundings
LSCORE_MAX_ULP = 256


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two non-negative
    f32 tensors (0 where they are empty)."""
    if not a.numel():
        return 0
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def saturating_case():
    """(heat, kp, kp_ok) as numpy: 320x240 heat at 0.9 everywhere and 500
    keypoints in two clusters (keypoint 0 in the near one, keypoint 1 in the
    far one). Every pair passes all three probes (saturated), and the first
    CAND_CAP candidates hold more than LONG_CAP longs (pairs across the
    clusters) and more than SCORE_S_CAP rate-passing shorts (overflow)."""
    rng = np.random.RandomState(21)
    n = 500
    near = rng.rand(n) < 0.6
    near[:2] = True, False
    a = np.stack([rng.uniform(20, 100, n), rng.uniform(20, 100, n)], 1)
    b = np.stack([rng.uniform(230, 300, n), rng.uniform(160, 225, n)], 1)
    kp = np.where(near[:, None], a, b).astype(np.float32)
    return np.full((240, 320), 0.9, np.float32), kp, np.ones(n, bool)


# ---------------------------------------------------------------------------
# synthetic world and sequence (port-side copies of the repository's test
# harness: a 3-D scene of points and colinear triplets rendered into
# FrameFeatures without the nets, and a mono-inertial trajectory whose IMU
# samples follow the discrete model the preintegration assumes)
# ---------------------------------------------------------------------------

def _cam(**kw):
    from .geometry.cameras import CAM_PINHOLE, CameraModel

    return CameraModel(kind=CAM_PINHOLE, dist=(0.0, 0.0, 0.0, 0.0), **kw)


CAM = _cam(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480)
# configs/euroc.yaml's pinhole; rendered keypoints are already undistorted
EUROC_CAM = _cam(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752,
                 height=480)
# the rays a synthetic Kannala-Brandt view sees (distort_frames' max_theta)
FISHEYE_MAX_THETA = 1.2


def kb8_undistort_f64(cam, d: np.ndarray) -> np.ndarray:
    """The extractor's undistortion of Kannala-Brandt pixels, in f64: 10
    Newton steps on theta (KannalaBrandt8.cpp:62-91); f32 out."""
    px = (d[:, 0].astype(np.float64) - cam.cx) / cam.fx
    py = (d[:, 1].astype(np.float64) - cam.cy) / cam.fy
    k1, k2, k3, k4 = cam.dist
    theta_d = np.minimum(np.hypot(px, py), np.pi / 2)
    theta = theta_d.copy()
    for _ in range(10):
        t2 = theta * theta
        f = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        df = 1 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - (f - theta_d) / df
    s = np.where(theta_d > 1e-8,
                 np.tan(theta) / np.maximum(theta_d, 1e-8), 1.0)
    x, y = px * s, py * s
    return np.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy],
                    1).astype(np.float32)


class SyntheticScene:
    """Points, line segments and colinear triplets (pivot = mid, a, b) with
    stable per-landmark descriptors."""

    def __init__(self, n_points=160, seed=7, cam=CAM,
                 extent=((-3, 3), (-2, 2), (4, 9))):
        rng = np.random.RandomState(seed)
        self.cam = cam
        self.rng = rng
        (x0, x1), (y0, y1), (z0, z1) = extent
        pts = [np.stack([rng.uniform(x0, x1, n_points // 2),
                         rng.uniform(y0, y1, n_points // 2),
                         rng.uniform(z0, z1, n_points // 2)], 1)]
        self.triplets = []
        self.segments = []
        base = n_points // 2
        line_pts = []
        for k in range(n_points // 6):
            a = np.array([rng.uniform(x0, x1), rng.uniform(y0, y1),
                          rng.uniform(z0, z1)])
            d = rng.randn(3)
            d /= np.linalg.norm(d)
            b = a + d * rng.uniform(0.8, 2.0)
            m = 0.5 * (a + b)
            i0 = base + 3 * k
            line_pts += [a, m, b]
            self.triplets.append((i0 + 1, i0, i0 + 2))
            self.segments += [(i0, i0 + 1), (i0 + 1, i0 + 2)]
        pts.append(np.stack(line_pts))
        self.points = np.concatenate(pts).astype(np.float32)
        self.n = len(self.points)
        self._segments = np.asarray(self.segments, np.int64).reshape(-1, 2)
        self._triplets = np.asarray(self.triplets, np.int64).reshape(-1, 3)
        d = rng.randn(self.n, 256).astype(np.float32)
        self.descs = d / np.linalg.norm(d, axis=1, keepdims=True)

    def pose(self, k: int, n_frames: int = 40, radius: float = 0.8):
        """Camera k on a smooth forward+lateral path looking at the scene."""
        from .geometry import so3

        t_wc = np.array([radius * np.sin(0.15 * k), 0.1 * np.sin(0.3 * k),
                         0.06 * k], np.float32)
        ang = np.array([0.02 * np.sin(0.2 * k), 0.05 * np.sin(0.1 * k),
                        0.01 * np.cos(0.25 * k)], np.float32)
        Rcw = so3.exp(ang).astype(np.float32).T
        return Rcw, (-Rcw @ t_wc).astype(np.float32)

    def _in_view(self, Xc: np.ndarray) -> np.ndarray:
        """Camera-frame points a keypoint can come from: in front of the
        camera, and on a fisheye no more than FISHEYE_MAX_THETA off the
        axis (distort_frames' renders are grey beyond it)."""
        front = Xc[:, 2] > 0.3
        if self.cam.is_fisheye:
            front &= (np.arctan2(np.hypot(Xc[:, 0], Xc[:, 1]), Xc[:, 2])
                      <= FISHEYE_MAX_THETA)
        return front

    def visible(self, Rcw: np.ndarray, tcw: np.ndarray) -> np.ndarray:
        """The ids render(Rcw, tcw) returns without noise or subset."""
        Xc = self.points @ Rcw.T + tcw
        ids = np.nonzero(self._in_view(Xc))[0]
        uv = self.cam.project_np(Xc[ids])
        inb = ((uv[:, 0] >= 8) & (uv[:, 0] < self.cam.width - 8)
               & (uv[:, 1] >= 8) & (uv[:, 1] < self.cam.height - 8))
        return ids[inb]

    def render(self, Rcw: np.ndarray, tcw: np.ndarray, noise: float = 0.0,
               desc_noise: float = 0.0, subset=None) -> tuple:
        """Returns (FrameFeatures, visible_global_ids). subset: an optional
        boolean mask over the scene's points; the others stay unseen.

        The features are filled as the extractor fills them: kp_pos is the
        camera's projection (with the pixel noise), kp_pos_un its
        undistortion (on a pinhole the same pixels; on Kannala-Brandt
        kb8_undistort_f64) and kp_out marks a keypoint whose undistorted
        position leaves the image (1 px border, PPGExtractor.cpp:141-146)."""
        from .frontend.extractor import FrameFeatures

        Xc = self.points @ Rcw.T + tcw
        vis = self._in_view(Xc)
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = self.cam.project_np(Xc)  # behind the camera: not visible
        if noise > 0:
            uv = uv + self.rng.randn(*uv.shape).astype(np.float32) * noise
        inb = ((uv[:, 0] >= 8) & (uv[:, 0] < self.cam.width - 8)
               & (uv[:, 1] >= 8) & (uv[:, 1] < self.cam.height - 8))
        if subset is not None:
            vis = vis & subset
        ids = np.nonzero(vis & inb)[0]
        uv_v = uv[ids].astype(np.float32)
        descs = self.descs[ids].copy()
        if desc_noise > 0:
            descs += self.rng.randn(*descs.shape).astype(np.float32) \
                * desc_noise
            descs /= np.linalg.norm(descs, axis=1, keepdims=True)
        local = np.full(self.n, -1, np.int64)
        local[ids] = np.arange(len(ids))
        seg = local[self._segments]
        edges_np = seg[(seg >= 0).all(1)].astype(np.int32)
        tri = local[self._triplets]
        col_np = tri[(tri >= 0).all(1)].astype(np.int32)
        connected = [[] for _ in range(len(ids))]
        for eid, (a, b) in enumerate(edges_np.tolist()):
            connected[a].append(eid)
            connected[b].append(eid)
        if self.cam.is_fisheye:
            uv_un = kb8_undistort_f64(self.cam, uv_v)
            w, h = self.cam.width, self.cam.height
            out = ~((uv_un[:, 0] >= 1) & (uv_un[:, 0] < w - 1)
                    & (uv_un[:, 1] >= 1) & (uv_un[:, 1] < h - 1))
        else:
            uv_un, out = uv_v.copy(), np.zeros(len(ids), bool)
        feats = FrameFeatures(
            kp_pos=uv_v, kp_pos_un=uv_un,
            kp_score=np.ones(len(ids), np.float32),
            kp_out=out, edges=edges_np,
            edge_score=np.full(len(edges_np), 0.5, np.float32),
            colines=col_np, connected=connected, desc=descs)
        return feats, ids


class SyntheticSequence:
    """Body motion simulated at IMU rate with the discrete model the
    preintegration assumes (so the preintegrated deltas are consistent with
    the frame poses); identity camera-body extrinsics unless Tbc is given.

    Tbc: the camera's mount (body-from-camera, 4x4). The motion (accel_fn:
    accelerations in the world, gyro_fn: rates, v0) is then the camera's,
    which starts at the world origin, and the IMU measures the body's: its
    rates are Rbc times the camera's, its acceleration the camera's plus
    that of the lever arm tcb turning with the camera."""

    def __init__(self, n_frames=120, fps=20.0, imu_hz=200.0, seed=3,
                 noise_px=0.0, desc_noise=0.02, scene=None, accel_fn=None,
                 v0=(0.25, 0.0, 0.05), gyro_fn=None, imu_noise=(0.0, 0.0),
                 Tbc=None):
        from .geometry import so3
        from .imu import GRAVITY_VALUE

        self.scene = scene or SyntheticScene(
            n_points=480, seed=seed, extent=((-3, 9), (-2, 4), (4, 10)))
        self.fps = fps
        self.noise_px = noise_px
        self.desc_noise = desc_noise
        g = np.float32([0, 0, -GRAVITY_VALUE])
        dt = 1.0 / imu_hz
        steps_per_frame = int(round(imu_hz / fps))
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        v = np.float32(v0)
        imu_rng = np.random.RandomState(seed + 991)
        self.frame_times = [0.0]
        self.imu = []  # rows (ax..az, wx..wz, t)
        if accel_fn is None:
            accel_fn = lambda tm: np.float32([
                0.8 * np.sin(1.1 * tm), 0.5 * np.cos(0.9 * tm),
                0.35 * np.sin(1.4 * tm)])
        if gyro_fn is None:
            gyro_fn = lambda tm: np.float32([
                0.10 * np.sin(0.6 * tm), 0.22 * np.cos(0.5 * tm),
                0.15 * np.sin(0.8 * tm)])
        self.Tbc = None if Tbc is None else np.asarray(Tbc, np.float32)
        if self.Tbc is not None:
            self.Rbc = self.Tbc[:3, :3].copy()
            self.tbc = self.Tbc[:3, 3].copy()
            tcb = (-self.Rbc.T @ self.tbc).astype(np.float32)
            R = self.Rbc.T.copy()  # Rwb = Rwc Rcb with Rwc = I
            t = tcb
            v = (v + np.cross(gyro_fn(0.0), tcb)).astype(np.float32)
        self.frame_poses = [(R.copy(), t.copy())]   # Twb (R=Rwb, t=twb)
        self.frame_vels = [v.copy()]
        k = 0
        for _ in range(1, n_frames):
            for _ in range(steps_per_frame):
                tm = k * dt
                a_w = accel_fn(tm)
                w_b = gyro_fn(tm)
                if self.Tbc is not None:  # w_b above is the camera's rate
                    alpha = (gyro_fn(tm + 1e-3) - gyro_fn(tm - 1e-3)) / 2e-3
                    a_w = (a_w + (R @ self.Rbc) @ (
                        np.cross(alpha, tcb)
                        + np.cross(w_b, np.cross(w_b, tcb)))).astype(
                            np.float32)
                    w_b = (self.Rbc @ w_b).astype(np.float32)
                a_body = (R.T @ (a_w - g)).astype(np.float32)
                if imu_noise[0] or imu_noise[1]:
                    a_meas = a_body + imu_rng.randn(3).astype(np.float32) \
                        * imu_noise[1]
                    w_meas = w_b + imu_rng.randn(3).astype(np.float32) \
                        * imu_noise[0]
                else:
                    a_meas, w_meas = a_body, w_b
                self.imu.append(np.concatenate(
                    [a_meas, w_meas, [tm + dt]]).astype(np.float64))
                t = t + v * dt + 0.5 * a_w * dt * dt
                v = v + a_w * dt
                R = R @ so3.exp(np.float32(w_b * dt)).astype(np.float32)
                k += 1
            self.frame_poses.append((R.copy(), t.copy()))
            self.frame_vels.append(v.copy())
            self.frame_times.append(k * dt)
        self.imu = np.stack(self.imu)
        self.n_frames = n_frames

    def frame_twc(self, i):
        """Camera i's pose in the world, (Rwc, twc)."""
        Rwb, twb = self.frame_poses[i]
        if self.Tbc is None:  # identity extrinsics: camera == body
            return Rwb, twb
        return ((Rwb @ self.Rbc).astype(np.float32),
                (Rwb @ self.tbc + twb).astype(np.float32))

    def frame_tcw(self, i):
        Rwc, twc = self.frame_twc(i)
        Rcw = Rwc.T
        return Rcw, (-Rcw @ twc).astype(np.float32)

    def imu_between(self, t0, t1):
        m = self.imu
        return m[(m[:, 6] > t0) & (m[:, 6] <= t1 + 1e-9)]


class SyntheticExtractor:
    """Drop-in for PPGExtractor driven by a SyntheticSequence (the port's
    copy of tests/synthetic_sequence.py's): the n-th `extract` call renders
    the scene from the sequence's frame n, whatever the image.

    desc_device: None gives host descriptors (desc_transfer="f32");
    a device gives the device-descriptor form (desc_transfer="device"):
    descriptors padded to 512 rows on that device, the host copy through
    desc_fetch."""

    def __init__(self, seq: SyntheticSequence, desc_device=None):
        self.seq = seq
        self.desc_device = desc_device
        self.frame_idx = 0
        self.last_ids = None

    def extract(self, image):
        i = self.frame_idx
        self.frame_idx += 1
        feats, ids = self.seq.scene.render(
            *self.seq.frame_tcw(i), noise=self.seq.noise_px,
            desc_noise=self.seq.desc_noise)
        self.last_ids = ids
        if self.desc_device is not None:
            host = feats.desc
            padded = torch.zeros((512, 256), dtype=torch.float32,
                                 device=self.desc_device)
            padded[:len(host)] = torch.from_numpy(host)
            feats.desc_dev = padded
            feats.desc = None
            feats.desc_fetch = lambda h=host: h
        return feats

    def extract_batch_async(self, images):
        """The frame prefetcher's call: a handle whose result() is the
        extract() of each image, in order."""
        import types

        feats = [self.extract(im) for im in images]
        return types.SimpleNamespace(result=lambda: feats)


def make_ring_scene(n_points=1200, seed=11, r_in=7.0, r_out=10.0,
                    center=(3.0, 0.0, 0.0), cam=CAM):
    """Annulus of landmarks around the loop circle's center: each camera
    heading sees only its local arc, so opposite sides of the loop share no
    landmarks (the covisibility graph cannot silently bridge the loop).
    Copy of tests/synthetic_sequence.py's, seen through `cam`."""
    rng = np.random.RandomState(seed)
    scene = SyntheticScene(n_points=24, seed=seed, cam=cam)  # line machinery
    phi = rng.uniform(0, 2 * np.pi, n_points)
    rr = rng.uniform(r_in, r_out, n_points)
    y = rng.uniform(-2.0, 2.5, n_points)
    pts = np.stack([center[0] + rr * np.sin(phi), center[1] + y,
                    center[2] + rr * np.cos(phi)], 1).astype(np.float32)
    scene.points = np.concatenate([pts, scene.points]).astype(np.float32)
    # the 24 line points from the box scene sit near the start view
    shift = len(pts)
    scene.triplets = [(a + shift, b + shift, c + shift)
                      for (a, b, c) in scene.triplets]
    scene.segments = [(a + shift, b + shift) for (a, b) in scene.segments]
    scene.n = len(scene.points)
    d = rng.randn(scene.n, 256).astype(np.float32)
    scene.descs = d / np.linalg.norm(d, axis=1, keepdims=True)
    return scene


def make_loop_sequence(n_frames=240, fps=20.0, noise_px=0.5, seed=11,
                       cam=CAM, Tbc=None, overrun=0):
    """Closed circular trajectory with tangent heading (copy of
    tests/synthetic_sequence.py's):

      p(t) = Rc * [1 - cos(theta), 0, sin(theta)],  R(t) = Ry(theta)

    with theta(t) = w t + A sin(W t), so the body yaws a full 360 deg while
    circling, always looking at the local arc of a landmark ring (a constant
    rate would leave metric scale unobservable to the IMU). Yaw drifts
    monocular-inertially; start and far side share NO landmarks, so on
    return the drift must be absorbed by loop closure. Closes exactly at
    t = T. The trajectory is the camera's, seen through `cam` and mounted
    by `Tbc` (SyntheticSequence). A fisheye's start and far-side views
    still share no landmark: each sees only points 0.3 m or more in front
    of it, and they face opposite ways across the loop's center.

    overrun: frames past the closure, along the same circle, so the camera
    sees the start's views once more; n_frames sets the speed either way."""
    T = (n_frames - 1) / fps
    w = 2 * np.pi / T
    Rc = 3.0
    A, W = 0.35, 1.1

    def theta(tm):
        return w * tm + A * np.sin(W * tm)

    def dtheta(tm):
        return w + A * W * np.cos(W * tm)

    def ddtheta(tm):
        return -A * W * W * np.sin(W * tm)

    def accel(tm):
        th, d1, d2 = theta(tm), dtheta(tm), ddtheta(tm)
        return np.float32([
            Rc * (d2 * np.sin(th) + d1 * d1 * np.cos(th)),
            -0.15 * 1.3 * 1.3 * np.sin(1.3 * tm),
            Rc * (d2 * np.cos(th) - d1 * d1 * np.sin(th)),
        ])

    def gyro(tm):
        return np.float32([0.0, dtheta(tm), 0.0])

    scene = make_ring_scene(seed=seed, center=(Rc, 0.0, 0.0), cam=cam)
    return SyntheticSequence(
        n_frames=n_frames + overrun, fps=fps, noise_px=noise_px, seed=seed,
        scene=scene, accel_fn=accel, gyro_fn=gyro,
        v0=(0.0, 0.15 * 1.3, Rc * dtheta(0.0)), Tbc=Tbc)


# ---------------------------------------------------------------------------
# rendered corridor: real images the PPG nets respond to, with the IMU of
# the trajectory (a numpy port of bench.py's wireframe corridor, which
# draws with OpenCV; the port's machine has no OpenCV)
# ---------------------------------------------------------------------------

# the corridor's IMU: a consumer-grade unit, 10x EuRoC's noise densities
# (bench.py E2E_NOISE_GYRO / E2E_NOISE_ACC)
CORRIDOR_NOISE_GYRO = 1.7e-3
CORRIDOR_NOISE_ACC = 2e-2


def _resize_bilinear(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w) bilinear resize of a 2-D array, pixel centres aligned."""
    ys = np.clip((np.arange(h) + 0.5) * a.shape[0] / h - 0.5, 0,
                 a.shape[0] - 1)
    xs = np.clip((np.arange(w) + 0.5) * a.shape[1] / w - 0.5, 0,
                 a.shape[1] - 1)
    return _sample_bilinear(a.astype(np.float32), xs[None, :], ys[:, None])


def _sample_bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray,
                     border: float = 0.0) -> np.ndarray:
    """img sampled at float pixel coordinates (x, y), bilinear; `border`
    where the sample falls outside."""
    h, w = img.shape
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    fx, fy = x - x0, y - y0
    top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
    bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
    return np.where(inside, top * (1 - fy) + bot * fy, border)


def _draw_segment(img: np.ndarray, p: np.ndarray, q: np.ndarray,
                  value: float, half_width: float = 1.0) -> None:
    """An anti-aliased segment of width 2 * half_width px from p to q
    (pixel coordinates) blended into the float image: coverage 1 within
    half_width - 0.5 of the segment, falling linearly to 0 a pixel out."""
    h, w = img.shape
    r = half_width + 0.5
    x0 = max(int(np.floor(min(p[0], q[0]) - r)), 0)
    x1 = min(int(np.ceil(max(p[0], q[0]) + r)), w - 1)
    y0 = max(int(np.floor(min(p[1], q[1]) - r)), 0)
    y1 = min(int(np.ceil(max(p[1], q[1]) + r)), h - 1)
    if x1 < x0 or y1 < y0:
        return
    xs, ys = np.meshgrid(np.arange(x0, x1 + 1, dtype=np.float64),
                         np.arange(y0, y1 + 1, dtype=np.float64))
    d = q - p
    n2 = float(d @ d)
    t = np.zeros_like(xs) if n2 < 1e-12 else np.clip(
        ((xs - p[0]) * d[0] + (ys - p[1]) * d[1]) / n2, 0.0, 1.0)
    dist = np.hypot(xs - (p[0] + t * d[0]), ys - (p[1] + t * d[1]))
    a = np.clip(r - dist, 0.0, 1.0)
    patch = img[y0:y1 + 1, x0:x1 + 1]
    patch += a * (value - patch)


def render_corridor(n_frames: int = 120, seed: int = 7, speed: float = 0.10,
                    cam=EUROC_CAM, Tbc=None,
                    noise_gyro: float = CORRIDOR_NOISE_GYRO,
                    noise_acc: float = CORRIDOR_NOISE_ACC,
                    fps: float = 20.0, imu_hz: float = 200.0,
                    reach: float = 0.0):
    """An irregular wireframe corridor seen by `cam` (bench.py's live
    corridor): randomized bars and rails on a wall at z = 4.2 m with a
    world-fixed two-scale texture warped into each frame by the plane's
    homography (bilinear), free segments in front of it, 2-px anti-aliased
    lines and +-8 grey levels of noise; `reach` m more wall on every side,
    with rails and free segments as dense, for a wide field of view. The
    body moves at `speed` m a frame with sinusoidal excitation on all axes
    (accelerations in the world, rates in the body), integrated at imu_hz
    with the discrete model the
    preintegration assumes; gravity is +y in the world (image down). The
    camera is mounted by Tbc (body-from-camera, 4x4; identity when None)
    and starts at the world origin. IMU rows (ax, ay, az, wx, wy, wz, t)
    carry white noise of the given densities; the poses are the clean
    signal's. Frame k is at k / fps; the IMU ticks at imu_hz, and a frame
    between two ticks gets the body state propagated from the tick before
    it by the same model. Everything is numpy, made from `seed`.

    Returns a namespace: frames (uint8 images), times, cam_poses [(Rcw,
    tcw)], body_poses [(Rwb, twb)], body_vels, imu (M, 7), gravity (3,)."""
    import types

    from .geometry import so3

    rng = np.random.RandomState(seed)
    segs, vals = [], []
    x0, x1 = -3.0 - reach, max(5.0, speed * n_frames + 4.0) + reach
    half = 1.8 + reach  # the bars' half height
    x = x0
    while x < x1:
        tilt = rng.uniform(-0.35, 0.35)
        segs.append(((x, -half, 4.2), (x + tilt, half, 4.2)))
        vals.append(int(rng.randint(170, 255)))
        x += rng.uniform(0.35, 0.95)
    for y in np.linspace(-half, half, 10):
        dy = rng.uniform(-0.15, 0.15)
        segs.append(((x0, y, 4.2), (x1, y + dy, 4.2)))
        vals.append(int(rng.randint(170, 255)))
    for xc in np.arange(x0 + 1, x1, 0.35):
        for _ in range(1 + int(reach)):  # as dense over the taller wall
            p = np.array([xc, 0, 0]) + rng.uniform(
                [-0.4, -1.5 - reach, 2.6 - 0.4 * reach],
                [0.4, 1.5 + reach, 3.9])
            q = p + rng.uniform([-1.0, -1.0, -0.3], [1.0, 1.0, 0.3])
            segs.append((tuple(p), tuple(q)))
            vals.append(int(rng.randint(170, 255)))
    seg_p = np.asarray([s[0] for s in segs], np.float64)
    seg_q = np.asarray([s[1] for s in segs], np.float64)

    # world-fixed wall texture on the plane z = 4.2
    s = 96.0  # texture px per meter
    wx0, wy0 = x0 - 1.5, -2.4 - reach
    tw, th = int((x1 + 1.5 - wx0) * s), int((-2 * wy0) * s)
    t1 = _resize_bilinear(rng.randint(0, 255, (th // 8, tw // 8)), th, tw)
    t2 = _resize_bilinear(rng.randint(0, 255, (th // 32, tw // 32)), th, tw)
    tex = np.clip(110.0 + (t1 - 127.0) * 0.18 + (t2 - 127.0) * 0.25, 0, 255)
    tex = np.floor(tex).astype(np.float32)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    Btex = np.array([[1.0 / s, 0, wx0], [0, 1.0 / s, wy0], [0, 0, 4.2]])

    Tbc = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64)
    Rbc, tbc = Tbc[:3, :3].astype(np.float32), Tbc[:3, 3].astype(np.float32)
    dt = 1.0 / imu_hz
    g = np.float32([0.0, 9.81, 0.0])
    bx, wx = 0.22, 4.0
    by, wy = 0.30, 3.4
    bz, wz = 0.15, 2.6

    def accel_w(tm):
        return np.float32([-bx * wx * wx * np.sin(wx * tm),
                           -by * wy * wy * np.sin(wy * tm),
                           -bz * wz * wz * np.sin(wz * tm)])

    def gyro_b(tm):
        return np.float32([0.22 * np.sin(2.2 * tm), 0.20 * np.cos(4.0 * tm),
                           0.22 * np.sin(1.8 * tm)])

    sg = noise_gyro * np.sqrt(imu_hz)
    sa = noise_acc * np.sqrt(imu_hz)
    imu_rng = np.random.RandomState(seed + 7)
    # the body starts where the camera sits at the world origin
    Rwb = Rbc.T.copy()
    twb = (-Rbc.T @ tbc).astype(np.float32)
    vel = np.float32([speed * fps + bx * wx, by * wy, bz * wz])
    body_poses = [(Rwb.copy(), twb.copy())]
    body_vels = [vel.copy()]
    imu_rows = []
    kk = 0
    for k in range(1, n_frames):
        t_frame = k / fps
        while (kk + 1) * dt <= t_frame + 1e-9:
            tm = kk * dt
            a_w = accel_w(tm)
            w_b = gyro_b(tm)
            a_meas = (Rwb.T @ (a_w - g) + imu_rng.randn(3) * sa).astype(
                np.float32)
            w_meas = (w_b + imu_rng.randn(3) * sg).astype(np.float32)
            imu_rows.append(np.concatenate([a_meas, w_meas, [tm + dt]]))
            twb = twb + vel * dt + 0.5 * a_w * dt * dt
            vel = vel + a_w * dt
            Rwb = Rwb @ so3.exp(np.float32(w_b * dt)).astype(np.float32)
            kk += 1
        tau = t_frame - kk * dt  # the frame falls tau after the last tick
        if tau < 1e-9:
            body_poses.append((Rwb.copy(), twb.copy()))
            body_vels.append(vel.copy())
        else:
            a_w, w_b = accel_w(kk * dt), gyro_b(kk * dt)
            body_poses.append((
                Rwb @ so3.exp(np.float32(w_b * tau)).astype(np.float32),
                twb + vel * tau + 0.5 * a_w * tau * tau))
            body_vels.append(vel + a_w * tau)

    frames, cam_poses = [], []
    img_rng = np.random.RandomState(seed + 100)
    vs, us = np.mgrid[0:cam.height, 0:cam.width].astype(np.float64)
    for Rwb_k, twb_k in body_poses:
        Rwc = Rwb_k.astype(np.float64) @ Rbc
        twc = Rwb_k.astype(np.float64) @ tbc + twb_k
        Rcw = Rwc.T
        tcw = -Rcw @ twc
        M = Rcw @ Btex
        M[:, 2] += tcw
        Hinv = np.linalg.inv(K @ M)  # image -> texture px
        den = Hinv[2, 0] * us + Hinv[2, 1] * vs + Hinv[2, 2]
        img = _sample_bilinear(
            tex, (Hinv[0, 0] * us + Hinv[0, 1] * vs + Hinv[0, 2]) / den,
            (Hinv[1, 0] * us + Hinv[1, 1] * vs + Hinv[1, 2]) / den,
            border=110.0)
        Pc = seg_p @ Rcw.T + tcw
        Qc = seg_q @ Rcw.T + tcw
        for pc, qc, v in zip(Pc, Qc, vals):
            if pc[2] < 0.5 or qc[2] < 0.5:
                continue
            _draw_segment(img, K[:2] @ (pc / pc[2]), K[:2] @ (qc / qc[2]),
                          float(v))
        noise = img_rng.randint(-8, 8, img.shape)
        frames.append(np.clip(np.rint(img) + noise, 0, 255).astype(np.uint8))
        cam_poses.append((Rcw.astype(np.float32), tcw.astype(np.float32)))
    return types.SimpleNamespace(
        frames=frames, times=[k / fps for k in range(n_frames)],
        cam_poses=cam_poses, body_poses=body_poses, body_vels=body_vels,
        imu=np.stack(imu_rows).astype(np.float64), gravity=g, fps=fps)


CORRIDOR_BORDER = 110.0  # the wall's grey: the renders' border value


def fisheye_canvas(cam, max_theta: float = 1.2, max_half_width: float = 800.0):
    """The pinhole camera whose render distort_frames resamples into the
    Kannala-Brandt image `cam`: same optical axis, a field of view that
    holds every ray of the image up to `max_theta` rad off the axis (rays
    beyond it get the border grey), its focal length `cam`'s own or less,
    so that the canvas is at most 2 * max_half_width px wide."""
    from .geometry.cameras import CAM_PINHOLE, CameraModel

    h, w = cam.height, cam.width
    edge = np.concatenate([
        np.stack([np.arange(w), np.zeros(w)], 1),
        np.stack([np.arange(w), np.full(w, h - 1)], 1),
        np.stack([np.zeros(h), np.arange(h)], 1),
        np.stack([np.full(h, w - 1), np.arange(h)], 1)]).astype(np.float32)
    b = cam.unproject_np(edge)
    tan_max = np.tan(max_theta)
    ex = float(np.minimum(np.abs(b[:, 0]), tan_max).max())
    ey = float(np.minimum(np.abs(b[:, 1]), tan_max).max())
    f = min(cam.fx, cam.fy, max_half_width / max(ex, ey))
    cx, cy = np.ceil(f * ex) + 1.0, np.ceil(f * ey) + 1.0
    return CameraModel(kind=CAM_PINHOLE, fx=f, fy=f, cx=cx, cy=cy,
                       dist=(0.0, 0.0, 0.0, 0.0), width=int(2 * cx) + 1,
                       height=int(2 * cy) + 1, fps=cam.fps)


def distortion_source_map(cam, canvas=None, max_theta: float = 1.2):
    """(H, W, 2) f32: for each pixel d of `cam`'s image, the point of the
    clean render that d sees, NaN where it sees none. radtan (a pinhole
    with distortion): the render shares `cam`'s K and d reads
    cam.undistort_points(d), cv::undistortPoints' 5 compensation steps.
    Kannala-Brandt: the render is the pinhole `canvas` and d reads the
    canvas pixel of its ray, cam.unproject_np(d); rays more than
    `max_theta` rad off the axis are NaN."""
    h, w = cam.height, cam.width
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    d = np.stack([uu, vv], -1)
    if not cam.is_fisheye:
        if canvas is not None:
            raise ValueError("a radtan camera reads a render of its own K")
        return cam.undistort_points(torch.from_numpy(d)).numpy()
    b = cam.unproject_np(d)
    theta = np.arctan(np.hypot(b[..., 0], b[..., 1]))
    src = np.stack([canvas.fx * b[..., 0] + canvas.cx,
                    canvas.fy * b[..., 1] + canvas.cy], -1)
    ok = np.isfinite(src).all(-1) & (theta <= max_theta)
    return np.where(ok[..., None], src, np.nan).astype(np.float32)


def distort_frames(frames, cam, canvas=None, max_theta: float = 1.2,
                   border: float = CORRIDOR_BORDER):
    """Clean renders resampled into the images `cam` takes (bench.py's
    _distort_frames without cv2): pixel d of the result is the bilinear
    sample of the render at distortion_source_map(cam, canvas)[d], so a
    world point appears where the distorted camera images it (lines curve,
    the fisheye edge compresses). radtan: `frames` are renders of `cam`'s
    own K (canvas None). Kannala-Brandt: renders of `canvas`
    (fisheye_canvas(cam)). Pixels that see no point of the render get
    `border`. uint8 frames give uint8 (rounded), others float32."""
    src = distortion_source_map(cam, canvas, max_theta)
    ok = np.isfinite(src).all(-1)
    x = np.where(ok, src[..., 0], -1.0)
    y = np.where(ok, src[..., 1], -1.0)
    out = []
    for f in frames:
        f = np.asarray(f)
        v = _sample_bilinear(f.astype(np.float32), x, y, border=border)
        out.append(np.clip(np.rint(v), 0, 255).astype(np.uint8)
                   if f.dtype == np.uint8 else v.astype(np.float32))
    return out


def write_uma_folder(corridor, root: str, t0_ns: int = 1_000_000_000,
                     frames=None) -> str:
    """write_asl_folder in the UMA-VI layout that datasets.load_uma reads
    (try_uma.cpp): cam0/ and imu0/ at the sequence root, no mav0/.
    Returns the ground-truth file's path."""
    return write_asl_folder(corridor, root, t0_ns, frames, prefix="")


def write_asl_folder(corridor, root: str, t0_ns: int = 1_000_000_000,
                     frames=None, prefix: str = "mav0") -> str:
    """Write a rendered corridor (render_corridor's namespace) as a EuRoC
    ASL folder under `root`: mav0/cam0/data/<ns>.png (8-bit grey, through
    datasets/png.py) + mav0/cam0/data.csv, mav0/imu0/data.csv (t[ns], w,
    a) and the body trajectory in TUM format (gt_body.txt: the poses the
    CLI's CameraTrajectory.txt writes), with frame k at t0_ns + k / fps.
    frames: the frame indices to write (default all; the IMU is written
    whole). prefix: the folder that holds cam0/ and imu0/ ("" for the
    UMA-VI layout, write_uma_folder). Returns the ground-truth file's
    path."""
    import os

    from .datasets.png import write_png
    from .geometry import so3

    idx = range(len(corridor.frames)) if frames is None else frames
    seq = os.path.join(root, prefix)
    data = os.path.join(seq, "cam0", "data")
    os.makedirs(data, exist_ok=True)
    os.makedirs(os.path.join(seq, "imu0"), exist_ok=True)

    def ns(t):
        return t0_ns + int(round(t * 1e9))

    rows, gt = [], []
    for k in idx:
        t = ns(corridor.times[k])
        write_png(os.path.join(data, f"{t}.png"), corridor.frames[k])
        rows.append(f"{t},{t}.png")
        Rwb, twb = corridor.body_poses[k]
        q = so3.matrix_to_quat(np.asarray(Rwb, np.float32))
        gt.append(f"{t * 1e-9:.9f} " + " ".join(
            f"{v:.9f}" for v in (*twb, *q)))
    with open(os.path.join(seq, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    with open(os.path.join(seq, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,"
                "a_RS_S_y,a_RS_S_z\n")
        for r in corridor.imu:
            f.write(f"{ns(r[6])}," + ",".join(
                repr(float(v)) for v in (*r[3:6], *r[:3])) + "\n")
    gt_path = os.path.join(root, "gt_body.txt")
    with open(gt_path, "w") as f:
        f.write("\n".join(gt) + "\n")
    return gt_path


def sqrtm_psd_inv(M: np.ndarray) -> np.ndarray:
    """sqrt of the PSD-projected inverse (the tracker's whitening factor)."""
    M = 0.5 * (M + M.T)
    info = np.linalg.inv(M + 1e-14 * np.eye(len(M)))
    w, V = np.linalg.eigh(0.5 * (info + info.T))
    w = np.clip(w, 0, None)
    return ((V * np.sqrt(w)) @ V.T).astype(np.float32)


def preint_data(p, device):
    """PreintData of a Preintegrated on `device`, built as the tracker
    builds it for pose_inertial_optimization."""
    from .estimator import PreintData

    st = p.state
    C = np.asarray(st.C, np.float64)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return PreintData(
        dR=f(st.dR), dV=f(st.dV), dP=f(st.dP), JRg=f(st.JRg), JVg=f(st.JVg),
        JVa=f(st.JVa), JPg=f(st.JPg), JPa=f(st.JPa), b0=f(p.b),
        sqi=f(sqrtm_psd_inv(C[:9, :9])), sqig=f(sqrtm_psd_inv(C[9:12, 9:12])),
        sqia=f(sqrtm_psd_inv(C[12:15, 12:15])), dt=f(np.float32(st.dT)))


# configs/tumvi.yaml's 512x512 Kannala-Brandt camera
TUMVI_CAM_KW = dict(fx=190.978477, fy=190.973307, cx=254.931706,
                    cy=256.897442, dist=(0.003482389402, 0.000715034845,
                                         -0.002053236141, 0.000202936736),
                    width=512, height=512)


def pose_inertial_case(n_obs: int, fix_prev: bool, seed: int = 0,
                       cam=None, n_imu: int = 10, outliers: float = 0.1):
    """Host (numpy) arguments of a tracked frame's pose-inertial call, in
    PoseInertialReplay's order: a dict of curr, prev (5 arrays each),
    preint (13), prior (6), prior_valid, X, uv, valid, close, Rcb, tcb.
    The body moves 0.1 m in 0.05 s (IMU samples of the discrete model the
    preintegration assumes) and turns 0.05 rad; n_obs points 3-8 m ahead,
    seen with 0.5 px of noise and an `outliers` share of them 20-60 px
    off; the current state perturbed. fix_prev: the LastKeyFrame variant's
    zero, invalid prior."""
    from .geometry import so3
    from .geometry.cameras import CAM_FISHEYE, CameraModel
    from .imu import GRAVITY_VALUE
    from .imu.preintegration import integrate

    cam = cam or CameraModel(kind=CAM_FISHEYE, **TUMVI_CAM_KW)
    rng = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    R0 = f32(so3.exp(f32(rng.randn(3) * 0.1)))
    t0 = f32(rng.randn(3))
    v0 = f32([1.8, -0.3, 0.4])
    w = f32([0.2, 1.0, -0.3])                # rad/s in the body
    dtm = np.full(n_imu, 0.005, np.float32)
    dT = float(dtm.sum())
    a_total = f32(2.0 * (f32([0.06, 0.02, 0.08]) - v0 * dT) / dT ** 2)
    g = f32([0, 0, -GRAVITY_VALUE])
    R, v, accs = R0.copy(), v0.copy(), []
    for k in range(n_imu):
        accs.append(f32(R.T @ (a_total - g)))
        v = v + a_total * dtm[k]
        R = f32(R @ so3.exp(w * dtm[k]))
    t1 = f32(t0 + v0 * dT + 0.5 * a_total * dT ** 2)
    st = integrate(torch.from_numpy(np.stack(accs)),
                   torch.from_numpy(np.tile(w, (n_imu, 1))),
                   torch.from_numpy(dtm), torch.ones(n_imu, dtype=torch.bool),
                   torch.zeros(6), torch.full((6,), 1e-5),
                   torch.full((6,), 1e-8))
    preint = [st.dR, st.dV, st.dP, st.JRg, st.JVg, st.JVa, st.JPg, st.JPa]
    preint = [f32(x) for x in preint] + [
        np.zeros(6, np.float32), f32(np.eye(9) * 50.0),
        f32(np.eye(3) * 100.0), f32(np.eye(3) * 100.0), np.float32(dT)]
    Rcb = f32(so3.exp(f32([0.01, -0.02, 0.015])))
    tcb = f32([0.02, -0.01, 0.005])
    # points ahead of the camera at frame 1, into the world
    Xc = np.stack([rng.uniform(-3, 3, n_obs), rng.uniform(-3, 3, n_obs),
                   rng.uniform(3, 8, n_obs)], 1)
    X = f32((Rcb.T @ (Xc - tcb).T).T @ R.T + t1)
    uv = cam.project(torch.from_numpy(f32(Xc))).numpy()
    uv = uv + rng.randn(n_obs, 2) * 0.5
    bad = rng.rand(n_obs) < outliers
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2)) * rng.choice(
        [-1, 1], (int(bad.sum()), 2))
    z = np.zeros(3, np.float32)
    dR = so3.exp(f32([0.01, 0.02, -0.01]))
    curr = [f32(R @ dR), f32(t1 + f32([0.03, -0.02, 0.04])),
            f32(v + f32([0.1, 0.0, -0.1])), z, z]
    prev = [R0, t0, v0, z, z]
    if fix_prev:
        prior = [np.eye(3, dtype=np.float32), z, z, z, z,
                 np.zeros((15, 15), np.float32)]
    else:
        prior = [R0, t0, v0, z, z, f32(np.eye(15) * 1e4)]
    return dict(curr=curr, prev=prev, preint=preint, prior=prior,
                prior_valid=not fix_prev, X=X, uv=f32(uv),
                valid=np.ones(n_obs, bool), close=rng.rand(n_obs) < 0.3,
                Rcb=Rcb, tcb=tcb)


# ---------------------------------------------------------------------------
# world maps built from rendered views (shared by the port's tests, which
# build the same map in both packages, and by chip_smoke.py's estimator
# phase). `pkg` is any namespace with the attributes `wm` (a worldmap
# module), `Features` (a FrameFeatures class), `cam` and `Preintegrated` (a
# callable (bias, nga, nga_walk) -> Preintegrated).
# ---------------------------------------------------------------------------

def feature_kwargs(feats) -> dict:
    """FrameFeatures -> the keyword arguments that rebuild it in either
    package."""
    return {k: getattr(feats, k) for k in
            ("kp_pos", "kp_pos_un", "kp_score", "kp_out", "edges",
             "edge_score", "colines", "connected", "desc")}


def render_views(scene, poses, noise=0.0, subsets=None):
    """[(feature kwargs, visible global ids)] of the camera poses (each
    seeing only its subset of the scene's points, where given)."""
    out = []
    for k, (Rcw, tcw) in enumerate(poses):
        feats, ids = scene.render(Rcw, tcw, noise=noise,
                                  subset=None if subsets is None
                                  else subsets[k])
        out.append((feature_kwargs(feats), ids))
    return out


def perturbation(n_kf, n_pts, noise_pose=0.02, noise_pt=0.03, seed=61):
    """(dR list, dt list, point offsets): the error put on KFs 2.. and on
    every point before a BA."""
    from .geometry import so3

    rng = np.random.RandomState(seed)
    dRs, dts = [], []
    for _ in range(n_kf - 2):
        dRs.append(so3.exp(rng.randn(3).astype(np.float32) * noise_pose))
        dts.append(rng.randn(3).astype(np.float32) * noise_pose * 2)
    return dRs, dts, rng.randn(n_pts, 3).astype(np.float32) * noise_pt


def imu_links(seq, times):
    """(acc, gyr, dt) of the IMU samples between consecutive `times`."""
    links = []
    for a, b in zip(times[:-1], times[1:]):
        m = seq.imu_between(a, b)
        links.append((m[:, :3].astype(np.float32),
                      m[:, 3:6].astype(np.float32),
                      np.diff(np.concatenate([[a], m[:, 6]])).astype(
                          np.float32)))
    return links


def build_map(pkg, poses, views, points, pert, times, imu=None, keep=None,
              colines=False, vocabulary=None, Tbc=None):
    """A map of keyframes at `poses` observing `points` through `views`,
    with the perturbation `pert` applied to KFs 2.. and all points.

    imu: (per-link measurements, KF velocities), where a link's
    measurements are (acc, gyr, dt) to integrate or an integrated
    Preintegrated to copy; keep: per-KF
    boolean masks over the view's keypoints that become observations (all
    when None); colines: create the map colines of every KF's colinear
    triplets (Map.create_map_colines); vocabulary: the map's, indexing
    every KF's BoW vector; Tbc: the rig's camera mount (identity when
    None). Returns (map, keyframes, {global id: MapPoint})."""
    rig = pkg.wm.Rig(pkg.cam, Tbc)
    wm = pkg.wm.Map(rig, vocabulary=vocabulary)
    kfs, id_to_mp, prev = [], {}, None
    for k, ((Rcw, tcw), (feats, ids)) in enumerate(zip(poses, views)):
        f = pkg.wm.Frame(pkg.Features(**feats), timestamp=times[k], rig=rig)
        f.set_pose(Rcw, tcw)
        kf = pkg.wm.KeyFrame(f, wm)
        kf.prev_kf = prev
        if prev is not None:
            prev.next_kf = kf
        prev = kf
        kfs.append(kf)
        for i, g in enumerate(ids):
            if keep is not None and not keep[k][i]:
                continue
            mp = id_to_mp.get(g)
            if mp is None:
                mp = id_to_mp[g] = pkg.wm.MapPoint(points[g], kf)
                wm.add_map_point(mp)
            mp.add_observation(kf, i)
            kf.add_map_point(mp, i)
        if vocabulary is not None:
            kf.bow_vec, kf.feat_vec = vocabulary.transform(kf.descriptors)
        wm.add_keyframe(kf)
    for kf in kfs:
        kf.update_connections()
    for mp in id_to_mp.values():
        mp.update_normal_and_depth()
    if colines:
        for kf in kfs:
            wm.create_map_colines(kf)
    if imu is not None:
        links, vels = imu
        for kf, v in zip(kfs, vels):
            kf.velocity = np.asarray(v, np.float32).copy()
        for kf, meas in zip(kfs[1:], links):
            if hasattr(meas, "copy"):
                kf.preintegrated = meas.copy()
                continue
            p = pkg.Preintegrated(np.zeros(6), rig.nga, rig.nga_walk)
            p.integrate_measurements(*meas)
            kf.preintegrated = p
        wm.imu_initialized = True
    dRs, dts, dps = pert
    for kf, dR, dt in zip(kfs[2:], dRs, dts):
        kf.set_pose(dR @ kf.Rcw, kf.tcw + dt)
    for g, mp in id_to_mp.items():
        mp.pos = mp.pos + dps[g]
    return wm, kfs, id_to_mp


def small_gba_map(n_kfs=6, seed=5, noise_pt=0.02):
    """A small consistent map of the port's world-map classes with noisy
    points for a global BA to polish (copy of tests/test_async.py's
    build_small_map). Returns (map, keyframes, scene)."""
    from . import worldmap as wm

    rng = np.random.RandomState(seed)
    scene = SyntheticScene(seed=seed)
    rig = wm.Rig(CAM, freq=200.0)
    wmap = wm.Map(rig)
    kfs, id_to_mp, prev = [], {}, None
    for k in range(n_kfs):
        Rcw, tcw = scene.pose(k * 4)
        feats, ids = scene.render(Rcw, tcw)
        f = wm.Frame(feats, timestamp=0.2 * k, rig=rig)
        f.set_pose(Rcw, tcw)
        kf = wm.KeyFrame(f, wmap)
        kf.prev_kf = prev
        if prev is not None:
            prev.next_kf = kf
        prev = kf
        kfs.append(kf)
        for i, g in enumerate(ids):
            mp = id_to_mp.get(g)
            if mp is None:
                mp = wm.MapPoint(scene.points[g], kf)
                mp.descriptor = scene.descs[g].copy()
                id_to_mp[g] = mp
                wmap.add_map_point(mp)
            mp.add_observation(kf, i)
            kf.add_map_point(mp, i)
        wmap.add_keyframe(kf)
    for kf in kfs:
        kf.update_connections()
    for mp in id_to_mp.values():
        mp.update_normal_and_depth()
        mp.pos = mp.pos + rng.randn(3).astype(np.float32) * noise_pt
    wmap.kf_origin = kfs[0]
    return wmap, kfs, scene


def pose_graph_ring(n_kf, seed=0, covis=3, four_dof=False):
    """A drifted essential graph of `n_kf` keyframes on a circle: a world
    drift accumulates along the keyframes (a random walk of small Sim3s;
    world yaw and translation only, where four_dof), the temporal chain and
    covisibility edges to the next `covis` keyframes are measured from the
    drifted poses (the map's own relative poses), and one loop edge
    (last -> 0) from the truth. Returns a dict of f32/int64 numpy arrays:
    drifted Rcw, tcw, s (Scw vertices); true Rcw, tcw; edges i, j and Sji
    (SR, St, Ss); the 4-DoF forms Rwb, twb, dRij, dtij; fixed (KF 0)."""
    from .geometry import so3

    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(n_kf) / n_kf
    radius = max(2.0, n_kf * 0.05)
    Rwc = so3.exp(np.stack([np.zeros(n_kf), np.zeros(n_kf), ang], 1)
                  .astype(np.float32))
    twc = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                    np.zeros(n_kf)], 1).astype(np.float32)
    DR, Dt, Ds = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0
    Rd, td, sd = [], [], []
    for k in range(n_kf):
        if k:
            w = (np.float32([0.0, 0.0, 0.004 * rng.randn()]) if four_dof
                 else rng.randn(3).astype(np.float32) * 0.003)
            dt = rng.randn(3).astype(np.float32) * 0.01
            ds = 1.0 if four_dof else float(1.0 + 0.002 * rng.randn())
            Dt = Ds * DR @ dt + Dt
            DR = DR @ so3.exp(w)
            Ds *= ds
        R_, t_ = DR @ Rwc[k], Ds * DR @ twc[k] + Dt   # D o Twc, scale Ds
        Rd.append(R_.T)
        td.append(-(R_.T @ t_) / Ds)
        sd.append(1.0 / Ds)
    Rd = np.stack(Rd).astype(np.float32)
    td = np.stack(td).astype(np.float32)
    sd = np.asarray(sd, np.float32)
    Rcw = np.transpose(Rwc, (0, 2, 1)).copy()
    tcw = -np.einsum("nij,nj->ni", Rcw, twc).astype(np.float32)

    def rel(R, t, s, i, j):  # Sji = Sj Si^-1
        Rji = R[j] @ R[i].T
        sji = s[j] / s[i]
        return Rji, t[j] - sji * Rji @ t[i], sji

    ii, jj = [], []
    for k in range(n_kf - 1):
        for d in range(1, covis + 2):
            if k + d < n_kf:
                ii.append(k)
                jj.append(k + d)
    meas = [rel(Rd, td, sd, i, j) for i, j in zip(ii, jj)]
    ii.append(n_kf - 1)
    jj.append(0)
    meas.append(rel(Rcw, tcw, np.ones(n_kf, np.float32), n_kf - 1, 0))
    SR = np.stack([m[0] for m in meas]).astype(np.float32)
    St = np.stack([m[1] for m in meas]).astype(np.float32)
    Ss = np.asarray([m[2] for m in meas], np.float32)
    # Edge4DoF's Ti<-j from Sji (scale 1): the inverse rigid transform
    dRij = np.transpose(SR, (0, 2, 1)).copy()
    dtij = -np.einsum("nij,nj->ni", dRij, St).astype(np.float32)
    Rwb = np.transpose(Rd, (0, 2, 1)).copy()
    twb = -np.einsum("nij,nj->ni", Rwb, td).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return dict(Rcw=Rd, tcw=td, s=sd, Rcw_true=Rcw, tcw_true=tcw,
                i=np.asarray(ii, np.int64), j=np.asarray(jj, np.int64),
                SR=SR, St=St, Ss=Ss, Rwb=Rwb, twb=twb, dRij=dRij, dtij=dtij,
                fixed=fixed)


def sim3_matches(n=200, s=1.2, outliers=0.3, seed=5, cam=CAM):
    """Matched camera-frame points of two keyframes for the Sim3 RANSAC:
    X1 = s R X2 + t, 0.5 px of pixel noise, a share `outliers` of the X2
    displaced. Returns (X1, X2, uv1, uv2, (R, t, s), outlier indices)."""
    from .geometry import so3

    rng = np.random.RandomState(seed)
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    R = so3.exp(np.float32([0.05, -0.1, 0.08]))
    t = np.float32([0.3, -0.1, 0.2])
    X2 = (((X1 - t) @ R) / s).astype(np.float32)
    uv1 = cam.project_np(X1) + rng.randn(n, 2).astype(np.float32) * 0.5
    uv2 = cam.project_np(X2) + rng.randn(n, 2).astype(np.float32) * 0.5
    bad = rng.choice(n, int(outliers * n), replace=False)
    X2[bad] += rng.randn(len(bad), 3).astype(np.float32) * 0.5
    return (X1, X2, uv1.astype(np.float32), uv2.astype(np.float32),
            (R, t, s), bad)


def sim3_pair(m=60, n_bad=8, seed=31, cam=CAM):
    """OptimizeSim3's input (tests/test_pose_graph.py's TestOptimizeSim3
    recipe): m points seen from two cameras related by a Sim3, n_bad of
    the camera-1 pixels displaced, and a perturbed initial Sim3. Returns
    ((R0, t0, s0), X1, X2, uv1, uv2, (R, t, s), outlier indices)."""
    from .geometry import so3
    from .geometry.sim3 import Sim3

    rng = np.random.RandomState(seed)
    X1 = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m),
                   rng.uniform(4, 8, m)], 1).astype(np.float32)
    R = so3.exp(np.float32([0.05, -0.1, 0.08]))
    t = np.float32([0.4, -0.2, 0.3])
    s = np.float32(1.35)
    X2 = (((X1 - t) @ R) / s).astype(np.float32)
    uv1 = cam.project_np(X1).astype(np.float32)
    uv2 = cam.project_np(X2).astype(np.float32)
    bad = rng.choice(m, n_bad, replace=False)
    uv1[bad] += rng.randn(n_bad, 2).astype(np.float32) * 50 + 10
    d = torch.tensor([0.05, -0.03, 0.04, 0.02, -0.01, 0.03, 0.05])
    S0 = Sim3.exp(d) @ Sim3(*(torch.as_tensor(a) for a in (R, t, s)))
    return (tuple(a.numpy() for a in S0), X1, X2, uv1, uv2, (R, t, s),
            bad)


def port_namespace(device, cam=CAM):
    """The port's side of build_map, its integrations on `device`."""
    import types

    from . import worldmap
    from .frontend.extractor import FrameFeatures
    from .imu import Preintegrated

    return types.SimpleNamespace(
        wm=worldmap, Features=FrameFeatures, cam=cam,
        Preintegrated=lambda *a: Preintegrated(*a, device=device))


class EurocWindow:
    """The estimator's full-size synthetic window at EuRoC width:
    configs/euroc.yaml's 752x480 pinhole, a 200 Hz IMU consistent with the
    trajectory, `n_kf` keyframes `kf_every` frames apart (20 fps) over a
    scene of points and colinear triplets. Each keyframe detects about
    `kp_per_kf` of the points it sees and observes about `obs_per_kf` of
    them as map points (whole triplets kept together, each map point seen
    by at least `min_obs` keyframes), a share
    `kf_outliers` of those displaced by 20 px. Two tracking frames
    past the last keyframe match `n_match` map points each, `n_outliers` of
    them displaced by 30 px, against map points `tracked_point_noise` m
    from the truth. Keypoints carry `noise_px` of pixel noise.
    Everything is numpy, made from `seed`.

    long=True makes a window of a large map (a loop-closure GBA's, hundreds
    of keyframes): the scene's box follows the trajectory (4-12 m ahead of
    it, 6 m beside it), and each keyframe starts the runs of enough new
    landmark groups among those it sees to observe ~`obs_per_kf` landmarks
    however long the window; `n_points` then sets the scene's density. The
    default keeps the 20-keyframe window's fixed box and its draws."""

    def __init__(self, seed=0, n_kf=20, kf_every=6, n_points=4200,
                 kp_per_kf=500, obs_per_kf=300, min_obs=3, kf_outliers=0.02,
                 n_match=500, n_outliers=25, noise_px=0.5,
                 tracked_point_noise=0.003, long=False):
        from .geometry import so3

        rng = np.random.RandomState(seed + 5)
        # the motion does not depend on the scene, which is set after it
        self.seq = seq = SyntheticSequence(
            n_frames=n_kf * kf_every + 4, seed=seed,
            scene=SyntheticScene(n_points=6, seed=seed))
        extent = ((-4, 10), (-3, 5), (4, 12))
        if long:
            # the body path (with identity extrinsics the camera's) boxed
            path = np.stack([t for _, t in seq.frame_poses])
            lo, hi = path.min(0), path.max(0)
            extent = ((lo[0] - 6, hi[0] + 6), (-3, 5),
                      (lo[2] + 4, hi[2] + 12))
        seq.scene = scene = SyntheticScene(n_points=n_points, seed=seed,
                                           cam=EUROC_CAM, extent=extent)
        self.kf_frames = frames = [k * kf_every for k in range(n_kf)]
        self.poses = [seq.frame_tcw(i) for i in frames]
        self.times = [seq.frame_times[i] for i in frames]
        # landmark groups: a free point, or a whole colinear triplet
        group = np.arange(scene.n)
        for t, (p, a, b) in enumerate(scene.triplets):
            group[[p, a, b]] = scene.n + t
        n_groups = scene.n + len(scene.triplets)

        # each group is tracked over a run of 3-5 consecutive keyframes,
        # where it is seen; the other keypoints of a keyframe are unmatched
        start = rng.randint(-4, n_kf, n_groups)
        length = rng.randint(3, 6, n_groups)
        seen = [scene.visible(R, t) for R, t in self.poses]
        if long:
            # keyframe k starts the runs of new groups it sees (1.5 points
            # a group on average), enough for ~obs_per_kf with those active
            size = np.bincount(group, minlength=n_groups)
            start = np.full(n_groups, -n_kf - 10)
            free = np.ones(n_groups, bool)
            for k, ids in enumerate(seen):
                active = (start <= k) & (k < start + length)
                g_seen = np.unique(group[ids])
                room = obs_per_kf - int(size[g_seen[active[g_seen]]].sum())
                cand = g_seen[free[g_seen]]
                new = rng.permutation(cand)[:max(room, 0) * 2 // 3]
                start[new] = k
                free[new] = False
        active, subsets = [], []
        for k, ids in enumerate(seen):
            act = ((start <= k) & (k < start + length))[group]
            n_act = int(act[ids].sum())
            extra = rng.rand(scene.n) < max(kp_per_kf - n_act, 0) / max(
                len(ids) - n_act, 1)
            active.append(act)
            subsets.append(act | extra)
        self.views = render_views(scene, self.poses, noise_px, subsets)
        self.keep = [active[k][ids] for k, (_, ids) in enumerate(self.views)]
        # a map holds no point seen by fewer than `min_obs` keyframes (the
        # local mapper culls them, Map.cpp; worldmap/map.py)
        n_seen = np.zeros(scene.n, int)
        for (_, ids), kp in zip(self.views, self.keep):
            n_seen[ids[kp]] += 1
        self.keep = [kp & (n_seen[ids] >= min_obs)
                     for (_, ids), kp in zip(self.views, self.keep)]
        # mismatches: `kf_outliers` of each keyframe's observations
        # displaced by 20 px
        for (feats, _), kp in zip(self.views, self.keep):
            obs = np.nonzero(kp)[0]
            bad = rng.choice(obs, int(round(kf_outliers * len(obs))),
                             replace=False)
            ang = rng.uniform(0, 2 * np.pi, len(bad))
            shift = 20.0 * np.stack([np.cos(ang), np.sin(ang)], 1)
            for key in ("kp_pos", "kp_pos_un"):
                feats[key] = feats[key].copy()
                feats[key][bad] += shift.astype(np.float32)
        self.min_obs = min_obs
        self.links = imu_links(seq, self.times)
        self.vels = [seq.frame_vels[i] for i in frames]
        dRs, dts, dps = perturbation(n_kf, scene.n, noise_pose=0.01,
                                     noise_pt=0.02, seed=seed + 61)
        # the last KF as tracking leaves it: the next frames' reference
        dRs[-1], dts[-1] = np.eye(3, dtype=np.float32), np.zeros(3,
                                                                 np.float32)
        self.pert = (dRs, dts, dps)
        mapped = np.zeros(scene.n, bool)
        for (_, ids), kp in zip(self.views, self.keep):
            mapped[ids[kp]] = True
        # two tracking frames past the last KF: their matches and a pose
        # guess (truth perturbed)
        self.frames = []
        t_prev = self.times[-1]
        for i in (frames[-1] + 2, frames[-1] + 3):
            Rcw, tcw = seq.frame_tcw(i)
            feats, ids = scene.render(Rcw, tcw, noise=noise_px,
                                      subset=mapped)
            sel = rng.permutation(len(ids))[:n_match]
            uv = feats.kp_pos_un[sel].copy()
            bad = rng.choice(len(sel), min(n_outliers, len(sel)),
                             replace=False)
            ang = rng.uniform(0, 2 * np.pi, len(bad))
            uv[bad] += 30.0 * np.stack([np.cos(ang), np.sin(ang)], 1)
            m = seq.imu_between(t_prev, seq.frame_times[i])
            self.frames.append(dict(
                index=i, time=seq.frame_times[i], gids=ids[sel],
                uv=uv.astype(np.float32), outliers=np.sort(bad),
                Rcw=(so3.exp(rng.randn(3).astype(np.float32) * 0.004)
                     @ Rcw).astype(np.float32),
                tcw=(tcw + rng.randn(3).astype(np.float32) * 0.02).astype(
                    np.float32),
                imu=(m[:, :3].astype(np.float32), m[:, 3:6].astype(
                    np.float32), np.diff(np.concatenate(
                        [[t_prev], m[:, 6]])).astype(np.float32))))
            t_prev = seq.frame_times[i]
        # the map points as tracking sees them (refined by earlier BAs)
        self.tracked_points = (scene.points + rng.randn(scene.n, 3).astype(
            np.float32) * tracked_point_noise).astype(np.float32)
        self.n_landmarks = int(mapped.sum())
        self.n_obs = int(sum(k.sum() for k in self.keep))

    def build(self, pkg, preintegrated=None, n_kf=None):
        """A fresh (map, keyframes, {gid: MapPoint}) of the window; the
        links are integrated anew unless `preintegrated` (one Preintegrated
        a link) is given, which the keyframes then hold copies of. n_kf:
        the map of the first n_kf keyframes only, without the points that
        fewer than `min_obs` of them observe."""
        n = len(self.poses) if n_kf is None else n_kf
        keep = self.keep[:n]
        if n < len(self.poses):
            n_seen = np.zeros(self.seq.scene.n, int)
            for (_, ids), kp in zip(self.views[:n], keep):
                n_seen[ids[kp]] += 1
            keep = [kp & (n_seen[ids] >= self.min_obs)
                    for (_, ids), kp in zip(self.views[:n], keep)]
        dRs, dts, dps = self.pert
        return build_map(pkg, self.poses[:n], self.views[:n],
                         self.seq.scene.points,
                         (dRs[:max(n - 2, 0)], dts[:max(n - 2, 0)], dps),
                         self.times[:n],
                         ((preintegrated or self.links)[:n - 1],
                          self.vels[:n]),
                         keep=keep, colines=True)

    def frame_inputs(self, k, pad=512):
        """Tracking frame k's padded pose-optimization inputs (numpy): X,
        uv, valid, close (tracked depth < 10 m), padded to `pad` rows as
        the tracker pads them."""
        f = self.frames[k]
        n = len(f["gids"])
        X = np.zeros((pad, 3), np.float32)
        uv = np.zeros((pad, 2), np.float32)
        valid = np.zeros(pad, bool)
        X[:n] = self.tracked_points[f["gids"]]
        uv[:n] = f["uv"]
        valid[:n] = True
        twc = -f["Rcw"].T @ f["tcw"]
        close = np.zeros(pad, bool)
        close[:n] = np.linalg.norm(X[:n] - twc, axis=1) < 10.0
        return X, uv, valid, close
