"""The corridor traffic: scene, motion, IMU and images, made from a seed.

A frozen copy of ppg_slam_tpu_torch/testing.py `render_corridor`,
`fisheye_canvas`, `distortion_source_map` and `distort_frames` (commit
a5bca21), with three changes:

* the images are drawn in PyTorch on the card, many frames at a time: the
  wall texture warp is one gather, and each anti-aliased segment is drawn over
  the seven pixels of each column (or row) along it that it can reach, then
  blended in the reference's segment order;
* the motion runs tick by tick and on demand (`Motion.advance`), so that
  set-up integrates only the frames it renders;
* the image noise of frame k comes from a torch.Generator seeded by the seed
  and k, so a frame is the same however the frames are batched.

The scene and the IMU noise come from numpy's RandomState, drawn in the
reference's order, so that the same seed gives the reference's scene, truth
and IMU rows (slam_bench/tests/test_render.py holds the two against each
other). Imports nothing of the program.
"""

from __future__ import annotations

import types

import numpy as np
import torch

BORDER = 110.0      # the wall's grey: the renders' border value
TEX_PX_PER_M = 96.0
WALL_Z = 4.2
HALF_WIDTH = 1.0    # the segments' half width in px
GRAVITY = np.float32([0.0, 9.81, 0.0])  # +y in the world (image down)
MAX_THETA = 1.2     # the rays a Kannala-Brandt view sees


def _rng_seed(seed: int) -> int:
    return int(seed) % 2 ** 32


# ---------------------------------------------------------------------------
# cameras (plain copies of the program's radtan and Kannala-Brandt math)
# ---------------------------------------------------------------------------

def camera(settings: dict) -> types.SimpleNamespace:
    """The camera of a configuration's settings (the keys of the program's
    YAML files) as a namespace: kind ("pinhole" with radtan k1, k2, p1, p2,
    or "kb8" with k1..k4), fx, fy, cx, cy, width, height, fps, dist."""
    def c(k):
        return settings.get("Camera." + k, 0.0)

    kind = "kb8" if c("type") == "KannalaBrandt8" else "pinhole"
    dist = ((c("k1"), c("k2"), c("k3"), c("k4")) if kind == "kb8"
            else (c("k1"), c("k2"), c("p1"), c("p2")))
    return types.SimpleNamespace(
        kind=kind, fx=float(c("fx")), fy=float(c("fy")), cx=float(c("cx")),
        cy=float(c("cy")), width=int(c("width")), height=int(c("height")),
        fps=float(c("fps")), dist=tuple(float(d) for d in dist))


def radtan_undistort(uv: np.ndarray, cam) -> np.ndarray:
    """Distorted pixels -> undistorted pixels under the same K, with
    cv::undistortPoints' 5 compensation steps (f32)."""
    k1, k2, p1, p2 = (np.float32(d) for d in cam.dist)
    uv = np.asarray(uv, np.float32)
    xd = (uv[..., 0] - np.float32(cam.cx)) * np.float32(1.0 / cam.fx)
    yd = (uv[..., 1] - np.float32(cam.cy)) * np.float32(1.0 / cam.fy)
    x, y = xd, yd
    for _ in range(5):
        r2 = x * x + y * y
        icdist = np.float32(1.0) / (np.float32(1.0) + k1 * r2 + k2 * r2 * r2)
        dx = np.float32(2.0) * p1 * x * y + p2 * (r2 + np.float32(2.0) * x * x)
        dy = p1 * (r2 + np.float32(2.0) * y * y) + np.float32(2.0) * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return np.stack([np.float32(cam.fx) * x + np.float32(cam.cx),
                     np.float32(cam.fy) * y + np.float32(cam.cy)], -1)


def kb8_unproject(uv: np.ndarray, cam) -> np.ndarray:
    """Kannala-Brandt pixels -> unit-depth bearings (10 Newton steps, f32)."""
    uv = np.asarray(uv, np.float32)
    k1, k2, k3, k4 = cam.dist
    px = (uv[..., 0] - cam.cx) / cam.fx
    py = (uv[..., 1] - cam.cy) / cam.fy
    theta_d = np.sqrt(px * px + py * py)
    clipped = np.clip(theta_d, -np.pi / 2, np.pi / 2)
    theta = clipped
    for _ in range(10):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        num = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - clipped
        den = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
        theta = theta - num / den
    scale = np.where(theta_d > 1e-8,
                     np.tan(theta) / np.where(theta_d > 1e-8, theta_d, 1.0),
                     1.0)
    return np.stack([px * scale, py * scale, np.ones_like(px)], -1)


def fisheye_canvas(cam, max_half_width: float = 800.0):
    """The pinhole camera whose render is resampled into the Kannala-Brandt
    image `cam`: same axis, every ray up to MAX_THETA off it, its focal
    length cam's own or less, at most 2 * max_half_width px wide."""
    h, w = cam.height, cam.width
    edge = np.concatenate([
        np.stack([np.arange(w), np.zeros(w)], 1),
        np.stack([np.arange(w), np.full(w, h - 1)], 1),
        np.stack([np.zeros(h), np.arange(h)], 1),
        np.stack([np.full(h, w - 1), np.arange(h)], 1)]).astype(np.float32)
    b = kb8_unproject(edge, cam)
    tan_max = np.tan(MAX_THETA)
    ex = float(np.minimum(np.abs(b[:, 0]), tan_max).max())
    ey = float(np.minimum(np.abs(b[:, 1]), tan_max).max())
    f = min(cam.fx, cam.fy, max_half_width / max(ex, ey))
    cx, cy = np.ceil(f * ex) + 1.0, np.ceil(f * ey) + 1.0
    return types.SimpleNamespace(
        kind="pinhole", fx=f, fy=f, cx=float(cx), cy=float(cy),
        dist=(0.0, 0.0, 0.0, 0.0), width=int(2 * cx) + 1,
        height=int(2 * cy) + 1, fps=cam.fps)


def source_map(cam, canvas) -> np.ndarray:
    """(H, W, 2) f32: for each pixel of `cam`'s image, the point of the
    clean render (of `canvas`) that it sees, NaN where it sees none."""
    vv, uu = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    d = np.stack([uu, vv], -1)
    if cam.kind == "pinhole":
        return radtan_undistort(d, cam)
    b = kb8_unproject(d, cam)
    theta = np.arctan(np.hypot(b[..., 0], b[..., 1]))
    src = np.stack([canvas.fx * b[..., 0] + canvas.cx,
                    canvas.fy * b[..., 1] + canvas.cy], -1)
    ok = np.isfinite(src).all(-1) & (theta <= MAX_THETA)
    return np.where(ok[..., None], src, np.nan).astype(np.float32)


# ---------------------------------------------------------------------------
# bilinear sampling (the reference's _sample_bilinear, in torch)
# ---------------------------------------------------------------------------

def sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    border: float = 0.0) -> torch.Tensor:
    """img (h, w) sampled at float pixel coordinates (x, y) (any equal
    shapes), bilinear; `border` where the sample falls outside."""
    h, w = img.shape
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x = x.clamp(0, w - 1)
    y = y.clamp(0, h - 1)
    x0 = torch.floor(x).long().clamp(max=w - 2)
    y0 = torch.floor(y).long().clamp(max=h - 2)
    fx, fy = x - x0, y - y0
    flat = img.reshape(-1)
    i00 = y0 * w + x0
    top = flat[i00] * (1 - fx) + flat[i00 + 1] * fx
    bot = flat[i00 + w] * (1 - fx) + flat[i00 + w + 1] * fx
    return torch.where(inside, top * (1 - fy) + bot * fy,
                       torch.full_like(fx, border))


def resize_bilinear(a: np.ndarray, h: int, w: int, device) -> torch.Tensor:
    """(h, w) f64 bilinear resize of a 2-D array, pixel centres aligned."""
    ys = np.clip((np.arange(h) + 0.5) * a.shape[0] / h - 0.5, 0,
                 a.shape[0] - 1)
    xs = np.clip((np.arange(w) + 0.5) * a.shape[1] / w - 0.5, 0,
                 a.shape[1] - 1)
    img = torch.from_numpy(a.astype(np.float32)).to(device).double()
    xt = torch.from_numpy(xs).to(device)[None, :].expand(h, w)
    yt = torch.from_numpy(ys).to(device)[:, None].expand(h, w)
    return sample_bilinear(img, xt, yt)


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

class Scene:
    """The irregular wireframe corridor: randomized bars and rails on a wall
    at z = WALL_Z with a world-fixed two-scale texture, free segments in
    front of it; `reach` m more wall on every side for a wide field of view.
    Its extent covers n_frames at `speed` m a frame."""

    def __init__(self, seed: int, n_frames: int, speed: float, reach: float,
                 device):
        rng = np.random.RandomState(_rng_seed(seed))
        segs, vals = [], []
        x0, x1 = -3.0 - reach, max(5.0, speed * n_frames + 4.0) + reach
        half = 1.8 + reach
        x = x0
        while x < x1:
            tilt = rng.uniform(-0.35, 0.35)
            segs.append(((x, -half, WALL_Z), (x + tilt, half, WALL_Z)))
            vals.append(int(rng.randint(170, 255)))
            x += rng.uniform(0.35, 0.95)
        for y in np.linspace(-half, half, 10):
            dy = rng.uniform(-0.15, 0.15)
            segs.append(((x0, y, WALL_Z), (x1, y + dy, WALL_Z)))
            vals.append(int(rng.randint(170, 255)))
        for xc in np.arange(x0 + 1, x1, 0.35):
            for _ in range(1 + int(reach)):
                p = np.array([xc, 0, 0]) + rng.uniform(
                    [-0.4, -1.5 - reach, 2.6 - 0.4 * reach],
                    [0.4, 1.5 + reach, 3.9])
                q = p + rng.uniform([-1.0, -1.0, -0.3], [1.0, 1.0, 0.3])
                segs.append((tuple(p), tuple(q)))
                vals.append(int(rng.randint(170, 255)))
        self.device = device
        self.seg_p = torch.tensor([s[0] for s in segs], dtype=torch.float64,
                                  device=device)
        self.seg_q = torch.tensor([s[1] for s in segs], dtype=torch.float64,
                                  device=device)
        self.vals = torch.tensor(vals, dtype=torch.float64, device=device)

        s = TEX_PX_PER_M
        self.wx0, self.wy0 = x0 - 1.5, -2.4 - reach
        tw, th = int((x1 + 1.5 - self.wx0) * s), int((-2 * self.wy0) * s)
        t1 = resize_bilinear(rng.randint(0, 255, (th // 8, tw // 8)), th, tw,
                             device)
        t2 = resize_bilinear(rng.randint(0, 255, (th // 32, tw // 32)), th,
                             tw, device)
        tex = torch.clamp(110.0 + (t1 - 127.0) * 0.18 + (t2 - 127.0) * 0.25,
                          0, 255)
        self.tex = torch.floor(tex)
        del t1, t2
        self.Btex = np.array([[1.0 / s, 0, self.wx0], [0, 1.0 / s, self.wy0],
                              [0, 0, WALL_Z]])


# ---------------------------------------------------------------------------
# motion and IMU
# ---------------------------------------------------------------------------

def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula in f32, with the small-angle series below 1e-5."""
    w = np.asarray(w, np.float32)
    t2 = np.float32(w @ w)
    th = np.sqrt(t2)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                 np.float32)
    if th < 1e-5:
        a, b = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0
    else:
        a, b = np.sin(th) / th, (1.0 - np.cos(th)) / t2
    return (np.eye(3, dtype=np.float32) + np.float32(a) * W
            + np.float32(b) * (W @ W)).astype(np.float32)


class Motion:
    """The body's path and its IMU, integrated tick by tick at imu_hz with
    the discrete model the preintegration assumes: forward at `speed` m a
    frame along world x, with sinusoidal excitation on all axes
    (accelerations in the world, rates in the body). The camera is mounted
    by Tbc (body-from-camera) and starts at the world origin. IMU rows are
    (ax, ay, az, wx, wy, wz, t) with white noise of the given densities; the
    poses are the clean signal's. Frame k is at k / fps; a frame between two
    ticks gets the state propagated from the tick before it.

    traffic: the mix's "motion" block (speed_m_per_frame, accel_amp_m,
    accel_rad_s, gyro_amp_rad_s, gyro_rad_s, gyro_fn)."""

    def __init__(self, seed: int, motion: dict, Tbc, fps: float,
                 imu_hz: float, noise_gyro: float, noise_acc: float):
        self.fps, self.dt = fps, 1.0 / imu_hz
        self.speed = float(motion["speed_m_per_frame"])
        self.amp = [float(a) for a in motion["accel_amp_m"]]
        self.om = [float(o) for o in motion["accel_rad_s"]]
        self.gamp = [float(a) for a in motion["gyro_amp_rad_s"]]
        self.gom = [float(o) for o in motion["gyro_rad_s"]]
        self.gfn = [{"sin": np.sin, "cos": np.cos}[f]
                    for f in motion["gyro_fn"]]
        Tbc = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64)
        self.Rbc = Tbc[:3, :3].astype(np.float32)
        self.tbc = Tbc[:3, 3].astype(np.float32)
        self.sg = noise_gyro * np.sqrt(imu_hz)
        self.sa = noise_acc * np.sqrt(imu_hz)
        self.rng = np.random.RandomState(_rng_seed(seed + 7))
        self.Rwb = self.Rbc.T.copy()
        self.twb = (-self.Rbc.T @ self.tbc).astype(np.float32)
        (bx, by, bz), (wx, wy, wz) = self.amp, self.om
        self.vel = np.float32([self.speed * fps + bx * wx, by * wy, bz * wz])
        self.kk = 0
        self.body = [(self.Rwb.copy(), self.twb.copy(), self.vel.copy())]
        self.imu = []

    def _accel_w(self, kk: int) -> np.ndarray:
        tm = kk * self.dt
        (bx, by, bz), (wx, wy, wz) = self.amp, self.om
        return np.float32([-bx * wx * wx * np.sin(wx * tm),
                           -by * wy * wy * np.sin(wy * tm),
                           -bz * wz * wz * np.sin(wz * tm)])

    def _gyro_b(self, kk: int) -> np.ndarray:
        tm = kk * self.dt
        return np.float32([a * f(o * tm) for a, f, o
                           in zip(self.gamp, self.gfn, self.gom)])

    def advance(self, n_frames: int) -> None:
        """Integrate until frames 0 .. n_frames - 1 have their states."""
        dt = self.dt
        for k in range(len(self.body), n_frames):
            t_frame = k / self.fps
            while (self.kk + 1) * dt <= t_frame + 1e-9:
                kk = self.kk
                a_w, w_b = self._accel_w(kk), self._gyro_b(kk)
                a_meas = (self.Rwb.T @ (a_w - GRAVITY)
                          + self.rng.randn(3) * self.sa).astype(np.float32)
                w_meas = (w_b + self.rng.randn(3) * self.sg).astype(
                    np.float32)
                self.imu.append(np.concatenate([a_meas, w_meas,
                                                [kk * dt + dt]]))
                self.twb = self.twb + self.vel * dt + 0.5 * a_w * dt * dt
                self.vel = self.vel + a_w * dt
                self.Rwb = self.Rwb @ _so3_exp(np.float32(w_b * dt))
                self.kk += 1
            tau = t_frame - self.kk * dt
            if tau < 1e-9:
                self.body.append((self.Rwb.copy(), self.twb.copy(),
                                  self.vel.copy()))
            else:
                a_w, w_b = self._accel_w(self.kk), self._gyro_b(self.kk)
                self.body.append((
                    self.Rwb @ _so3_exp(np.float32(w_b * tau)),
                    self.twb + self.vel * tau + 0.5 * a_w * tau * tau,
                    self.vel + a_w * tau))

    def camera_pose(self, k: int):
        """(Rcw, tcw) of frame k in f64 (the render's), from its body pose."""
        Rwb, twb, _ = self.body[k]
        Rwc = Rwb.astype(np.float64) @ self.Rbc
        twc = Rwb.astype(np.float64) @ self.tbc + twb
        Rcw = Rwc.T
        return Rcw, -Rcw @ twc

    def imu_rows(self) -> np.ndarray:
        return np.stack(self.imu).astype(np.float64)


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

class Renderer:
    """Draws frames of a Scene through the pinhole `canvas` (the camera's
    own K for radtan, fisheye_canvas for Kannala-Brandt) and resamples them
    into `cam`'s images where `cam` distorts; uint8 frames on the device."""

    def __init__(self, scene: Scene, cam, seed: int, canvas=None):
        self.scene, self.cam, self.seed = scene, cam, int(seed)
        self.dev = scene.device
        self.canvas = canvas if canvas is not None else cam
        c = self.canvas
        self.K = np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]])
        self.src = None
        if cam.kind == "kb8" or any(abs(d) > 0 for d in cam.dist):
            src = source_map(cam, None if canvas is None else canvas)
            ok = np.isfinite(src).all(-1)
            self.src = (torch.from_numpy(np.where(ok, src[..., 0], -1.0))
                        .to(self.dev).double(),
                        torch.from_numpy(np.where(ok, src[..., 1], -1.0))
                        .to(self.dev).double())

    def _noise(self, k: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.dev)
        g.manual_seed((self.seed % 2 ** 40) * 1_000_003 + k)
        return torch.randint(-8, 8, shape, generator=g, device=self.dev,
                             dtype=torch.int64).double()

    def _walls(self, poses) -> torch.Tensor:
        """(B, H, W) f64: the textured wall through each pose's homography."""
        c, sc = self.canvas, self.scene
        hs = []
        for _, Rcw, tcw in poses:
            M = Rcw @ sc.Btex
            M[:, 2] += tcw
            hs.append(np.linalg.inv(self.K @ M))  # image -> texture px
        H = torch.from_numpy(np.stack(hs)).to(self.dev)

        def e(i, j):
            return H[:, i, j][:, None, None]

        vs = torch.arange(c.height, device=self.dev,
                          dtype=torch.float64)[None, :, None]
        us = torch.arange(c.width, device=self.dev,
                          dtype=torch.float64)[None, None, :]
        den = e(2, 0) * us + e(2, 1) * vs + e(2, 2)
        return sample_bilinear(
            sc.tex, (e(0, 0) * us + e(0, 1) * vs + e(0, 2)) / den,
            (e(1, 0) * us + e(1, 1) * vs + e(1, 2)) / den, border=BORDER)

    def _segments(self, img: torch.Tensor, poses) -> None:
        """Blend every segment in front of each camera into img (B, H, W)
        f64, in place, in scene order: coverage 1 within HALF_WIDTH - 0.5 px
        of the segment, falling linearly to 0 a pixel out."""
        sc, dev = self.scene, self.dev
        _, h, w = img.shape
        r = HALF_WIDTH + 0.5
        R = torch.from_numpy(np.stack([p[1] for p in poses])).to(dev)
        t = torch.from_numpy(np.stack([np.asarray(p[2], np.float64)
                                       for p in poses])).to(dev)
        Pc = torch.matmul(sc.seg_p[None], R.transpose(1, 2)) + t[:, None]
        Qc = torch.matmul(sc.seg_q[None], R.transpose(1, 2)) + t[:, None]
        front = (Pc[..., 2] >= 0.5) & (Qc[..., 2] >= 0.5)
        fb, idx = torch.nonzero(front, as_tuple=True)
        K2 = torch.from_numpy(self.K[:2]).to(dev)
        p = (Pc[fb, idx] / Pc[fb, idx, 2:3]) @ K2.T
        q = (Qc[fb, idx] / Qc[fb, idx, 2:3]) @ K2.T
        d = q - p
        n2 = (d * d).sum(-1)
        # walk each segment along its major axis, one column (row) a step
        major_x = d[:, 0].abs() >= d[:, 1].abs()
        lo_c = torch.where(major_x, torch.minimum(p[:, 0], q[:, 0]),
                           torch.minimum(p[:, 1], q[:, 1]))
        hi_c = torch.where(major_x, torch.maximum(p[:, 0], q[:, 0]),
                           torch.maximum(p[:, 1], q[:, 1]))
        size = torch.where(major_x, torch.full_like(lo_c, w),
                           torch.full_like(lo_c, h))
        lo = torch.clamp(torch.ceil(lo_c - r), min=0)
        hi = torch.minimum(torch.floor(hi_c + r), size - 1)
        n = torch.clamp(hi - lo + 1, min=0).long()
        keep = n > 0
        fb, idx, p, d, n2, major_x, lo, n = (
            a[keep] for a in (fb, idx, p, d, n2, major_x, lo, n))
        seg = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
        if not len(seg):
            return
        start = torch.cumsum(n, 0) - n
        col = lo[seg] + (torch.arange(len(seg), device=dev) - start[seg])
        mx = major_x[seg]
        pa = torch.where(mx, p[seg, 0], p[seg, 1])   # along the major axis
        pb = torch.where(mx, p[seg, 1], p[seg, 0])
        da = torch.where(mx, d[seg, 0], d[seg, 1])
        db = torch.where(mx, d[seg, 1], d[seg, 0])
        tt = torch.where(da != 0, (col - pa) / torch.where(da != 0, da, 1.0),
                         torch.zeros_like(da)).clamp(0, 1)
        mid = torch.round(pb + tt * db)
        # a pixel within r of the segment lies within 3 px of it across
        # the major axis (|slope| <= 1)
        offs = torch.arange(-3, 4, device=dev, dtype=torch.float64)
        other = (mid[:, None] + offs[None, :]).reshape(-1)
        seg = seg.repeat_interleave(7)
        col = col.repeat_interleave(7)
        mx = mx.repeat_interleave(7)
        xs = torch.where(mx, col, other)
        ys = torch.where(mx, other, col)
        ok = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
        seg, xs, ys = seg[ok], xs[ok], ys[ok]
        ps, ds, nn = p[seg], d[seg], n2[seg]
        tp = torch.where(
            nn < 1e-12, torch.zeros_like(xs),
            (((xs - ps[:, 0]) * ds[:, 0] + (ys - ps[:, 1]) * ds[:, 1])
             / torch.where(nn < 1e-12, 1.0, nn)).clamp(0.0, 1.0))
        dist = torch.hypot(xs - (ps[:, 0] + tp * ds[:, 0]),
                           ys - (ps[:, 1] + tp * ds[:, 1]))
        a = torch.clamp(r - dist, 0.0, 1.0)
        on = a > 0
        seg, a = seg[on], a[on]
        pix = fb[seg] * (h * w) + (ys[on] * w + xs[on]).long()
        order = idx[seg]
        # blend in scene order: sort by (pixel, segment), then apply the
        # k-th blend of every pixel together
        key, perm = torch.sort(pix * (len(sc.vals) + 1) + order)
        pix, a, order = pix[perm], a[perm], order[perm]
        first = torch.ones_like(pix, dtype=torch.bool)
        first[1:] = pix[1:] != pix[:-1]
        pos = torch.arange(len(pix), device=dev)
        rank = pos - torch.cummax(torch.where(first, pos,
                                              torch.zeros_like(pos)), 0)[0]
        flat = img.view(-1)
        value = sc.vals[order]
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            pk = pix[sel]
            cur = flat[pk]
            flat[pk] = cur + a[sel] * (value[sel] - cur)

    def render(self, poses, batch: int = 16) -> torch.Tensor:
        """uint8 frames (B, H, W) on the device for [(k, Rcw, tcw)]."""
        out = []
        for i in range(0, len(poses), batch):
            chunk = poses[i:i + batch]
            img = self._walls(chunk)
            self._segments(img, chunk)
            noise = torch.stack([self._noise(k, img.shape[1:])
                                 for k, _, _ in chunk])
            img = torch.clamp(torch.round(img) + noise, 0, 255)
            if self.src is not None:
                img = torch.stack([
                    torch.round(sample_bilinear(f, self.src[0], self.src[1],
                                                border=BORDER)).clamp(0, 255)
                    for f in img])
            out.append(img.to(torch.uint8))
        return torch.cat(out)
