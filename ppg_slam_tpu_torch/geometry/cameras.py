"""Camera models: Pinhole (+radtan undistortion) and Kannala-Brandt-8 fisheye.

Port of ppg_slam_tpu/geometry/cameras.py. Projection math is batched over
leading axes of torch tensors; undistortion runs a fixed number of iterations
(radtan: OpenCV's 5 compensation steps; KB8: 10 Newton steps). Pixels are
normalized by multiplying with 1/f, as XLA compiles the reference's division
by a constant: the two then agree to within an ulp or so.

Conventions (as in the reference):
  * Pinhole `project` is distortion-free (keypoints are undistorted once in
    the extractor); radtan appears only in undistort_points/distort_points.
  * KB8 `project` applies the full equidistant model, because fisheye
    keypoints keep their distorted positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

CAM_PINHOLE = 0
CAM_FISHEYE = 1

# Feature-grid constants (reference GeometricCamera.h:42-97: 64x48 cell grid)
GRID_COLS = 64
GRID_ROWS = 48


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Static camera description."""

    kind: int  # CAM_PINHOLE | CAM_FISHEYE
    fx: float
    fy: float
    cx: float
    cy: float
    # distortion: radtan (k1,k2,p1,p2) for pinhole; (k1..k4) theta-poly for KB8
    dist: Tuple[float, float, float, float]
    width: int
    height: int
    fps: float = 20.0

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def is_fisheye(self) -> bool:
        return self.kind == CAM_FISHEYE

    def project(self, xyz: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) pixels."""
        if self.kind == CAM_PINHOLE:
            z = xyz[..., 2]
            return torch.stack([self.fx * xyz[..., 0] / z + self.cx,
                                self.fy * xyz[..., 1] / z + self.cy], dim=-1)
        return kb8_project(xyz, self.fx, self.fy, self.cx, self.cy, self.dist)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """(..., 2) pixels -> (..., 3) unit-depth bearing (z = 1)."""
        if self.kind == CAM_PINHOLE:
            x = (uv[..., 0] - self.cx) * (1.0 / self.fx)
            y = (uv[..., 1] - self.cy) * (1.0 / self.fy)
            return torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return kb8_unproject(uv, self.fx, self.fy, self.cx, self.cy, self.dist)

    # numpy twins for the host bookkeeping (frustum checks, triangulation),
    # which calls them thousands of times on small arrays
    def project_np(self, xyz: np.ndarray) -> np.ndarray:
        """(..., 3) camera-frame points -> (..., 2) pixels (numpy)."""
        xyz = np.asarray(xyz, np.float32)
        if self.kind == CAM_PINHOLE:
            z = xyz[..., 2]
            return np.stack([self.fx * xyz[..., 0] / z + self.cx,
                             self.fy * xyz[..., 1] / z + self.cy], axis=-1)
        k1, k2, k3, k4 = self.dist
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        r = np.sqrt(x * x + y * y)
        theta = np.arctan2(r, z)
        t2 = theta * theta
        rad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        rs = np.where(r > 1e-12, r, 1.0)
        return np.stack([self.fx * rad * x / rs + self.cx,
                         self.fy * rad * y / rs + self.cy], axis=-1)

    def unproject_np(self, uv: np.ndarray) -> np.ndarray:
        """(..., 2) pixels -> (..., 3) unit-depth bearings (numpy)."""
        uv = np.asarray(uv, np.float32)
        px = (uv[..., 0] - self.cx) / self.fx
        py = (uv[..., 1] - self.cy) / self.fy
        if self.kind == CAM_PINHOLE:
            return np.stack([px, py, np.ones_like(px)], axis=-1)
        k1, k2, k3, k4 = self.dist
        theta_d = np.sqrt(px * px + py * py)
        theta = np.clip(theta_d, -np.pi / 2, np.pi / 2)
        for _ in range(10):
            t2 = theta * theta
            t4 = t2 * t2
            t6 = t4 * t2
            t8 = t4 * t4
            num = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - \
                np.clip(theta_d, -np.pi / 2, np.pi / 2)
            den = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
            theta = theta - num / den
        scale = np.where(theta_d > 1e-8,
                         np.tan(theta) / np.where(theta_d > 1e-8, theta_d, 1.0),
                         1.0)
        return np.stack([px * scale, py * scale, np.ones_like(px)], axis=-1)

    def project_jac(self, xyz: torch.Tensor) -> torch.Tensor:
        """(..., 3) -> (..., 2, 3) d(uv)/d(xyz), analytic."""
        if self.kind == CAM_PINHOLE:
            x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
            zi = 1.0 / z
            zi2 = zi * zi
            zero = torch.zeros_like(z)
            row0 = torch.stack([self.fx * zi, zero, -self.fx * x * zi2], dim=-1)
            row1 = torch.stack([zero, self.fy * zi, -self.fy * y * zi2], dim=-1)
            return torch.stack([row0, row1], dim=-2)
        return kb8_project_jac(xyz, self.fx, self.fy, self.cx, self.cy,
                               self.dist)

    def undistort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Distorted pixels -> undistorted pixels under the same K
        (cv::(fisheye::)undistortPoints(..., K, D, I, K))."""
        if self.kind == CAM_PINHOLE:
            return pinhole_undistort(uv, self.fx, self.fy, self.cx, self.cy,
                                     self.dist)
        b = kb8_unproject(uv, self.fx, self.fy, self.cx, self.cy, self.dist)
        return torch.stack([self.fx * b[..., 0] + self.cx,
                            self.fy * b[..., 1] + self.cy], dim=-1)

    def distort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Undistorted pixels -> distorted pixels (closed form): the forward
        mapping inside cv::initUndistortRectifyMap."""
        x = (uv[..., 0] - self.cx) * (1.0 / self.fx)
        y = (uv[..., 1] - self.cy) * (1.0 / self.fy)
        if self.kind == CAM_PINHOLE:
            k1, k2, p1, p2 = self.dist
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        else:
            k1, k2, k3, k4 = self.dist
            r = torch.sqrt(x * x + y * y)
            theta = torch.atan(r)
            t2 = theta * theta
            theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
            big = r > 1e-8
            scale = torch.where(big, theta_d / torch.where(big, r, 1.0), 1.0)
            xd, yd = x * scale, y * scale
        return torch.stack([self.fx * xd + self.cx, self.fy * yd + self.cy],
                           dim=-1)

    def undistort_rectify_map(self) -> np.ndarray:
        """(H, W, 2) f32 map: undistorted pixel -> distorted source pixel,
        for the bilinear remap of the line heat."""
        u = torch.arange(self.width, dtype=torch.float32)
        v = torch.arange(self.height, dtype=torch.float32)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        return self.distort_points(torch.stack([uu, vv], dim=-1)).numpy()

    def is_in_image(self, uv: torch.Tensor, border: float = 0.0) -> torch.Tensor:
        """(..., 2) -> (...,) bool (reference GeometricCamera::IsInImage)."""
        return ((uv[..., 0] >= border) & (uv[..., 0] < self.width - border)
                & (uv[..., 1] >= border) & (uv[..., 1] < self.height - border))


def pinhole_undistort(uv, fx, fy, cx, cy, dist, iters: int = 5):
    """Iterative radtan undistortion with cv::undistortPoints' exactly 5
    compensation iterations and no convergence check (the reference's
    keypoints carry that approximation)."""
    k1, k2, p1, p2 = dist
    xd = (uv[..., 0] - cx) * (1.0 / fx)
    yd = (uv[..., 1] - cy) * (1.0 / fy)
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def kb8_project(xyz, fx, fy, cx, cy, dist):
    k1, k2, k3, k4 = dist
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    rad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    rs = torch.where(r > 1e-12, r, 1.0)
    return torch.stack([fx * rad * x / rs + cx, fy * rad * y / rs + cy],
                       dim=-1)


def kb8_unproject(uv, fx, fy, cx, cy, dist, iters: int = 10):
    """Newton inversion of theta_d = f(theta) (KannalaBrandt8.cpp:62-91)."""
    k1, k2, k3, k4 = dist
    px = (uv[..., 0] - cx) * (1.0 / fx)
    py = (uv[..., 1] - cy) * (1.0 / fy)
    theta_d = torch.sqrt(px * px + py * py)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = theta_d_c
    for _ in range(iters):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        num = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - theta_d_c
        den = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
        theta = theta - num / den
    big = theta_d > 1e-8
    scale = torch.where(big, torch.tan(theta) / torch.where(big, theta_d, 1.0),
                        1.0)
    return torch.stack([px * scale, py * scale, torch.ones_like(px)], dim=-1)


def kb8_project_jac(xyz, fx, fy, cx, cy, dist):
    """Analytic 2x3 Jacobian (KannalaBrandt8.cpp:95-131)."""
    k1, k2, k3, k4 = dist
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    r2 = x2 + y2
    r = torch.sqrt(r2)
    r3 = r2 * r
    theta = torch.atan2(r, z)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    f = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8)
    fd = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
    denom = r2 * (r2 + z2)
    j00 = fx * (fd * z * x2 / denom + f * y2 / r3)
    j01 = fx * (fd * z * y * x / denom - f * y * x / r3)
    j02 = -fx * fd * x / (r2 + z2)
    j10 = fy * (fd * z * y * x / denom - f * y * x / r3)
    j11 = fy * (fd * z * y2 / denom + f * x2 / r3)
    j12 = -fy * fd * y / (r2 + z2)
    row0 = torch.stack([j00, j01, j02], dim=-1)
    row1 = torch.stack([j10, j11, j12], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def epipolar_sq_dist(kp1_uv, kp2_uv, R12, t12, K):
    """Squared point-to-epipolar-line distance (Pinhole.cpp:101-121).

    kp*_uv: (..., 2); returns (...,) squared pixel distance; threshold 3.84.
    """
    from . import so3

    Kinv = torch.linalg.inv(K)
    F12 = Kinv.T @ so3.hat(t12) @ R12 @ Kinv
    a = kp1_uv[..., 0] * F12[0, 0] + kp1_uv[..., 1] * F12[1, 0] + F12[2, 0]
    b = kp1_uv[..., 0] * F12[0, 1] + kp1_uv[..., 1] * F12[1, 1] + F12[2, 1]
    c = kp1_uv[..., 0] * F12[0, 2] + kp1_uv[..., 1] * F12[1, 2] + F12[2, 2]
    num = a * kp2_uv[..., 0] + b * kp2_uv[..., 1] + c
    den = a * a + b * b
    ok = den > 0
    return torch.where(ok, num * num / torch.where(ok, den, 1.0), torch.inf)
