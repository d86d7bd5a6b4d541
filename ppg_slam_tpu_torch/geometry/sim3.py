"""Sim(3) similarity transforms (s, R, t), used by loop closing.

Port of ppg_slam_tpu/geometry/sim3.py: y = s * R @ x + t, batched over
leading axes, on the tensors' device. `exp` and `log` keep the reference's
four branches (small/generic angle x small/generic log-scale) as
branch-free `torch.where`s with safe substitutes (sigma = 1, theta = 1) in
the unselected formulas, so that no branch makes a NaN and forward-mode
derivatives (torch.func.jacfwd) take the selected branch's, as jax.jacfwd
does in the reference.

Per-transform coefficients keep trailing unit axes ((..., 1, 1)), so that
under torch.func.vmap they never become 0-d tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3
from .se3 import SE3, _mv

_EPS = 1e-5


class Sim3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,) scale

    @staticmethod
    def identity(dtype=torch.float32, batch: tuple = (),
                 device=None) -> "Sim3":
        return Sim3(
            torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3)),
            torch.zeros(batch + (3,), dtype=dtype, device=device),
            torch.ones(batch, dtype=dtype, device=device))

    @staticmethod
    def from_se3(T: SE3, s=None) -> "Sim3":
        scale = (torch.ones(T.t.shape[:-1], dtype=T.t.dtype,
                            device=T.t.device)
                 if s is None else torch.as_tensor(s, device=T.t.device))
        return Sim3(T.R, T.t, scale)

    def to_se3(self) -> SE3:
        """[sR t] -> [R t/s] (reference OptimizerGraph.cpp:264-278)."""
        return SE3(self.R, self.t / self.s[..., None])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.s[..., None] * _mv(self.R, x) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.R @ other.R,
                    self.s[..., None] * _mv(self.R, other.t) + self.t,
                    self.s * other.s)

    def __matmul__(self, other: "Sim3") -> "Sim3":
        return self.compose(other)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        # not 1.0 / s: under vmap + jacfwd a per-transform 0-d scale
        # divided into a Python float gets an f64 tangent
        sinv = torch.reciprocal(self.s)
        return Sim3(Rt, -sinv[..., None] * _mv(Rt, self.t), sinv)

    @staticmethod
    def exp(xi: torch.Tensor) -> "Sim3":
        """Tangent (..., 7) = [rho(3), phi(3), sigma(1)] -> Sim3, with
        t = W @ rho, W = A hat(phi) + B hat(phi)^2 + C I (Strasdat)."""
        rho, phi = xi[..., :3], xi[..., 3:6]
        sigma = xi[..., 6:7, None]                          # (..., 1, 1)
        R = so3.exp(phi)
        s = torch.exp(sigma)
        theta = torch.linalg.norm(phi, dim=-1)[..., None, None]
        A, B, C = _coefficients(theta, sigma, s)
        W = _w_matrix(phi, A, B, C)
        return Sim3(R, _mv(W, rho), s[..., 0, 0])

    def log(self) -> torch.Tensor:
        """Inverse of exp: Sim3 -> (..., 7) tangent [rho, phi, sigma]."""
        phi = so3.log(self.R)
        s = self.s[..., None, None]
        sigma = torch.log(s)
        theta = torch.linalg.norm(phi, dim=-1)[..., None, None]
        A, B, C = _coefficients(theta, sigma, s)
        W = _w_matrix(phi, A, B, C)
        rho = _solve3(W, self.t)
        return torch.cat([rho, phi, sigma[..., 0]], dim=-1)


def _coefficients(theta, sigma, s):
    """A, B, C of W in the four branches (ppg_slam_tpu/geometry/sim3.py
    exp :75-110 and log :119-158 share them)."""
    sig_small = torch.abs(sigma) < _EPS
    th_small = theta < _EPS
    sg = torch.where(sig_small, 1.0, sigma)  # safe sigma
    th = torch.where(th_small, 1.0, theta)   # safe theta
    th2 = th * th
    C = torch.where(sig_small, 1.0, (s - 1.0) / sg)

    A_ts = ((sg - 1.0) * s + 1.0) / (sg * sg)
    B_ts = (s * (0.5 * sg * sg + 1.0) - 1.0 - sg * s) / (sg * sg * sg)
    A_ss = (1.0 - torch.cos(th)) / th2
    B_ss = (th - torch.sin(th)) / (th2 * th)
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    c = th2 + sg * sg
    A_g = (a * sg + (1.0 - b) * th) / (th * c)
    B_g = (C - ((b - 1.0) * sg + a * th) / c) / th2

    A = torch.where(th_small, torch.where(sig_small, 0.5, A_ts),
                    torch.where(sig_small, A_ss, A_g))
    B = torch.where(th_small, torch.where(sig_small, 1.0 / 6.0, B_ts),
                    torch.where(sig_small, B_ss, B_g))
    return A, B, C


def _solve3(W, t):
    """W^-1 t by Cramer's rule: the rows of W^-1 are the cross products
    of W's columns over det W. (The reference's LU solve; written out
    because the forward-mode derivative of torch.linalg.solve is wrong
    under torch.func.vmap in PyTorch 2.13.)"""
    c0, c1, c2 = W[..., :, 0], W[..., :, 1], W[..., :, 2]
    r0 = torch.linalg.cross(c1, c2)
    r1 = torch.linalg.cross(c2, c0)
    r2 = torch.linalg.cross(c0, c1)
    det = torch.sum(c0 * r0, dim=-1, keepdim=True)
    num = torch.stack([torch.sum(r0 * t, dim=-1), torch.sum(r1 * t, dim=-1),
                       torch.sum(r2 * t, dim=-1)], dim=-1)
    return num / det


def _w_matrix(phi, A, B, C):
    Om = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Om.shape)
    return A * Om + B * (Om @ Om) + C * eye
