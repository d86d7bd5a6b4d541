"""SE(3) rigid transforms as (R, t) tensor pairs, batched over leading axes.

Port of ppg_slam_tpu/geometry/se3.py: rotations are (..., 3, 3) matrices and
translations (..., 3) vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (R @ x[..., None])[..., 0]


class SE3(NamedTuple):
    """Rigid transform y = R @ x + t. Batchable over leading axes."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(dtype=torch.float32, batch: tuple = (),
                 device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
        t = torch.zeros(batch + (3,), dtype=dtype, device=device)
        return SE3(R, t)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Transform points: (..., 3) -> (..., 3)."""
        return _mv(self.R, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: first apply `other`, then `self`."""
        return SE3(self.R @ other.R, _mv(self.R, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.t))

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        batch = self.t.shape[:-1]
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device).expand(batch + (4,))
        return torch.cat([self.matrix3x4(), bottom[..., None, :]], dim=-2)

    def matrix3x4(self) -> torch.Tensor:
        return torch.cat([self.R, self.t[..., None]], dim=-1)

    @staticmethod
    def from_matrix(T: torch.Tensor) -> "SE3":
        return SE3(T[..., :3, :3], T[..., :3, 3])

    @staticmethod
    def exp(xi: torch.Tensor) -> "SE3":
        """Exponential map se(3) -> SE(3); xi = (..., 6) as [rho, phi]."""
        rho, phi = xi[..., :3], xi[..., 3:]
        # left Jacobian of SO3 = right_jacobian(-phi)
        return SE3(so3.exp(phi), _mv(so3.right_jacobian(-phi), rho))

    def log(self) -> torch.Tensor:
        phi = so3.log(self.R)
        rho = _mv(so3.inverse_right_jacobian(-phi), self.t)
        return torch.cat([rho, phi], dim=-1)

    def normalized(self) -> "SE3":
        return SE3(so3.normalize(self.R), self.t)
