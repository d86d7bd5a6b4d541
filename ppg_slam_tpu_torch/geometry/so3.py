"""SO(3) Lie-group operations, batched over leading axes.

Port of ppg_slam_tpu/geometry/so3.py. Rotations are plain (..., 3, 3)
matrices. Every op runs in numpy when ALL its inputs are host numpy
arrays/scalars (the world map's bookkeeping), and in torch otherwise, on the
tensors' device (the solvers). The numpy path computes with torch on CPU
tensors of the arrays' dtype, and hands numpy back.

`normalize` keeps the reference's split: numpy in gives the exact SVD polar
factor; a tensor in gives two Newton-Schulz iterations (its precondition:
near-orthogonal input), unless `exact=True` forces the SVD.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS = 1e-8


def _is_host(a) -> bool:
    return isinstance(a, (np.ndarray, np.generic, float, int))


def _host_twin(fn):
    """Run `fn` on torch tensors; numpy in (every argument host data) gives
    numpy out."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not all(_is_host(a) for a in args):
            return fn(*args, **kw)
        out = fn(*(torch.from_numpy(np.array(a)) for a in args), **kw)
        return out.numpy()

    return wrapper


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    """|w|^2 as (..., 1, 1): per-rotation scalars keep trailing unit axes,
    so that under torch.func transforms they never become 0-d tensors
    (with which PyTorch promotes Python-float arithmetic to f64)."""
    return torch.sum(w * w, dim=-1)[..., None, None]


@_host_twin
def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vector(s)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


@_host_twin
def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) skew matrix -> (..., 3) vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


@_host_twin
def exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) for (..., 3) tangent vector(s), with
    the small-angle series below |w| = 1e-5."""
    theta2 = _sq_norm(w)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-5
    safe_t2 = torch.where(small, 1.0, theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.sqrt(safe_t2))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    return _eye_like(w, W.shape) + a * W + b * (W @ W)


@_host_twin
def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) for (..., 3, 3) rotation(s): theta from
    the trace, the axis from the antisymmetric part, and the symmetric part
    near theta = pi."""
    Rt = R.transpose(-1, -2)
    S = 0.5 * (R + Rt)
    diag = torch.diagonal(S, dim1=-2, dim2=-1)            # (..., 3)
    tr = diag[..., :1] + diag[..., 1:2] + diag[..., 2:]   # (..., 1)
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_skew = vee(R - Rt) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = theta < 1e-5
    near_pi = sin_theta < 1e-5  # includes both theta~0 and theta~pi
    scale = torch.where(near_pi, 1.0,
                        theta / torch.where(near_pi, 1.0, sin_theta))
    w_generic = w_skew * scale

    one_m_c = 1.0 - cos_theta
    axis2 = torch.clamp((diag - cos_theta) / torch.where(
        torch.abs(one_m_c) < _EPS, 1.0, one_m_c), 0.0, 1.0)
    axis_abs = torch.sqrt(axis2)
    sx = torch.sign(torch.where(torch.abs(w_skew[..., :1]) > _EPS,
                                w_skew[..., :1], 1.0))
    sxy = torch.sign(S[..., 0, 1:2])
    sxz = torch.sign(S[..., 0, 2:3])
    axis_pi = axis_abs * torch.cat(
        [torch.ones_like(sx), torch.where(sxy == 0, 1.0, sxy),
         torch.where(sxz == 0, 1.0, sxz)], dim=-1) * sx
    w_pi = axis_pi * theta
    return torch.where(near_pi & ~small, w_pi, w_generic)


@_host_twin
def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) of SO(3) (reference RightJacobianSO3)."""
    theta2 = _sq_norm(w)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-5
    safe_t2 = torch.where(small, 1.0, theta2)
    safe_t3 = safe_t2 * torch.sqrt(safe_t2)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / safe_t3)
    return _eye_like(w, W.shape) - a * W + b * (W @ W)


@_host_twin
def inverse_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w)^-1 (reference InverseRightJacobianSO3)."""
    theta2 = _sq_norm(w)
    theta = torch.sqrt(theta2)
    W = hat(w)
    small = theta < 1e-5
    safe_t2 = torch.where(small, 1.0, theta2)
    c = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2 - (1.0 + torch.cos(theta))
        / (2.0 * theta * torch.sin(theta) + torch.where(small, 1.0, 0.0)))
    return _eye_like(w, W.shape) + 0.5 * W + c * (W @ W)


def _svd_polar(R: torch.Tensor) -> torch.Tensor:
    """Nearest rotation: U V^T with U's last column flipped where det < 0."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :2], u[..., 2:] * torch.sign(det)[..., None, None]],
                  dim=-1)
    return u @ vt


def normalize(R, exact: bool = False):
    """Re-orthonormalize rotation matrices (reference NormalizeRotation).

    numpy in: the exact SVD polar factor (robust for arbitrary input).
    Tensor in: two Newton-Schulz polar iterations, which need NEAR-ORTHOGONAL
    input (singular values in (0, sqrt(3)), det > 0) and never repair
    det = -1; `exact=True` takes the SVD polar factor instead."""
    if _is_host(R):
        return _svd_polar(torch.from_numpy(np.array(R))).numpy()
    if exact:
        return _svd_polar(R)
    eye = _eye_like(R, R.shape)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = 0.5 * (R @ (3.0 * eye - RtR))
    return R


@_host_twin
def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) as (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


@_host_twin
def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w), branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    case0 = torch.stack([(m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                         (m10 - m01) / (4 * qw), qw], dim=-1)
    case1 = torch.stack([qx, (m01 + m10) / (4 * qx), (m02 + m20) / (4 * qx),
                         (m21 - m12) / (4 * qx)], dim=-1)
    case2 = torch.stack([(m01 + m10) / (4 * qy), qy, (m12 + m21) / (4 * qy),
                         (m02 - m20) / (4 * qy)], dim=-1)
    case3 = torch.stack([(m02 + m20) / (4 * qz), (m12 + m21) / (4 * qz), qz,
                         (m10 - m01) / (4 * qz)], dim=-1)
    c0 = (tr > m00) & (tr > m11) & (tr > m22)
    c1 = (m00 >= tr) & (m00 > m11) & (m00 > m22)
    c2 = (m11 >= tr) & (m11 >= m00) & (m11 > m22)
    q = torch.where(c0[..., None], case0,
                    torch.where(c1[..., None], case1,
                                torch.where(c2[..., None], case2, case3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
