"""Robust kernels as IRLS weights (g2o RobustKernelHuber/Cauchy semantics).

Port of ppg_slam_tpu/estimator/robust.py. g2o scales each residual's
information by rho'(chi2); the reference uses Huber(sqrt(5.991)) for pose
optimization, Cauchy(sqrt(5.991)) for mapping reprojection,
Huber(sqrt(7.815)) for colines, Huber(sqrt(16.92)) for the last inertial
link (SURVEY.md §2.4).
"""

from __future__ import annotations

import torch

# chi-square thresholds used throughout the reference
CHI2_MONO = 5.991       # 2-DOF 95%
CHI2_COLINE = 7.815     # 3-DOF 95%
CHI2_INERTIAL = 16.92   # 9-DOF-ish, used on last temporal link


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """rho'(chi2) for Huber with threshold delta (g2o setDelta semantics:
    quadratic for chi2 <= delta^2)."""
    d2 = delta * delta
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= d2, 1.0, delta / torch.sqrt(safe))


def cauchy_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """rho'(chi2) for Cauchy with scale delta^2."""
    d2 = delta * delta
    return 1.0 / (1.0 + chi2 / d2)


def no_kernel(chi2: torch.Tensor, delta=0.0) -> torch.Tensor:
    return torch.ones_like(chi2)


KERNELS = {"huber": huber_weight, "cauchy": cauchy_weight, "none": no_kernel}

K_NONE, K_HUBER, K_CAUCHY = 0, 1, 2
KERNEL_CODES = {"none": K_NONE, "huber": K_HUBER, "cauchy": K_CAUCHY}


def kernel_code(kernel):
    """str -> int code; int codes pass through."""
    return KERNEL_CODES[kernel] if isinstance(kernel, str) else kernel


def kernel_weight(code, chi2, delta):
    """rho'(chi2) selected by kernel code (a Python int or a name)."""
    code = kernel_code(code)
    if code == K_NONE:
        return torch.ones_like(chi2)
    if code == K_HUBER:
        return huber_weight(chi2, delta)
    return cauchy_weight(chi2, delta)


def kernel_rho(code, chi2, delta):
    """Robust loss value rho(chi2) selected by kernel code (for the
    total-cost bookkeeping and the LM accept tests)."""
    code = kernel_code(code)
    if code == K_NONE:
        return chi2
    d2 = max(delta * delta, 1e-12)
    if code == K_HUBER:
        return torch.where(
            chi2 <= d2, chi2,
            2.0 * delta * torch.sqrt(torch.clamp(chi2, min=1e-12)) - d2)
    return d2 * torch.log1p(chi2 / d2)
