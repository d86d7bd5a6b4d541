"""IMU preintegration: the reference's Preintegrated in PyTorch.

Port of ppg_slam_tpu/imu/preintegration.py (IMU.cpp:218-276,
IntegrateNewMeasurement: dR/dV/dP updates, the 15x15 covariance by the A/B
propagation, the 5 bias Jacobians). `integrate` is a Python loop over the
samples on the tensors' device, one IntegrateNewMeasurement per sample;
masked samples are no-ops. The per-sample rotation increments and their
right Jacobians do not depend on the state, so they are formed for all
samples at once before the loop.

State layout (all float32):
  dR (3,3)  dV (3,)  dP (3,)  - deltas at the original bias b
  JRg JVg JVa JPg JPa (3,3)   - d(delta)/d(bias) Jacobians
  C (15,15)                   - [theta, v, p, bg, ba] covariance
  dT ()                       - total time
  avgA avgW (3,)              - running averages (used by IMU init checks)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import so3
from ..utils import profiler

GRAVITY_VALUE = 9.81  # reference IMU.h:22


class PreintState(NamedTuple):
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor
    dT: torch.Tensor
    avgA: torch.Tensor
    avgW: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "PreintState":
        z33 = torch.zeros((3, 3), dtype=dtype, device=device)
        z3 = torch.zeros((3,), dtype=dtype, device=device)
        return PreintState(
            dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
            JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
            C=torch.zeros((15, 15), dtype=dtype, device=device),
            dT=torch.zeros((), dtype=dtype, device=device), avgA=z3, avgW=z3)

    def numpy(self) -> "PreintState":
        """Host copy (one device->host transfer for all fields)."""
        flat = torch.cat([x.reshape(-1) for x in self]).cpu().numpy()
        out, k = [], 0
        for x in self:
            out.append(flat[k:k + x.numel()].reshape(tuple(x.shape)))
            k += x.numel()
        return PreintState(*out)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def integrate(acc: torch.Tensor, gyr: torch.Tensor, dt: torch.Tensor,
              valid: torch.Tensor, bias: torch.Tensor, nga: torch.Tensor,
              nga_walk: torch.Tensor) -> PreintState:
    """Preintegrate a measurement buffer on its device.

    acc/gyr: (N, 3); dt/valid: (N,); bias: (6,) = [bg, ba];
    nga/nga_walk: (6,) diagonal noise [gyro(3), acc(3)] already scaled by
    sqrt(freq) resp. 1/sqrt(freq) (reference System.cpp:97-98).
    """
    profiler.count_device("integrate", acc)
    dtype, dev = acc.dtype, acc.device
    bg, ba = bias[:3], bias[3:]
    accs = acc - ba
    w_dts = (gyr - bg) * dt[:, None]
    dRis = so3.exp(w_dts)                      # (N, 3, 3)
    rightJs = so3.right_jacobian(w_dts)
    Waccs = so3.hat(accs)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Nga = torch.diag(nga)
    walk = torch.diag(nga_walk)
    s = PreintState.identity(dtype, dev)
    for k in range(acc.shape[0]):
        a, dtk = accs[k], dt[k]
        dRi, rightJ, Wacc = dRis[k], rightJs[k], Waccs[k]
        dR = s.dR
        dRa = _mv(dR, a)
        avgA = (s.dT * s.avgA + dRa * dtk) / (s.dT + dtk)
        avgW = (s.dT * s.avgW + (gyr[k] - bg) * dtk) / (s.dT + dtk)
        # position/velocity first (use the non-updated rotation)
        dP = s.dP + s.dV * dtk + 0.5 * dRa * dtk * dtk
        dV = s.dV + dRa * dtk
        dRdt = dR * dtk
        # bias Jacobians (JPa/JPg use the old JVa/JVg)
        dRWJ = dR @ Wacc @ s.JRg
        JPa = s.JPa + s.JVa * dtk - 0.5 * dRdt * dtk
        JPg = s.JPg + s.JVg * dtk - 0.5 * dtk * dtk * dRWJ
        JVa = s.JVa - dRdt
        JVg = s.JVg - dtk * dRWJ
        dR_new = so3.normalize(dR @ dRi)
        # covariance: C9 = A C9 A^T + B Nga B^T; the bias walk adds on 6x6
        dRW = dRdt @ Wacc
        zero = torch.zeros_like(eye3)
        A = torch.cat([
            torch.cat([dRi.T, zero, zero], 1),
            torch.cat([-dRW, eye3, zero], 1),
            torch.cat([-0.5 * dtk * dRW, eye3 * dtk, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([rightJ * dtk, zero], 1),
            torch.cat([zero, dRdt], 1),
            torch.cat([zero, 0.5 * dtk * dRdt], 1)], 0)
        C9 = A @ s.C[:9, :9] @ A.T + B @ Nga @ B.T
        C = torch.cat([
            torch.cat([C9, s.C[:9, 9:]], 1),
            torch.cat([s.C[9:, :9], s.C[9:, 9:] + walk], 1)], 0)
        JRg = dRi.T @ s.JRg - rightJ * dtk
        new = PreintState(dR=dR_new, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                          JPg=JPg, JPa=JPa, C=C, dT=s.dT + dtk, avgA=avgA,
                          avgW=avgW)
        v = valid[k]
        s = PreintState(*(torch.where(v, n, o) for n, o in zip(new, s)))
    return s


def corrected_deltas(state: PreintState, bias0, bias_new):
    """GetDeltaRotation/Velocity/Position(b_) (IMU.cpp:328-365): first-order
    bias-corrected deltas without re-integration. numpy state and biases
    give numpy (the host getters); tensors give tensors."""
    db = bias_new - bias0
    dbg, dba = db[:3], db[3:]
    dR = state.dR @ so3.exp(state.JRg @ dbg)
    dV = state.dV + state.JVg @ dbg + state.JVa @ dba
    dP = state.dP + state.JPg @ dbg + state.JPa @ dba
    return so3.normalize(dR), dV, dP


class Preintegrated:
    """Host-side wrapper: measurement storage + device integration.

    Plays the role of IMU::Preintegrated (IMU.h:120-235): stores raw
    measurements so `reintegrate`/`merge_previous` can recompute with a new
    bias; exposes the original/updated/bias-corrected delta getters used by
    tracking and the inertial residuals. The state is kept as numpy; the
    integration runs on `device` (CUDA unless the caller names another).
    """

    __slots__ = ("b", "bu", "nga", "nga_walk", "_acc", "_gyr", "_dt", "state",
                 "device")

    def __init__(self, bias: np.ndarray, nga: np.ndarray, nga_walk: np.ndarray,
                 device=None):
        self.device = resolve_device(device)
        self.b = np.asarray(bias, np.float32).copy()      # original bias [bg, ba]
        self.bu = self.b.copy()                            # updated bias
        self.nga = np.asarray(nga, np.float32)
        self.nga_walk = np.asarray(nga_walk, np.float32)
        self._acc: list = []
        self._gyr: list = []
        self._dt: list = []
        self.state = PreintState.identity().numpy()

    # -- measurement management -------------------------------------------
    def integrate_measurements(self, acc: np.ndarray, gyr: np.ndarray,
                               dt: np.ndarray) -> None:
        """Append measurements and integrate them all (one device call)."""
        acc = np.atleast_2d(np.asarray(acc, np.float32))
        gyr = np.atleast_2d(np.asarray(gyr, np.float32))
        dt = np.atleast_1d(np.asarray(dt, np.float32))
        self._acc.extend(acc)
        self._gyr.extend(gyr)
        self._dt.extend(dt)
        self._recompute(self.b)

    def reintegrate(self) -> None:
        """Reference Reintegrate (IMU.cpp:212-218): redo with updated bias."""
        self.b = self.bu.copy()
        self._recompute(self.b)

    def merge_previous(self, prev: "Preintegrated") -> None:
        """Reference MergePrevious (IMU.cpp:280-303): prepend prev's
        measurements and re-integrate at the updated bias."""
        if prev is self:
            return
        self._acc = list(prev._acc) + self._acc
        self._gyr = list(prev._gyr) + self._gyr
        self._dt = list(prev._dt) + self._dt
        self.b = self.bu.copy()
        self._recompute(self.b)

    def _recompute(self, bias: np.ndarray) -> None:
        n = len(self._dt)
        if n == 0:
            self.state = PreintState.identity().numpy()
            return
        # one upload for all inputs; the exact n samples, no padding
        host = np.concatenate([np.asarray(self._acc, np.float32).reshape(-1),
                               np.asarray(self._gyr, np.float32).reshape(-1),
                               np.asarray(self._dt, np.float32), bias,
                               self.nga, self.nga_walk])
        dev = torch.from_numpy(host).to(self.device)
        acc, gyr, dt, b, nga, walk = torch.split(
            dev, [3 * n, 3 * n, n, 6, 6, 6])
        valid = torch.ones(n, dtype=torch.bool, device=self.device)
        self.state = integrate(acc.view(n, 3), gyr.view(n, 3), dt, valid, b,
                               nga, walk).numpy()

    # -- getters (mirror the reference API) --------------------------------
    @property
    def dT(self) -> float:
        return float(self.state.dT)

    @property
    def C(self) -> np.ndarray:
        return np.asarray(self.state.C)

    def set_new_bias(self, bias_new: np.ndarray) -> None:
        self.bu = np.asarray(bias_new, np.float32).copy()

    def get_delta_bias(self) -> np.ndarray:
        return self.bu - self.b

    def delta_rotation(self, bias: np.ndarray | None = None) -> np.ndarray:
        b = self.bu if bias is None else np.asarray(bias, np.float32)
        return corrected_deltas(self.state, self.b, b)[0]

    def delta_velocity(self, bias: np.ndarray | None = None) -> np.ndarray:
        b = self.bu if bias is None else np.asarray(bias, np.float32)
        return corrected_deltas(self.state, self.b, b)[1]

    def delta_position(self, bias: np.ndarray | None = None) -> np.ndarray:
        b = self.bu if bias is None else np.asarray(bias, np.float32)
        return corrected_deltas(self.state, self.b, b)[2]

    def original_deltas(self):
        return (np.asarray(self.state.dR), np.asarray(self.state.dV),
                np.asarray(self.state.dP))

    def copy(self) -> "Preintegrated":
        out = Preintegrated(self.b, self.nga, self.nga_walk, self.device)
        out.bu = self.bu.copy()
        out._acc = list(self._acc)
        out._gyr = list(self._gyr)
        out._dt = list(self._dt)
        out.state = self.state
        return out
