"""Where the port's entry points run: CUDA unless the caller names a device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; raises where the device
    named (or defaulted to) is CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; ppg_slam_tpu_torch entry points run "
            "on CUDA unless the caller passes device='cpu'")
    return dev
