"""Where the port's entry points run: CUDA unless the caller names a device."""

from __future__ import annotations

import numpy as np
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


class StaticBuffers:
    """Device tensors of fixed (shape, dtype)s, as a CUDA graph reads its
    inputs, filled from host arrays (`host`, numpy views; pinned for a CUDA
    device) by one host-to-device copy a dtype (`upload`); `dev` holds the
    tensors."""

    def __init__(self, specs, device):
        self.host, self.dev = [None] * len(specs), [None] * len(specs)
        self._flats = []
        pin = torch.device(device).type == "cuda"
        for dtype in dict.fromkeys(d for _, d in specs):
            idx = [k for k, (_, d) in enumerate(specs) if d == dtype]
            sizes = [int(np.prod(specs[k][0])) for k in idx]
            pinned = torch.empty(sum(sizes), dtype=dtype, pin_memory=pin)
            flat = torch.empty(sum(sizes), dtype=dtype, device=device)
            self._flats.append((pinned, flat))
            host, off = pinned.numpy(), 0
            for k, size in zip(idx, sizes):
                self.host[k] = host[off:off + size].reshape(specs[k][0])
                self.dev[k] = flat[off:off + size].view(specs[k][0])
                off += size

    def upload(self) -> None:
        """Queue the copies on the current stream. The caller refills
        `host` only after a host read that follows them."""
        for pinned, flat in self._flats:
            flat.copy_(pinned, non_blocking=True)
