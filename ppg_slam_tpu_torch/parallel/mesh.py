"""A one-axis device mesh: the port's counterpart of the reference's
`jax.sharding.Mesh(devices, ("dp",))`.

The reference passes its mesh into calls made within one process
(`global_bundle_adjustment(mesh=)`, `full_inertial_ba(mesh=)`,
`PPGExtractor.extract_batch(mesh=)`), LoopClosing's GBA thread among them.
The port keeps that shape: a Mesh is a single-controller list of devices,
and the calls that take one run a piece of their work on each device and
reduce on the first (the lead) device. A `torch.distributed` process group
would instead need every rank to run the whole System.
"""

from __future__ import annotations

from typing import Sequence

import torch


def canonical_device(device) -> torch.device:
    """`device` with its index made explicit (`cuda` -> `cuda:<current>`),
    so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ordered list of devices; a device may appear more than once (two
    shards on one card). Raises at construction where a device names a CUDA
    card the machine lacks: its shards never run elsewhere."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            dev = torch.device(d)
            if dev.type == "cuda":
                count = torch.cuda.device_count() \
                    if torch.cuda.is_available() else 0
                if (dev.index or 0) >= count:
                    raise RuntimeError(
                        f"Mesh: {dev} is not present ({count} CUDA "
                        "device(s) on this machine)")
            devs.append(canonical_device(dev))
        if not devs:
            raise ValueError("Mesh: no devices")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device where the reductions meet."""
        return self.devices[0]

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of one tensor a shard, on the lead device, added in
        shard order (a fixed order: the same inputs give the same bits)."""
        if len(parts) != self.size:
            raise ValueError(f"Mesh.psum: {len(parts)} parts for "
                             f"{self.size} shards")
        out = parts[0].to(self.lead)
        for p in parts[1:]:
            out = out + p.to(self.lead)
        return out
