"""The device's work by the program's span that issued it, in a traced
window, and a traced run of a cell that reports it.

With `profiler.tracing` on, the program records one span a stage timer
(ppg_slam_tpu_torch/utils/profiling.py): start and end on the wall clock,
the thread's id, its depth, its name. torch.profiler's CUDA activity holds,
beside the device operations, the CUDA runtime and driver calls that
launched them and the host's waits on the device, each stamped with the
wall clock and with the low 32 bits of its thread's pthread id
(`device_resource_id()`), and a correlation id that ties a kernel, copy or
set to the call that launched it. `attribute` gives each span name the
calls its thread made while a span of that name was open, each call once:
a stage's counts hold those of the stages inside it.

    python3 -m slam_bench.attribution --workload tumvi-cruise \\
        --seed 17 --seconds 51 [--tracing 0]

runs the cell as `slam_bench.run --trace 1` does, with the program's spans
on (`--tracing 0`: off, for the cost of recording them), and prints the
run's result line (its breakdown IDLE_SPANS entries long) with an
`attribution` field: the readings below, each stage's counts, the tracking
thread's totals, the seconds the attribution took and the clock margins
(`clock_margins_ns`).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

# CUDA runtime and driver calls that queue work on a stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")
# calls that block the host until the device has done queued work
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize", "cudaMemcpy")
LAUNCH, SYNC = 0, 1
TID_MASK = 0xFFFFFFFF  # CUPTI keeps the low 32 bits of a thread's id

# stage name and thread totals each reading of the run divides
STAGE_READINGS = {
    "pose_inertial_launches": ("tracking.pose_inertial", "launches"),
    "pose_inertial_syncs": ("tracking.pose_inertial", "syncs"),
    "pose_inertial_busy_ms": ("tracking.pose_inertial", "busy_s"),
    "lba_launches": ("local_mapping.lba", "launches"),
    "lba_syncs": ("local_mapping.lba", "syncs"),
}
FRAME_READINGS = {"frame_launches": "launches", "frame_syncs": "syncs"}
IDLE_SPANS = 40  # the breakdown's longest idle gaps and device operations


class Calls:
    """The window's runtime calls (thread, start and end ns, LAUNCH or
    SYNC, correlation id) and device operations (correlation id, device
    ns), as arrays."""

    def __init__(self, tid, start, end, kind, corr, op_corr, op_ns):
        order = np.argsort(start, kind="stable")
        self.tid = np.asarray(tid, np.int64)[order] & TID_MASK
        self.start = np.asarray(start, np.int64)[order]
        self.end = np.asarray(end, np.int64)[order]
        self.kind = np.asarray(kind, np.int8)[order]
        self.corr = np.asarray(corr, np.int64)[order]
        self.device_ns = _device_ns(self.corr, np.asarray(op_corr, np.int64),
                                    np.asarray(op_ns, np.int64))

    @classmethod
    def from_profile(cls, prof) -> "Calls":
        """From a finished torch.profiler session with CUDA activity."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        kinds = {n: LAUNCH for n in LAUNCHES}
        kinds.update({n: SYNC for n in SYNCS})
        rows, ops = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                ops.append((e.correlation_id(), e.duration_ns()))
                continue
            k = kinds.get(e.name())
            if k is not None:
                s = e.start_ns()
                rows.append((e.device_resource_id(), s, s + e.duration_ns(),
                             k, e.correlation_id()))
        r = np.asarray(rows, np.int64).reshape(-1, 5)
        o = np.asarray(ops, np.int64).reshape(-1, 2)
        return cls(r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4],
                   o[:, 0], o[:, 1])

    def totals(self, tid: int) -> dict:
        """launches, syncs and busy_s of every call of thread `tid`."""
        on = self.tid == (tid & TID_MASK)
        return dict(launches=int((on & (self.kind == LAUNCH)).sum()),
                    syncs=int((on & (self.kind == SYNC)).sum()),
                    busy_s=float(self.device_ns[on].sum()) * 1e-9)


def _device_ns(corr, op_corr, op_ns):
    """The device ns of the operations each call launched (0 for none)."""
    if not len(op_corr):
        return np.zeros(len(corr), np.int64)
    ids, inv = np.unique(op_corr, return_inverse=True)
    per = np.bincount(inv, weights=op_ns).astype(np.int64)
    pos = np.minimum(np.searchsorted(ids, corr), len(ids) - 1)
    return np.where(ids[pos] == corr, per[pos], 0)


def _outermost(start, end):
    """Mask of the spans (sorted by start) that no earlier one holds."""
    reach = np.maximum.accumulate(end)
    return np.r_[True, start[1:] >= reach[:-1]]


def attribute(spans, calls: Calls) -> dict:
    """{name: dict(spans, launches, syncs, busy_s)} over the program's
    `spans` rows (start ns, end ns, thread id, depth, name): a name's
    spans that no span of the same name on their thread holds, the
    launches and syncs their thread started inside them, and the device
    seconds of the operations those launches queued. A call outside every
    span goes to no name. Also "clock_margins_ns": the least time from a
    span's start to the first call inside it and from the end of its last
    call to the span's end, over the spans holding calls; both are >= 0
    where the two clocks agree to within them."""
    out, lead, tail = {}, [], []
    if not len(spans):
        return dict(stages=out, clock_margins_ns=None)
    rows = sorted(spans, key=lambda r: (r[2] & TID_MASK, r[4], r[0]))
    start = np.asarray([r[0] for r in rows], np.int64)
    end = np.asarray([r[1] for r in rows], np.int64)
    tid = np.asarray([r[2] for r in rows], np.int64) & TID_MASK
    names = [r[4] for r in rows]
    cuts = [0] + [i for i in range(1, len(rows))
                  if (tid[i], names[i]) != (tid[i - 1], names[i - 1])]
    cuts.append(len(rows))
    by_tid = {}
    for a, b in zip(cuts[:-1], cuts[1:]):
        t = int(tid[a])
        if t not in by_tid:
            on = calls.tid == t
            t_start, kind = calls.start[on], calls.kind[on]
            cum = [np.r_[0, np.cumsum(x)] for x in
                   (kind == LAUNCH, kind == SYNC, calls.device_ns[on])]
            # the latest end of a call up to each one
            reach = np.maximum.accumulate(calls.end[on])
            by_tid[t] = (t_start, reach, cum)
        t_start, reach, (cl, cs, cb) = by_tid[t]
        keep = _outermost(start[a:b], end[a:b])
        s, e = start[a:b][keep], end[a:b][keep]
        lo = np.searchsorted(t_start, s, "left")
        hi = np.searchsorted(t_start, e, "left")
        c = out.setdefault(names[a], dict(spans=0, launches=0, syncs=0,
                                          busy_s=0.0))
        c["spans"] += int(keep.sum())
        c["launches"] += int((cl[hi] - cl[lo]).sum())
        c["syncs"] += int((cs[hi] - cs[lo]).sum())
        c["busy_s"] += float((cb[hi] - cb[lo]).sum()) * 1e-9
        held = hi > lo
        if held.any():
            lead.append(int((t_start[lo[held]] - s[held]).min()))
            tail.append(int((e[held] - reach[hi[held] - 1]).min()))
    margins = [min(lead), min(tail)] if lead else None
    return dict(stages=out, clock_margins_ns=margins)


def readings(stages: dict, thread: dict, frames: int) -> dict:
    """The per-layer readings of the device's work: launches and syncs
    on the tracking thread a window frame; launches, syncs and device ms
    a call of the stages in STAGE_READINGS. None where there is nothing
    to read."""
    out = {}
    for key, field in FRAME_READINGS.items():
        out[key] = thread[field] / frames if frames else None
    for key, (name, field) in STAGE_READINGS.items():
        c = stages.get(name)
        v = c[field] / c["spans"] if c and c["spans"] else None
        out[key] = v * 1e3 if v is not None and field == "busy_s" else v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    from . import registry, run, trace

    import torch

    from ppg_slam_tpu_torch.utils import profiler

    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        run.say(f"no result: the cell needs {cell['chips']} CUDA device(s)")
        return 2
    tracking = threading.get_ident()  # run.Run tracks on this thread
    got = {}

    class SpannedTrace(trace.DeviceTrace):
        def __enter__(self):
            profiler.spans.clear()
            profiler.tracing = bool(args.tracing)
            return super().__enter__()

        def __exit__(self, *exc):
            try:
                return super().__exit__(*exc)
            finally:
                profiler.tracing = False

        def summary(self, spans, top=IDLE_SPANS, **kw):
            # idle time under more spans than the benchmark's line lists
            out = super().summary(spans, top=top, **kw)
            t0 = time.time()
            calls = Calls.from_profile(self.prof)
            got.update(attribute(profiler.spans, calls),
                       thread=calls.totals(tracking),
                       n_calls=len(calls.start), n_spans=len(profiler.spans))
            got["attribution_s"] = time.time() - t0
            return out

    trace.DeviceTrace = SpannedTrace
    r = run.Run(cell, registry.config(cell["config"]),
                registry.traffic(cell["traffic"]), args.seed, args.seconds,
                True)
    line = run.execute(r, bench)
    found = run.forbidden_modules()
    if found:
        run.say(f"no result: modules {found} are loaded")
        return 3
    got["readings"] = readings(got["stages"], got["thread"], len(r.rows))
    got["tracing"] = bool(args.tracing)
    line["attribution"] = got
    run.say(f"attribution: {got['n_calls']} runtime calls, "
            f"{got['n_spans']} spans, read in {got['attribution_s']:.2f} s")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
