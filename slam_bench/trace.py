"""What the traced run reads besides the program's stage timers: the device's
operations from torch.profiler, and spans of what the host was doing.

`DeviceTrace` records the CUDA activity of the window (kernels, copies and
sets on every stream) and reduces it to the union of busy intervals, the
time and calls by operation name, and the longest idle gaps.
`Spans` records host spans (start, end, name) by wall clock: the harness's
own around its calls into the System, and the program's stage timers
(utils/profiling.py `profiler.timer`), which `Spans.capture` reads while they
run, on the main thread. Idle time is put down to the innermost span over
it, in 10 us bins.
The busy union replaces chip_smoke.py `BusyWindow`'s sum of kernel
durations, which counts kernels that overlap on two streams twice.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import numpy as np

NAME_CHARS = 160  # an operation's name in the breakdown, cut to this


class Spans:
    def __init__(self):
        self.rows = []  # (start ns, end ns, depth, name)
        self.depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            self.rows.append((t0, time.time_ns(), self.depth, name))

    @contextlib.contextmanager
    def capture(self, profiler):
        """Record every stage timer of the program's `profiler` that runs
        on this thread as a span while inside, besides its own
        accounting."""
        timer = profiler.timer
        main = threading.get_ident()

        @contextlib.contextmanager
        def recorded(name):
            if threading.get_ident() != main:
                with timer(name):
                    yield
                return
            with self.span(name), timer(name):
                yield

        profiler.timer = recorded
        try:
            yield
        finally:
            del profiler.timer  # the instance attribute; the method is back

    def labels(self, t0: int, t1: int, bin_ns: int):
        """(names, ids): the innermost span over each bin of [t0, t1),
        id 0 ("harness") where no span covers it."""
        n = max(1, -(-(t1 - t0) // bin_ns))
        ids = np.zeros(n, np.int32)
        names = ["harness"]
        index = {}
        for s, e, _, name in sorted(self.rows, key=lambda r: r[2]):
            lo, hi = max(0, (s - t0) // bin_ns), min(n, -(-(e - t0) // bin_ns))
            if hi > lo:
                ids[lo:hi] = index.setdefault(name, len(index) + 1)
                if len(names) <= index[name]:
                    names.append(name)
        return names, ids


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def summary(self, spans: Spans, top: int = 10,
                bin_ns: int = 10_000) -> dict:
        """busy_s and window_s of the traced window, ops {name: [calls,
        seconds]}, and breakdown: device_ops, the `top` operations by
        device time, and idle_gaps, the device's idle time by the span the
        host was in (10 us bins), the `top` largest."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        ivs, ops = [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s, d = e.start_ns(), e.duration_ns()
            ivs.append((s, s + d))
            c = ops.setdefault(e.name(), [0, 0.0])
            c[0] += 1
            c[1] += d * 1e-9
        t0, t1 = self.t0, self.t1
        if ivs:
            lo_, hi_ = min(i[0] for i in ivs), max(i[1] for i in ivs)
            print(f"trace: {len(ivs)} device operations from "
                  f"{(lo_ - t0) * 1e-9:+.3f} s to {(hi_ - t0) * 1e-9:+.3f} s "
                  f"of the window's {(t1 - t0) * 1e-9:.3f} s",
                  file=sys.stderr, flush=True)
        n = max(1, -(-(t1 - t0) // bin_ns))
        busy_bins = np.zeros(n + 1, np.int64)
        busy = 0
        if ivs:
            a = np.clip(np.asarray(sorted(ivs), np.int64), t0, t1)
            end = np.maximum.accumulate(a[:, 1])
            first = np.nonzero(np.r_[True, a[1:, 0] > end[:-1]])[0]
            last = np.r_[first[1:] - 1, len(a) - 1]
            lo, hi = a[first, 0], end[last]
            busy = int((hi - lo).sum())
            np.add.at(busy_bins, (lo - t0) // bin_ns, 1)
            np.add.at(busy_bins, -(-(hi - t0) // bin_ns), -1)
        idle = np.cumsum(busy_bins)[:n] <= 0
        names, ids = spans.labels(t0, t1, bin_ns)
        per = np.bincount(ids[idle], minlength=len(names)) * bin_ns * 1e-9
        idle_gaps = sorted(([names[i], float(per[i])] for i in range(len(names))
                            if per[i] > 0), key=lambda r: -r[1])[:top]
        device_ops = sorted(([n_[:NAME_CHARS], c[1]] for n_, c in ops.items()),
                            key=lambda r: -r[1])[:top]
        return dict(busy_s=busy * 1e-9, window_s=(t1 - t0) * 1e-9, ops=ops,
                    breakdown=dict(device_ops=device_ops,
                                   idle_gaps=idle_gaps))
