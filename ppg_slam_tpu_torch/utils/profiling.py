"""Per-stage profiling and pipeline counters.

The reference has no systematic tracing (SURVEY.md §5): its example
programs time whole frames with chrono only to pace playback
(try_euroc.cpp:135-147), and the viewer overlays KF/MP counts. The
rebuild makes observability first-class:

  * ``Profiler`` — named wall-time accumulators (count/total/max) with
    a context-manager API, cheap enough to leave on (a dict update per
    stage), plus integer counters;
  * spans — with ``profiler.tracing`` on, each timer also appends one row
    (start ns, end ns, thread id, depth, name) to ``profiler.spans``, on
    the clock of ``now_ns()``: the wall clock that torch.profiler stamps
    its CUDA runtime calls and device operations with, so a device trace
    of the same window can be laid under the spans. The thread id is
    ``threading.get_ident()`` (pthread_self on Linux), which CUPTI stamps
    on each CUDA runtime call a thread makes (torch.profiler gives its low
    32 bits as the call's ``device_resource_id()``); the depth counts the
    spans open on that thread when the span opened;
  * a process-global ``profiler`` instance the pipeline stages report into
    (tracking: preintegrate/extract/pose_opt/local_map; the async
    front-end: frontend.dispatch/get/sync/finish; local mapping: fuse/lba;
    loop closing: detect/correct/gba);
  * ``summary()`` / ``report()`` for the CLI stats dict and bench stderr
    breakdowns;
  * ``count_device`` — the estimator's tensor functions count each call
    under the device it ran on ("device.solve_ba.cuda"), so a run can show
    that none fell back to the CPU.

Enable/disable globally with ``profiler.enabled``; timings of device work
measure the host-blocking dispatch + fetch, the latency the pipeline sees.
Began as a framework-free copy of ppg_slam_tpu/utils/profiling.py; the
spans are the port's own.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple


def now_ns() -> int:
    """The spans' clock (wall-clock ns, torch.profiler's event clock)."""
    return time.time_ns()


class _Stat:
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        if dt > self.max:
            self.max = dt


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tracing = False
        self.stats: Dict[str, _Stat] = {}
        self.counters: Dict[str, int] = {}
        # (start ns, end ns, thread id, depth, name), in the order spans end
        self.spans: List[Tuple[int, int, int, int, str]] = []
        self._open = threading.local()  # .depth: spans open on the thread

    # ------------------------------------------------------------------
    @contextmanager
    def timer(self, name: str):
        if not self.enabled:
            yield
            return
        traced = self.tracing
        if traced:
            depth = getattr(self._open, "depth", 0)
            self._open.depth = depth + 1
            s0 = now_ns()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.setdefault(name, _Stat()).add(
                time.perf_counter() - t0)
            if traced:
                self.spans.append((s0, now_ns(), threading.get_ident(),
                                   depth, name))
                self._open.depth = depth

    def add_time(self, name: str, dt: float) -> None:
        if self.enabled:
            self.stats.setdefault(name, _Stat()).add(dt)

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + n

    def count_device(self, name: str, tensor) -> None:
        """Count one call of `name` under "device.<name>.<device type>",
        the device that of `tensor`, the call's data."""
        self.count(f"device.{name}.{tensor.device.type}")

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        out = {}
        for name, s in sorted(self.stats.items()):
            out[name] = dict(count=s.count, total_ms=s.total * 1e3,
                             mean_ms=(s.total / s.count * 1e3) if s.count
                             else 0.0, max_ms=s.max * 1e3)
        if self.counters:
            out["counters"] = dict(sorted(self.counters.items()))
        return out

    def report(self) -> str:
        lines = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'max ms':>10}"
                 f"{'total s':>10}"]
        for name, s in sorted(self.stats.items(),
                              key=lambda kv: -kv[1].total):
            mean = s.total / s.count * 1e3 if s.count else 0.0
            lines.append(f"{name:<28}{s.count:>7}{mean:>10.2f}"
                         f"{s.max * 1e3:>10.2f}{s.total:>10.2f}")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name:<28}{v:>7}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self.counters.clear()
        self.spans.clear()


# process-global instance the pipeline reports into
profiler = Profiler(enabled=True)
