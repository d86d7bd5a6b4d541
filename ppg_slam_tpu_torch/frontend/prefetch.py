"""Live front-end pipelining: batched look-ahead extraction (a copy of
ppg_slam_tpu/frontend/prefetch.py over the port's extractor).

The reference overlaps feature extraction with mapping/loop closing via
threads (System.cpp:106-116). Here the DEVICE work of future frames
overlaps the HOST work of the current one: the driver feeds frames ahead of
tracking, the prefetcher groups them into fixed-size batches, each one
`PPGExtractor.extract_batch_async` call (on CUDA: on the extractor's own
stream), and tracking consumes results in order while later batches are
already in flight.

Look-ahead depth is bounded (batch * depth frames), which bounds the pose
staleness of any downstream consumer; the tracker's device-matching gates
are computed at match time (tracking.search_local_points), not at dispatch
time, so prefetching does not change association semantics.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import numpy as np

from ..utils import profiler
from .extractor import FrameFeatures, PPGExtractor


class FramePrefetcher:
    """In-order feature prefetch: feed() images ahead, get() results.

    batch: frames per device dispatch (the tail batch is padded to it).
    depth: max in-flight batches; feed() beyond the window is buffered
    host-side without dispatching.
    """

    def __init__(self, extractor: PPGExtractor, batch: int = 4,
                 depth: int = 2):
        self.ex = extractor
        self.batch = batch
        self.depth = depth
        self._staged: List[np.ndarray] = []
        self._inflight: Deque[Tuple[object, int]] = deque()  # (handle, real)
        self._ready: Deque[FrameFeatures] = deque()
        self.n_dispatches = 0

    def _dispatch(self, flush: bool = False) -> None:
        if not self._staged or len(self._inflight) >= self.depth:
            return
        n_real = min(len(self._staged), self.batch)
        if n_real < self.batch:
            if not flush:
                return
            # flush: pad the tail batch with repeats (the reference's fixed
            # batch shape); the surplus results are dropped on receipt
            imgs = self._staged + [self._staged[-1]] * (self.batch - n_real)
            self._staged = []
        else:
            imgs = self._staged[:self.batch]
            del self._staged[:self.batch]
        with profiler.timer("frontend.dispatch"):
            handle = self.ex.extract_batch_async(imgs)
        self._inflight.append((handle, n_real))
        self.n_dispatches += 1

    def feed(self, image: np.ndarray) -> None:
        self._staged.append(image)
        self._dispatch()

    def pending(self) -> int:
        return (len(self._staged) + len(self._ready)
                + sum(n for _, n in self._inflight))

    def get(self) -> FrameFeatures:
        """Next frame's features, in feed order (blocks on the device)."""
        with profiler.timer("frontend.get"):
            while not self._ready:
                if not self._inflight:
                    self._dispatch(flush=True)
                    if not self._inflight:
                        raise RuntimeError(
                            "prefetcher is empty — feed() first")
                handle, n_real = self._inflight.popleft()
                self._ready.extend(handle.result()[:n_real])
                self._dispatch()  # keep the window full
            return self._ready.popleft()
