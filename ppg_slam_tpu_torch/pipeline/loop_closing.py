"""Loop closing — the reference MSLoopClosing (system/src/LoopClosing.cpp),
its inactive path.

Port of the part of ppg_slam_tpu/pipeline/loop_closing.py that runs when
loop closing is off: each keyframe handed over by local mapping is added to
the map (again: the reference re-adds it, and Map.add_keyframe appends it
to the BoW inverted file a second time) between set_not_erase and
set_erase. Place recognition, Sim3 estimation, loop correction and the
global BA after a loop (active=True; threaded_gba=True) wait for ROADMAP
§1 items 11.1 and 11.3 and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional

from ..worldmap import KeyFrame, Map

_LOOP_ITEM = ("active loop closing (place recognition, Sim3, loop "
              "correction and its global BA) is not ported yet: ROADMAP.md "
              "§1 item 11.1")


class LoopClosing:
    def __init__(self, wmap: Map, local_mapper=None, active: bool = True):
        if active:
            raise NotImplementedError(_LOOP_ITEM)
        self.map = wmap
        self.local_mapper = local_mapper
        self.active = False
        self.queue: List[KeyFrame] = []
        self.current_kf: Optional[KeyFrame] = None

    @property
    def threaded_gba(self) -> bool:
        return False

    @threaded_gba.setter
    def threaded_gba(self, value: bool) -> None:
        if value:
            raise NotImplementedError(
                "the background global BA after a loop is not ported yet: "
                "ROADMAP.md §1 items 11.1 and 11.3")

    # ------------------------------------------------------------------
    def insert_keyframe(self, kf: KeyFrame) -> None:
        if kf.mnId != 0:
            self.queue.append(kf)
        else:
            self.map.add_keyframe(kf)
        self.process_all()

    def process_all(self) -> None:
        while self.queue:
            self.new_detect_common_regions()

    def reset(self) -> None:
        self.queue.clear()

    # ------------------------------------------------------------------
    def new_detect_common_regions(self) -> bool:
        from ..utils import profiler

        with profiler.timer("loop_closing.detect"):
            return self._new_detect_common_regions_impl()

    def _new_detect_common_regions_impl(self) -> bool:
        """The reference's early branch (LoopClosing.cpp; the JAX
        package's loop_closing.py:123-131), the only one an inactive closer
        takes: the keyframe joins the map and may be erased again."""
        kf = self.queue.pop(0)
        self.current_kf = kf
        kf.set_not_erase()
        self.map.add_keyframe(kf)
        kf.set_erase()
        return False
