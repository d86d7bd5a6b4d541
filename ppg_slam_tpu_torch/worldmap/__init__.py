"""The host world map: a copy of ppg_slam_tpu/worldmap (numpy bookkeeping,
no device code). worldmap/serialize.py is not ported yet."""

from .elements import (MapColine, MapEdge, MapPoint, descriptor_distance,
                       reset_element_ids)
from .frame import Frame, KeyFrame, Rig, reset_frame_ids
from .grid import FeatureGrid, image_bounds
from .map import Map


def reset_ids() -> None:
    """Reset ALL global id counters (full system reset; tests)."""
    reset_frame_ids()
    reset_element_ids()


__all__ = [
    "MapPoint",
    "MapEdge",
    "MapColine",
    "descriptor_distance",
    "Frame",
    "KeyFrame",
    "Rig",
    "FeatureGrid",
    "image_bounds",
    "Map",
    "reset_ids",
]
