"""The host world map: a copy of ppg_slam_tpu/worldmap (numpy bookkeeping,
no device code), with map checkpoints (serialize.py)."""

from .elements import (MapColine, MapEdge, MapPoint, descriptor_distance,
                       reset_element_ids)
from .frame import Frame, KeyFrame, Rig, reset_frame_ids
from .grid import FeatureGrid, image_bounds
from .map import Map
from .serialize import load_map, save_map


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
    "load_map",
    "save_map",
    "reset_ids",
]
