"""The pipeline: System, Tracking, LocalMapping and LoopClosing (the port
of ppg_slam_tpu/pipeline)."""

from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .system import System, camera_from_settings, load_settings
from .tracking import (
    LOST,
    NOT_INITIALIZED,
    NO_IMAGES_YET,
    OK,
    RECENTLY_LOST,
    Tracking,
)

__all__ = [
    "System",
    "Tracking",
    "LocalMapping",
    "LoopClosing",
    "load_settings",
    "camera_from_settings",
    "NO_IMAGES_YET",
    "NOT_INITIALIZED",
    "OK",
    "RECENTLY_LOST",
    "LOST",
]
