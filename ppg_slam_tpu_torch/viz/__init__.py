"""Offline viewer (headless MSViewing equivalent)."""

from .render import Canvas3D, draw_text_bar, look_at
from .viewer import Viewer

__all__ = ["Canvas3D", "Viewer", "draw_text_bar", "look_at"]
