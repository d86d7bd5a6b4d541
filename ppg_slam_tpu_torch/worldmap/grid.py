"""64x48 feature grid for windowed feature lookup.

Copy of ppg_slam_tpu/worldmap/grid.py; the corners are undistorted by the
port's camera on a CPU tensor.

Mirrors the reference's grid (GeometricCamera.h FRAME_GRID_COLS/ROWS = 64/48,
Frame::AssignFeaturesToGrid / GetFeaturesInArea, Frame.cpp:138-156, 262-315).
Image bounds come from undistorting the corners for distorted pinhole cameras
(GeometricCamera.cpp:26-55).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..geometry.cameras import CAM_PINHOLE, GRID_COLS, GRID_ROWS, CameraModel


@lru_cache(maxsize=8)
def image_bounds(cam: CameraModel):
    """(min_x, max_x, min_y, max_y) — undistorted corner bounds for pinhole."""
    if cam.kind == CAM_PINHOLE and any(abs(d) > 0 for d in cam.dist):
        corners = np.array(
            [[0, 0], [cam.width, 0], [0, cam.height], [cam.width, cam.height]],
            np.float32)
        und = cam.undistort_points(torch.from_numpy(corners)).numpy()
        min_x = int(min(und[0, 0], und[2, 0]))
        max_x = int(max(und[1, 0], und[3, 0]))
        min_y = int(min(und[0, 1], und[1, 1]))
        max_y = int(max(und[2, 1], und[3, 1]))
        return min_x, max_x, min_y, max_y
    return 0, cam.width, 0, cam.height


class FeatureGrid:
    """Per-frame spatial index over keypoint positions (kp 'mPos')."""

    __slots__ = ("min_x", "min_y", "inv_w", "inv_h", "cells", "kp",
                 "ok_mask")

    def __init__(self, cam: CameraModel, kp_pos: np.ndarray) -> None:
        min_x, max_x, min_y, max_y = image_bounds(cam)
        self.min_x = min_x
        self.min_y = min_y
        self.inv_w = GRID_COLS / (max_x - min_x)
        self.inv_h = GRID_ROWS / (max_y - min_y)
        self.kp = kp_pos
        self.cells: List[List[List[int]]] = [
            [[] for _ in range(GRID_ROWS)] for _ in range(GRID_COLS)
        ]
        cx = np.floor((kp_pos[:, 0] - min_x) * self.inv_w).astype(int)
        cy = np.floor((kp_pos[:, 1] - min_y) * self.inv_h).astype(int)
        ok = (cx >= 0) & (cx < GRID_COLS) & (cy >= 0) & (cy < GRID_ROWS)
        self.ok_mask = ok  # grid-assignment eligibility (device matching)
        for i in np.nonzero(ok)[0]:
            self.cells[cx[i]][cy[i]].append(int(i))

    def features_in_area(self, x: float, y: float, r: float) -> List[int]:
        min_cx = max(0, int(math.floor((x - self.min_x - r) * self.inv_w)))
        if min_cx >= GRID_COLS:
            return []
        max_cx = min(GRID_COLS - 1,
                     int(math.ceil((x - self.min_x + r) * self.inv_w)))
        if max_cx < 0:
            return []
        min_cy = max(0, int(math.floor((y - self.min_y - r) * self.inv_h)))
        if min_cy >= GRID_ROWS:
            return []
        max_cy = min(GRID_ROWS - 1,
                     int(math.ceil((y - self.min_y + r) * self.inv_h)))
        if max_cy < 0:
            return []
        out = []
        for ix in range(min_cx, max_cx + 1):
            for iy in range(min_cy, max_cy + 1):
                for j in self.cells[ix][iy]:
                    if (abs(self.kp[j, 0] - x) < r
                            and abs(self.kp[j, 1] - y) < r):
                        out.append(j)
        return out

    def is_in_image(self, x: float, y: float) -> bool:
        return (self.min_x <= x < self.min_x + GRID_COLS / self.inv_w
                and self.min_y <= y < self.min_y + GRID_ROWS / self.inv_h)
