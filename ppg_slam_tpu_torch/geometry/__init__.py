from . import so3
from .cameras import (CAM_FISHEYE, CAM_PINHOLE, GRID_COLS, GRID_ROWS,
                      CameraModel, epipolar_sq_dist)
from .se3 import SE3
from .sim3 import Sim3

__all__ = ["so3", "SE3", "Sim3", "CameraModel", "CAM_PINHOLE", "CAM_FISHEYE",
           "GRID_COLS", "GRID_ROWS", "epipolar_sq_dist"]
