"""Dataset loaders: EuRoC / TUM-VI (ASL layout) and UMA-VI; a copy of
ppg_slam_tpu/datasets/loaders.py.

Mirrors the reference drivers' CSV parsing (try_euroc.cpp:28-77 — images from
mav0/cam0/data.csv with nanosecond stamps, IMU from mav0/imu0/data.csv rows
(t, wx, wy, wz, ax, ay, az); try_tumvi.cpp is byte-identical; try_uma.cpp
differs only in CSV paths). Returns timestamps in seconds and IMU rows in the
framework order (ax..az, wx..wz, t).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def _read_image_csv(path: str, data_dir: str) -> Tuple[List[str], np.ndarray]:
    images, stamps = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            item = line.split(",")[0]
            images.append(os.path.join(data_dir, item + ".png"))
            stamps.append(float(item) * 1e-9)
    return images, np.asarray(stamps)


def _read_imu_csv(path: str) -> np.ndarray:
    """ASL imu0/data.csv: t[ns], wx, wy, wz, ax, ay, az -> (N, 7) rows
    (ax, ay, az, wx, wy, wz, t[s])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split(",")]
            rows.append([v[4], v[5], v[6], v[1], v[2], v[3], v[0] * 1e-9])
    return np.asarray(rows)


def load_euroc(folder: str):
    """(image_paths, image_stamps, imu_rows) for an EuRoC/TUM-VI sequence."""
    cam_csv = os.path.join(folder, "mav0", "cam0", "data.csv")
    cam_dir = os.path.join(folder, "mav0", "cam0", "data")
    imu_csv = os.path.join(folder, "mav0", "imu0", "data.csv")
    images, stamps = _read_image_csv(cam_csv, cam_dir)
    imu = _read_imu_csv(imu_csv)
    return images, stamps, imu


load_tumvi = load_euroc  # identical ASL layout (try_tumvi.cpp == try_euroc.cpp)


def load_uma(folder: str):
    """UMA-VI layout (try_uma.cpp:38-59): cam0/data.csv + imu0/data.csv at
    the sequence root."""
    cam_csv = os.path.join(folder, "cam0", "data.csv")
    cam_dir = os.path.join(folder, "cam0", "data")
    imu_csv = os.path.join(folder, "imu0", "data.csv")
    if not os.path.exists(cam_csv):  # some distributions keep mav0/
        return load_euroc(folder)
    images, stamps = _read_image_csv(cam_csv, cam_dir)
    imu = _read_imu_csv(imu_csv)
    return images, stamps, imu
