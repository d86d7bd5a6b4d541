"""Native (C++) host runtime pieces, loaded via ctypes.

Port of ppg_slam_tpu/native/__init__.py. `graph_builder.cpp` (copied from the
reference) is compiled with g++ on first use into the port's build directory,
`ppg_slam_tpu_torch/_build/libppg_graph.so`. The numpy implementations in
frontend/graph_build.py remain the behavioral spec; callers that need the
library (chip_smoke.py) check that `get_lib()` is not None.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libppg_graph.so")
_SRC = os.path.join(_DIR, "graph_builder.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def build() -> str:
    """Compile the library (atomically replacing any old one); returns the
    compiler output. Raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {_SRC}:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return proc.stderr


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_SO)
    lib.ppg_suppress_candidates.restype = ctypes.c_int
    lib.ppg_extract_colines.restype = ctypes.c_int
    lib.ppg_build_graph.restype = ctypes.c_int
    lib.ppg_remap.restype = None
    lib.ppg_pair_geometry.restype = None
    lib.ppg_finalize_graph.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native graph-builder library, building it on first use; None
    when it cannot be built or loaded here."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO) or (
                    os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                build()
            _lib = _load()
        except (OSError, AttributeError, RuntimeError,
                subprocess.SubprocessError):
            _lib = None
        return _lib


def pair_geometry_native(kp_un):
    """The (K, K) pair distance and angle matrices of (K, 2) undistorted
    keypoints through the native library (std::atan2 in f32, bit-identical
    to the reference's); None when the library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    kp = np.ascontiguousarray(kp_un, np.float32)
    k = len(kp)
    dist = np.zeros((k, k), np.float32)
    ang = np.zeros((k, k), np.float32)
    lib.ppg_pair_geometry(
        kp.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(k),
        dist.ctypes.data_as(ctypes.c_void_p),
        ang.ctypes.data_as(ctypes.c_void_p))
    return dist, ang
