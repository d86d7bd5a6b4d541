"""Hand-written CUDA kernels: build with nvcc at first use, load with ctypes.

Each `<name>.cu` in this directory is compiled for Hopper
(`-gencode=arch=compute_90a,code=sm_90a`) into a shared library with a plain
C interface, `ppg_slam_tpu_torch/_build/lib<name>.so`, and loaded with ctypes.
A library is rebuilt when its source, or a header of this directory that the
source includes (`packed_mask.cuh`, `block_scan.cuh`), is newer. A failed
build raises: there is no fallback to the plain PyTorch versions on CUDA
tensors. `-fmad=false` keeps every float multiply and add separately
rounded, as the plain versions' separate PyTorch ops are.

Launchers take device pointers, sizes and a `cudaStream_t` (PyTorch's current
stream) and return the `cudaGetLastError()` code of the launch. Each library
also exports `ppg_runtime_device()` (packed_mask.cuh), the device its own
static CUDA runtime launches on, which `check_device` holds against the
tensors' device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# launcher symbol and argtypes of each kernel library
SIGNATURES = {
    "nearest_binary_packed": ("ppg_nearest_binary_packed",
                              [_P, _P, _P, _P, _I, _I, _I, _P]),
    "pair_probe": ("ppg_pair_probe", [_P] * 9 + [_I] * 3 + [_P]),
    "line_validate": ("ppg_line_validate", [_P] * 15 + [_I] * 4 + [_F, _P]),
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of ppg_slam_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME or PATH)")


def source_path(name: str) -> str:
    return os.path.join(_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def sources(name: str) -> List[str]:
    """Kernel `name`'s source and the headers of this directory that it
    includes, directly or through another header."""
    todo, seen = [source_path(name)], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc)
            if os.path.exists(dep):
                todo.append(dep)
    return seen


def _stale(name: str) -> bool:
    so = library_path(name)
    if not os.path.exists(so):
        return True
    built = os.path.getmtime(so)
    return any(os.path.getmtime(src) > built for src in sources(name))


def _start_build(name: str, extra_flags: Optional[List[str]] = None):
    """Start nvcc for one kernel; returns (process, temp path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library_path(name)}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + NVCC_FLAGS + list(extra_flags or [])
           + ["-o", tmp, source_path(name)])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name: str, proc, tmp: str, timeout: float = 600.0) -> str:
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc {proc.returncode}):\n{log}")
    os.replace(tmp, library_path(name))  # atomic: no half-written library
    return log


def build_all(force: bool = False, extra_flags: Optional[List[str]] = None
              ) -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all started together.
    Returns each kernel's compiler output (e.g. `-Xptxas -v` reports)."""
    with _lock:
        names = [n for n in SIGNATURES if force or _stale(n)]
        started = {n: _start_build(n, extra_flags) for n in names}
        return {n: _finish_build(n, *started[n]) for n in names}


def get_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing/stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if _stale(name):
                _finish_build(name, *_start_build(name))
            lib = ctypes.CDLL(library_path(name))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def launcher(name: str):
    """The C launcher function of kernel `name`."""
    return getattr(get_library(name), SIGNATURES[name][0])


def check_device(name: str, device) -> None:
    """Raise unless kernel `name`'s library would launch on `device`, the
    device of the tensors it is given: its statically linked CUDA runtime
    must see the device PyTorch made current (torch.cuda.device)."""
    got = get_library(name).ppg_runtime_device()
    if got != device.index:
        raise RuntimeError(
            f"{name}: the kernel library launches on cuda:{got}, its tensors "
            f"are on {device}; launch it inside torch.cuda.device({device})")


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {code}")
