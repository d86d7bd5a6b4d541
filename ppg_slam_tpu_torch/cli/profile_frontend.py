"""Where the front-end's time goes on a CUDA GPU.

    python -m ppg_slam_tpu_torch.cli.profile_frontend [--config configs/euroc.yaml]
        [--frames 8] [--compute-dtype f32|bf16] [--desc-transfer f32|device|...]
        [--out profile.json]

Extracts seeded synthetic frames (`synthetic_frames`, which chip_smoke.py
uses too) with PPGExtractor at the settings file's size and prints, with the
card's name and power limit:
  * per-stage wall times of one frame, each stage synchronised (upload,
    nets, NMS + undistort, refine + remap, probe, validate, descriptors,
    device->host + host graph finish), medians over the frames;
  * the device operations (kernels; copies and memsets) that the probe and
    validate stages issue for one frame, counted by torch.profiler;
  * a torch.profiler window over the same frames: the device's busy share
    (kernel + copy time over wall time) and the kernels by device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..frontend.extractor import MIN_KP_FOR_DESC, PPGExtractor, _Handle
from ..ops.descriptors import sample_descriptors
from ..ops.nms import nms_keypoints
from ..ops.pairs import candidate_geometry, probe_and_select, validate_candidates
from ..pipeline.system import camera_from_settings, load_settings

STAGES = ("upload", "nets", "nms_undistort", "refine_remap", "probe",
          "validate", "descriptors", "host_finish")


def synthetic_frames(h, w, n, seed=0):
    """n (h, w) uint8 frames: grid + 16 diagonal lines + noise (the pattern
    of tests/test_extractor.py's image, scaled to the frame), one seeded
    RNG per frame."""
    frames = []
    for k in range(n):
        rng = np.random.RandomState(seed + k)
        img = np.full((h, w), 128, np.uint8)
        off = k % 7
        img[40 + off::40, :] = 255
        img[:, 50 + off::50] = 255
        for _ in range(16):
            x0, y0 = rng.randint(0, w - 160), rng.randint(0, h - 80)
            for t in range(160):
                img[y0 + t // 2, x0 + t] = 0
        frames.append(np.clip(img.astype(np.int32)
                              + rng.randint(-15, 15, (h, w)), 0, 255)
                      .astype(np.uint8))
    return frames


@torch.inference_mode()
def stage_times(ex: PPGExtractor, img: np.ndarray) -> dict:
    """One frame through the extractor's stages, synchronising after each."""
    cam = ex.camera
    times = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = (now - t) * 1e3
        t = now

    stack = ex._images([img])
    mark("upload")
    junc, heat, dm = ex._nets(stack)
    mark("nets")
    kp_xy, _, kp_valid = nms_keypoints(junc[0], max_kp=ex.max_kp)
    kp_pos = kp_xy.to(torch.float32)
    kp_un = cam.undistort_points(kp_pos)
    kp_ok = kp_valid & cam.is_in_image(kp_un, border=1.0)
    mark("nms_undistort")
    heat_r = ex._refined_heat(heat[0])
    mark("refine_remap")
    sel = probe_and_select(heat_r, kp_un, kp_ok)
    mark("probe")
    dist, _, _ = candidate_geometry(kp_un, sel["ci"], sel["cj"])
    validate_candidates(heat_r, kp_un, sel["ci"], sel["cj"], dist,
                        sel["cand_valid"])
    mark("validate")
    descs = sample_descriptors(dm[0], kp_pos, kp_valid, cam.width, cam.height)
    if int(kp_valid.sum()) < MIN_KP_FOR_DESC:
        descs.zero_()
    mark("descriptors")
    out, dd = ex._decode(junc[0], heat[0], dm[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    _Handle(ex, [out], [dd], single=True).result()
    mark("host_finish")
    return times


def _device_ops(prof) -> dict:
    """Kernels and copies/memsets among a profile's device-side events, and
    each kernel's launches and device µs by name."""
    kernels = copies = 0
    by_name = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
        else:
            kernels += ev.count
        by_name.append({"name": ev.key[:90], "count": ev.count,
                        "device_us": getattr(ev, "self_device_time_total",
                                             0.0)})
    by_name.sort(key=lambda r: -r["device_us"])
    return {"kernels": kernels, "copies": copies,
            "device_us": sum(r["device_us"] for r in by_name),
            "by_name": by_name}


@torch.inference_mode()
def stage_device_ops(ex: PPGExtractor, img: np.ndarray) -> dict:
    """Device operations the probe and validate stages issue for one frame
    (each stage profiled on its own, after the stages before it ran)."""
    from torch.profiler import ProfilerActivity, profile

    cam = ex.camera
    junc, heat, _ = ex._nets(ex._images([img]))
    kp_xy, _, kp_valid = nms_keypoints(junc[0], max_kp=ex.max_kp)
    kp_un = cam.undistort_points(kp_xy.to(torch.float32))
    kp_ok = kp_valid & cam.is_in_image(kp_un, border=1.0)
    heat_r = ex._refined_heat(heat[0])
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        sel = probe_and_select(heat_r, kp_un, kp_ok)
        torch.cuda.synchronize()
    out = {"probe": _device_ops(prof)}
    with profile(activities=acts) as prof:
        dist, _, _ = candidate_geometry(kp_un, sel["ci"], sel["cj"])
        validate_candidates(heat_r, kp_un, sel["ci"], sel["cj"], dist,
                            sel["cand_valid"])
        torch.cuda.synchronize()
    out["validate"] = _device_ops(prof)
    return out


def profile_window(ex: PPGExtractor, frames) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in frames:
            ex.extract(img)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the host-side operators
    # carry their kernels' time again
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "top": [{"device_ms": r[0], "count": r[1], "name": r[2][:90]}
                    for r in rows[:15]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/euroc.yaml")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--compute-dtype", default="f32")
    ap.add_argument("--desc-transfer", default="f32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frontend: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    cam = camera_from_settings(load_settings(args.config))
    ex = PPGExtractor(cam, compute_dtype=args.compute_dtype,
                      desc_transfer=args.desc_transfer)
    frames = synthetic_frames(cam.height, cam.width, args.frames)
    ex.extract(frames[-1])  # warm-up: kernel build, cuDNN algorithm choice
    per = [stage_times(ex, img) for img in frames]
    stages = {s: statistics.median(p[s] for p in per) for s in STAGES}
    e2e = []
    for img in frames:
        t0 = time.perf_counter()
        ex.extract(img)
        e2e.append((time.perf_counter() - t0) * 1e3)
    prof = profile_window(ex, frames)
    ops = stage_device_ops(ex, frames[0])
    result = {"card": card[0] if card else None, "config": args.config,
              "size": [cam.width, cam.height], "frames": args.frames,
              "compute_dtype": args.compute_dtype,
              "desc_transfer": args.desc_transfer,
              "stage_ms_median": stages,
              "stage_device_ops": ops,
              "extract_ms_median": statistics.median(e2e),
              "profile": prof}
    print(json.dumps(result, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
