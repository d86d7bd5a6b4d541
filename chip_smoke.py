#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ppg_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (nearest_binary_packed, pair_probe,
line_validate; one nvcc each, started together) and native library from the
sources in this checkout, holds each kernel against its plain PyTorch
version and times it, drives the port's front-end (PPGExtractor) at EuRoC
width (752x480, radtan) with the real weights in f32 and in the serving
configuration (bf16 nets, device-resident descriptors, gated matching),
requires the main path to launch the fused kernels pair_probe and
line_validate once a frame, checks batching and a TUM-VI fisheye frame,
then drives the estimator layer at EuRoC width (phase 8: preintegration,
pose and pose-inertial optimization, local, local-inertial and global BA,
inertial initialization, two-view reconstruction, full_inertial_ba with and
without b_init, the whole-map transform gain and the conformal scale search
on a 20-keyframe synthetic window, each held against the same call on CPU
tensors), then the port's System end to end
(phase 9: a rendered 752x480 corridor with its IMU, tracked through
monocular and IMU initialization in the serving configuration with the real
weights and the EuRoC vocabulary and active loop closing, held to the
ground truth and to no false loop; the first frames again in f32 against a
CPU run), then loop closing (phase 10: the 168-frame synthetic loop closed
end to end on CUDA and held to tests/test_loop_closing.py's checks; Sim3
exp/log, the Sim3 RANSAC, optimize_sim3 and both essential graphs, at the
loop map's size and at 300 keyframes, on CUDA against CPU tensors, timed
and profiled; the background GBA against the synchronous one; a map
checkpoint round trip; the same loop, 8 frames past its closure, through
configs/tumvi.yaml's Kannala-Brandt camera block as shipped, T_b_c1
included, closed on the card with its loop GBAs' routes and device busy
shares), then the user
entry points (phase 11: 80 frames of
phase 9's corridor written as a EuRoC ASL folder through the port's PNG
codec, run through cli.mono_inertial in the serving configuration with the
frame prefetcher, the threaded GBA, renders, --eval-gt and --save-map, the
fused kernels required once a frame; the prefetcher's features bit-equal
to extract()'s; the CLI resumed with --load-map on a stretch from one of
the run's keyframes, starting LOST and relocalizing near the truth;
cli.train_vocabulary on 8 of the frames), then large windows and the
device mesh (phase 12: global and full inertial BA on 64-300-keyframe
windows through both routes of solve_ba, the dense fold and the implicit
Schur matvecs, held to each other and at 64-66 keyframes to the CPU, timed,
profiled and their peak memory read, the entry points' route read from the
profiler's counters; solve_ba_sharded, the sharded dry run, GBA and FIBA
with mesh= and extract_batch(mesh=) over two shards of the card, each held
to the single-device call), then the Kannala-Brandt configurations (phase
13: configs/tumvi.yaml at 512x512 through the tumvi CLI, its IMU
initialization, --eval-gt and a --load-map run that relocalizes through the
fisheye PnP; configs/uma.yaml at 1024x768 and 12 fps through the uma CLI
with --no-loop-closing; configs/tumvi1024.yaml's 1024x1024 frames through
the System, with the fused kernels held bit-equal to their plain versions
and timed at the 1024x1024 and 1024x768 shapes; every camera block as
shipped, on the corridor rendered through a wider pinhole canvas and
resampled into the fisheye), and prints one line per phase. Phase 11's CLI
runs configs/euroc.yaml's radtan camera as shipped, on the corridor
resampled into the radtan images that camera takes. Every phase's failure
is fatal.

Output, in order: the card's name and power limit (nvidia-smi), the phase
lines, one JSON line with the kernel table, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, where
CUDA is not available or the port's package is missing. Imports neither jax
nor ppg_slam_tpu.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 8
SEED = 0
# the nearest-sampler sizes of one 752x480 frame in the reference
# (ops/pairs.py: midpoint probe, 20%/80% probes, short and long rate grids,
# each padded to a multiple of 32768) ...
REF_SIZES = (262144, 32768, 131072, 65536)
# ... and in the port, which launches at the exact sizes: K*K (K = 500),
# 2*PHASE2_CAP, CAND_CAP*SHORT_S, LONG_CAP*MAX_SEG
MAIN_SIZES = (250000, 32768, 131072, 65024)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
FUSED = ("pair_probe", "line_validate")


# phase 8's limits on CUDA against the same call on CPU tensors
EST_CENTRE_M = 1e-3       # largest keyframe-centre difference
EST_POINT_M = 1e-3        # median map-point difference
EST_CHI2_REL = 1e-2       # final chi2
EST_MASK_SHARE = 1e-2     # inlier/outlier decisions that may differ
EST_STATE_ABS = 1e-3      # pose-opt / inertial-init outputs (rad, m, m/s)
EST_PREINT_ABS = 1e-4     # preintegrated deltas and bias Jacobians
EST_PREINT_COV_REL = 1e-3  # preintegration covariance, of its largest entry
EST_TV_TOL = 1e-4         # two-view R, t (abs); points: see phase 8
EST_GAIN_REL = 1e-4       # whole-map chi2 before and after a transform
EST_SCALE_REL = 1e-3      # conformal scales
# full_inertial_ba ends in a flat valley of the point depths (4-12 m deep
# over 0.6-1.2 s of baseline), where CUDA's unordered index_add_ sums move
# its path from run to run: over three runs (two with b_init) CUDA and the
# CPU parted by up to 0.61 mm in centres, 1.4 mm in the median point and
# 3.0e-4 in velocities and biases with b_init off, 2.1 mm, 4.2 mm and
# 4.4e-4 with it on (125 iterations), at chi2 1.2e-4 and 2.2e-4 apart. The
# states are held at about 5x those readings, the chi2 at 9x.
EST_FIBA_M = 2e-2
EST_FIBA_VB = 5e-3
EST_FIBA_CHI2_REL = 2e-3
EST_WARM_CALLS = 3
TV_KF = 2                 # two-view between keyframes 0 and TV_KF
FIBA_SCALE = 1.5          # the b_init full_inertial_ba's mis-scaled start
INIT_SCALE = 2.5          # the scale inertial initialization recovers

# phase 12: large windows (the implicit-Schur route) and the device mesh
LARGE_KFS = (64, 66, 128, 300)   # prefixes of one 300-KF window
LARGE_POINTS = 120000     # its scene: ~280 observations a keyframe
LARGE_CPU_KFS = (64, 66)  # the sizes also solved on the CPU
# The implicit route against the dense one (and a sharded solve against one
# device). The first LM step, at every size: KF positions and points, each
# difference over the step's own size (2.9e-5-9.7e-3 on the card). The
# whole solve at LARGE_CPU_KFS: chi2 relative, and states within phase 8's
# FIBA limits. From 128 KFs on the whole solves are reported, not held:
# their PCG(64) steps stop short of the exact reduced step (printed at
# MESH_KFS), and two LM paths part on round-off (on the card: chi2 0.03-0.9
# % apart after 20-25 iterations, still falling, and once a dense FIBA at
# 300 KFs stalled at 18x the implicit route's chi2).
ROUTE_STEP_REL = 2e-2
ROUTE_CHI2_REL = 1e-3
MESH_KFS = 128            # the window solved over the mesh
# make_vi_problem's 5-KF problem: ill-conditioned, its f32 solves part by
# millimetres with the summation order (tests/test_torch_parallel.py)
VI_5KF = dict(n_kf=5, n_mp=48, n_obs=160, n_col=12, seed=3)
VI_CHI2_REL, VI_T_M, VI_POINT_M = 5e-4, 1e-3, 1e-2

# phase 9: the System on the rendered corridor
SYS_CORRIDOR_FRAMES = 100  # the corridor rendered (phase 11 reads 80)
SYS_FRAMES = 70           # tracked: the IMU init (~frame 43), VIBA1 (~59)
SYS_F32_FRAMES = 12       # the f32 rerun, against a CPU run
SYS_IMU_INI_TIME = 2.0
# KF-ATE limit: a few times the 1.0-1.95 cm the card has read, far inside
# bench.py's pinned live-corridor 3 x 0.86 m
SYS_ATE_M = 0.1
SYS_MP_REL = 0.02         # f32 rerun: map points, CUDA against the CPU
SYS_BUSY_FRAMES = 10
# the estimator's tensor functions the System must run, each counted under
# its device (profiler.count_device)
SYS_DEVICE_CALLS = ("integrate", "two_view_reconstruct", "pose_optimization",
                    "pose_inertial_optimization", "inertial_optimization",
                    "solve_ba", "conformal_scan")

# phase 11: the user entry points (the CLI) on the card
# on the radtan frames the monocular init comes near frame 24 (frame 8 on
# phase 9's pinhole renders: the distorted frames' grey corners), and the
# first IMU init needs keyframes over 2 s (Tracking.min_init_window_s)
CLI_FRAMES = 80           # the IMU init (~frame 66) + steady frames
CLI_RENDER_EVERY = 10
CLI_PREFETCH_FRAMES = 8   # (c) prefetch parity: 2 batches of 4
CLI_RESUME_FRAMES = 12    # (d) the resumed stretch
CLI_RESUME_KF_T = 1.0     # (d) it starts at the first keyframe from 1 s on
CLI_RELOC_WITHIN = 3      # (d) tracking must be OK by its 3rd frame
CLI_RELOC_M = 0.1         # (d) relocalized centre against the truth
CLI_VOC_EVERY = 10        # (e) 8 of the 80 frames
# (e) the tree: with 4 x 4 words every word is in all 8 frames, so every
# IDF weight is ln(8/8) = 0 and a frame transforms to no word at all
CLI_VOC_K, CLI_VOC_L = 10, 2

# phase 13: the Kannala-Brandt configurations end to end (configs/tumvi.yaml,
# uma.yaml, tumvi1024.yaml with their camera blocks as shipped), on the
# corridor rendered through a wider pinhole canvas and resampled into the
# fisheye (testing.fisheye_canvas / distort_frames)
# The first IMU init needs keyframes over 2 s (Tracking.min_init_window_s):
# (a) and (b) track past it; IMU.IniTime stays phase 9's SYS_IMU_INI_TIME
FISH_REACH = 3.0          # m of wall beyond the corridor's, for the wide view
FISH_SEED = 11
# The CLI runs' frame counts are multiples of the prefetcher's batch of 4:
# it pads a last short batch, and the padding launches the kernels too
TUMVI_FRAMES = 48         # (a) 2.4 s at 20 fps: the IMU init + ~7 frames
UMA_FRAMES = 52           # (b) 4.3 s at uma.yaml's 12 fps
UMA_IMU_HZ = 250.0        # uma.yaml's IMU.Frequency
T1024_FRAMES = 52         # (c) 2.6 s: the IMU init (~frame 43) + ~8 frames
T1024_TRACKED = 10        # (c) frames that must track after the init
T1024_BUSY_FRAMES = 5     # (c) device busy share over its last frames

# phase 10: loop closing on the card
LOOP_FRAMES = 168         # testing.make_loop_sequence, as tests/ run it
LOOP_PINNED_ATE_M = 0.012  # tests/test_loop_closing.py's post-loop pin
LOOP_DEVICE_CALLS = ("sim3_score", "optimize_sim3",
                     "optimize_essential_graph_4dof", "solve_ba",
                     "pose_inertial_optimization")
# CUDA against the CPU; readings of two runs on the H100 (700 W) in
# brackets, the limits about 5x the largest
LC_SIM3_ABS = 1e-6        # Sim3 exp/log: CUDA's error beyond 2x the CPU's
LC_OPT_ABS = 2e-5         # optimize_sim3's R, t, s [1.8e-7, 3.7e-6]
LC_RANSAC_MATCHES = 200
LC_GRAPH_KFS = 300        # a EuRoC MH-sized essential graph
LC_GRAPH_R = 2e-5         # essential graphs: rotation entries [3.8e-6]
LC_GRAPH_M = 1e-3         # essential graphs: keyframe centres [2.3e-4 m]
# (e) the fisheye loop: the same sequence through configs/tumvi.yaml's
# camera block as shipped (KB8 512x512, T_b_c1) with the TUM vocabulary,
# tracked 8 frames past the closure (testing.make_loop_sequence overrun):
# when the first frame after the initialization loses every match, the
# tracking resets and its map starts a few frames late, with 2 keyframes
# fewer at the end (64 without the overrun, below ba.IMPLICIT_MIN_KF); the
# post-loop KF-ATE pin: the CPU's reading (the port with its defaults
# there) 0.0196 m
LOOP_FISH_CONFIG = "tumvi.yaml"
LOOP_FISH_OVERRUN = 8
LOOP_FISH_PINNED_ATE_M = 0.020


# the corridors phases 9 and 13 track, each rendered once (numpy only) by a
# child process that phase 1 starts, while the card runs phases 2-8:
# name -> (config, frames, fps, IMU Hz); phase 9's pinhole corridor, then
# phase 13's Kannala-Brandt ones through testing.fisheye_canvas
FIXTURES = {"phase9": ("euroc.yaml", SYS_CORRIDOR_FRAMES, 20.0, 200.0),
            "tumvi.yaml": ("tumvi.yaml", TUMVI_FRAMES, 20.0, 200.0),
            "uma.yaml": ("uma.yaml", UMA_FRAMES, 12.0, UMA_IMU_HZ),
            "tumvi1024.yaml": ("tumvi1024.yaml", T1024_FRAMES, 20.0, 200.0)}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def say(msg):
    print(msg, flush=True)


def render_fixtures(out_dir):
    """Render every corridor of FIXTURES into out_dir/<name>.npz, in order
    (the child process phase 1 starts). Phase 9's is render_corridor with
    euroc.yaml's Tbc; a Kannala-Brandt one is rendered through
    testing.fisheye_canvas(cam) and resampled by testing.distort_frames."""
    import numpy as np

    from ppg_slam_tpu_torch import testing
    from ppg_slam_tpu_torch.pipeline.system import (camera_from_settings,
                                                    load_settings)

    for name, (config, n_frames, fps, imu_hz) in FIXTURES.items():
        settings = load_settings(os.path.join(ROOT, "configs", config))
        t0 = time.time()
        if name == "phase9":
            c = testing.render_corridor(n_frames=n_frames, seed=7,
                                        Tbc=settings["Tbc"])
        else:
            cam = camera_from_settings(settings)
            canvas = testing.fisheye_canvas(cam)
            c = testing.render_corridor(
                n_frames=n_frames, seed=FISH_SEED, cam=canvas,
                Tbc=settings["Tbc"], fps=fps, imu_hz=imu_hz,
                reach=FISH_REACH)
            c.frames = testing.distort_frames(c.frames, cam, canvas=canvas)
        tmp = os.path.join(out_dir, name + ".part.npz")
        np.savez(tmp, frames=np.stack(c.frames), times=np.asarray(c.times),
                 cam_R=np.stack([R for R, _ in c.cam_poses]),
                 cam_t=np.stack([t for _, t in c.cam_poses]),
                 body_R=np.stack([R for R, _ in c.body_poses]),
                 body_t=np.stack([t for _, t in c.body_poses]),
                 body_vels=np.stack(c.body_vels), imu=c.imu,
                 gravity=c.gravity, fps=c.fps,
                 seconds=time.time() - t0)
        os.replace(tmp, os.path.join(out_dir, name + ".npz"))


def time_cuda(fn, reps=50, rounds=5):
    """Median ms per call over `rounds` CUDA-event-timed loops of `reps`."""
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def time_graph(fn, reps=100, rounds=5):
    """Median device ms per call: `reps` calls captured in one CUDA graph,
    replays timed with CUDA events (no host launch overhead)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def sampler_bound_ms(n, h, w8):
    """Least time for n samples: read 8 B of coordinates each and the table
    once, write 1 B each, at the HBM rate."""
    return (n * 9 + h * w8) / HBM_BYTES_PER_S * 1e3


def filtered_png(img, filters=(0, 1, 2, 3, 4)):
    """An 8-bit grey PNG of `img` whose rows cycle through the given
    scanline filters, as the adaptive filtering of the libpng that wrote
    EuRoC's and TUM-VI's frames mixes them (datasets/png.py write_png
    writes filter 0 only)."""
    import struct
    import zlib

    import numpy as np

    from ppg_slam_tpu_torch.datasets.png import SIGNATURE

    h, w = img.shape
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    f = np.asarray(filters)[np.arange(h) % len(filters)]
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = f
    rows[:, 1:] = (x - preds[f, np.arange(h)]) & 255

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def bound_ms(n_bytes, n_ops):
    """(ms, "bytes"|"operations"): the larger of the bytes over the HBM
    rate and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_bound(mask, h, w, kp, ok, sel):
    """pair_probe's bound on these inputs: the table, keypoints and flags
    read once, the candidate outputs written once; ~8 f32 operations for
    each probed pair's midpoint and ~16 for the 20 %/80 % probes of each of
    the first PHASE2_CAP midpoint survivors."""
    import torch

    from ppg_slam_tpu_torch.ops import pairs
    from ppg_slam_tpu_torch.ops.sampling import nearest_binary_packed_ref

    k = kp.shape[0]
    n_out = sel["ci"].numel()
    n_bytes = mask.numel() + k * 9 + n_out * 17 + 9
    ar = torch.arange(k, device=kp.device)
    okm = ok[:, None] & ok[None, :] & (ar[:, None] < ar[None, :])
    mid = [pairs._round_clip((c[:, None] * 0.5 + c[None, :] * 0.5)
                             .reshape(-1), lim)
           for c, lim in ((kp[:, 1], h - 1), (kp[:, 0], w - 1))]
    survivors = int((nearest_binary_packed_ref(mask, *mid).reshape(k, k)
                     & okm).sum())
    return bound_ms(n_bytes, 8 * int(okm.sum())
                    + 16 * min(survivors, pairs.PHASE2_CAP))


def validate_bound(mask, heat, kp, ref):
    """line_validate's bound on these inputs: the table, keypoints and
    per-candidate inputs read once, 16 B of heat taps per bilinear sample
    this run needs, the outputs written once; ~11 f32 operations per rate
    sample and ~26 per score sample."""
    seg = ref["seg"].long()
    n = seg.numel()
    rate_samples = int((seg - 1).clamp(min=0).sum())
    need = (seg >= 2) & (ref["rate"] >= 0.8)
    score_samples = int(((seg - 1) * need).sum())
    mids = int((seg == 1).sum())
    taps = min(16 * (score_samples + mids), heat.numel() * 4)
    n_bytes = mask.numel() + kp.shape[0] * 8 + n * 21 + taps + n * 5 + 1
    return bound_ms(n_bytes, 11 * rate_samples + 26 * score_samples
                    + 20 * mids)


def loop_error(Rcw, tcw, s, g):
    """|log(Sji^-1 o S0 S_last^-1)| at the loop edge (last -> 0) of a
    testing.pose_graph_ring `g`, for Scw vertices (Rcw, tcw, s)."""
    import numpy as np
    import torch

    from ppg_slam_tpu_torch.geometry import Sim3

    R, t, sc = (torch.from_numpy(np.asarray(a, np.float32))
                for a in (Rcw, tcw, s))
    est = Sim3(R[0], t[0], sc[0]) @ Sim3(R[-1], t[-1], sc[-1]).inverse()
    meas = Sim3(*(torch.as_tensor(np.asarray(g[k][-1]))
                  for k in ("SR", "St", "Ss")))
    return float(torch.linalg.norm((meas.inverse() @ est).log()))


@contextlib.contextmanager
def deterministic_sums():
    """CUDA's index_add_ in a fixed order inside the block: two solves then
    part by their own arithmetic only, not by the order of atomic adds
    (which moves an LM path's accept/reject decisions from run to run).
    Ops with no deterministic version run as usual, unwarned."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def host_ms(fn, setup=None, calls=EST_WARM_CALLS):
    """Median host-clock ms of `calls` warm calls of fn(setup()), the
    device idle before and after each."""
    import torch

    times = []
    for _ in range(calls):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn):
    """One call under torch.profiler and CUDA sync debugging: (kernels,
    copies and sets, device busy ms, host syncs flagged) of that call."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    kernels = copies = 0
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset", "memcpy", "memset")):
            copies += 1
        else:
            kernels += 1
        busy_us += e.time_range.elapsed_us()
    syncs = sum("synchroniz" in str(w.message) for w in flagged)
    return kernels, copies, busy_us / 1e3, syncs


class BusyWindow:
    """Device busy time over the frames from `first` on, as drive_system's
    on_frame: torch.profiler (CUDA activity) starts before frame `first`;
    stop() ends it and returns (device busy ms, wall ms) of the window."""

    def __init__(self, first):
        self.first = first
        self.prof = None

    def __call__(self, k):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if k == self.first:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        busy_ms = sum(e.time_range.elapsed_us() for e in self.prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      ) / 1e3
        return busy_ms, wall_ms


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.result = {}

    # ------------------------------------------------------------------
    def start_renders(self):
        """Start the child process that renders FIXTURES, on the last core
        with one math-library thread, and keep this process (its thread
        pool sized to match) on the other cores, so that no phase timed
        beside the child shares a core with it; stop_renders (at exit) ends
        it and removes its files."""
        import atexit
        import tempfile

        self.fixture_dir = tempfile.mkdtemp(prefix="ppg_smoke_fixtures_")
        self.renderer_log = open(os.path.join(self.fixture_dir, "log"), "w")
        cores = sorted(os.sched_getaffinity(0))
        core = cores[-1]
        if len(cores) > 1:
            os.sched_setaffinity(0, cores[:-1])
            self.torch.set_num_threads(min(self.torch.get_num_threads(),
                                           len(cores) - 1))
        env = dict(os.environ, **{k: "1" for k in (
            "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
        self.renderer = subprocess.Popen(
            [sys.executable, "-c", f"import os; os.sched_setaffinity(0, "
             f"{{{core}}}); import chip_smoke as c; "
             f"c.render_fixtures({self.fixture_dir!r})"],
            cwd=ROOT, env=env, stdout=self.renderer_log,
            stderr=subprocess.STDOUT)
        self.renderer_core = core
        atexit.register(self.stop_renders)

    def stop_renders(self):
        import shutil

        if self.renderer.poll() is None:
            self.renderer.kill()
        self.renderer.wait()
        self.renderer_log.close()
        shutil.rmtree(self.fixture_dir, ignore_errors=True)

    def fixture(self, name):
        """The corridor FIXTURES[name] as testing.render_corridor returns
        it, once the child process has written it."""
        import types

        import numpy as np

        path = os.path.join(self.fixture_dir, name + ".npz")
        t0 = time.time()
        while not os.path.exists(path):
            if self.renderer.poll() is not None:
                with open(os.path.join(self.fixture_dir, "log")) as f:
                    log = f.read()[-2000:]
                raise PhaseError(f"the fixture renderer exited "
                                 f"({self.renderer.returncode}) before "
                                 f"{name}: {log}")
            time.sleep(0.2)
        with np.load(path) as z:
            c = types.SimpleNamespace(
                frames=list(z["frames"]), times=[float(t) for t in
                                                 z["times"]],
                cam_poses=list(zip(z["cam_R"], z["cam_t"])),
                body_poses=list(zip(z["body_R"], z["body_t"])),
                body_vels=list(z["body_vels"]), imu=z["imu"],
                gravity=z["gravity"], fps=float(z["fps"]))
            say(f"  {name}: {len(c.frames)} frames rendered in "
                f"{float(z['seconds']):.1f} s on core {self.renderer_core} "
                f"beside the phases (waited {time.time() - t0:.1f} s)")
        return c

    def phase1_card(self):
        torch = self.torch
        self.start_renders()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        self.card = smi.stdout.strip().splitlines()[0].strip()
        say(self.card)
        say(f"phase 1 ok: torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}; the fixture renderer on "
            f"core {self.renderer_core}, this process on "
            f"{len(os.sched_getaffinity(0))} cores with "
            f"{torch.get_num_threads()} threads")

    def phase2_build(self):
        from ppg_slam_tpu_torch import kernels, native

        t0 = time.time()
        logs = kernels.build_all(force=True, extra_flags=["-Xptxas", "-v"])
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  {name}: {line.strip()}")
        for name in kernels.SIGNATURES:
            kernels.get_library(name)
        native.build()
        check(native.get_lib() is not None, "native graph library not loaded")
        say(f"phase 2 ok: built {sorted(logs)} + libppg_graph in "
            f"{time.time() - t0:.1f} s")

    # ------------------------------------------------------------------
    def phase3_kernel_parity(self):
        import numpy as np
        import torch

        from ppg_slam_tpu_torch.ops import sampling

        dev = self.dev
        rng = np.random.RandomState(SEED)
        h, w = 480, 752
        w8 = (w + 7) // 8
        table = torch.from_numpy(
            rng.randint(0, 256, (h, w8)).astype(np.uint8)).to(dev)
        rows = []
        self.max_abs_err = 0.0
        for n in sorted(set(REF_SIZES + MAIN_SIZES)):
            ys = torch.from_numpy(rng.randint(0, h, n).astype(np.int32)).to(dev)
            xs = torch.from_numpy(rng.randint(0, w, n).astype(np.int32)).to(dev)
            got = sampling.nearest_binary_packed(table, ys, xs)
            ref = sampling.nearest_binary_packed_ref(table, ys, xs)
            torch.cuda.synchronize()
            n_diff = int((got != ref).sum())
            self.max_abs_err = max(self.max_abs_err, float(
                (got.to(torch.int32) - ref.to(torch.int32)).abs().max()))
            check(n_diff == 0, f"kernel != plain at N={n}: {n_diff} samples")

            def kernel():
                sampling.nearest_binary_packed(table, ys, xs)

            def plain():
                sampling.nearest_binary_packed_ref(table, ys, xs)

            row = dict(n=n, ms=time_graph(kernel), plain_ms=time_graph(plain),
                       eager_ms=time_cuda(kernel),
                       eager_plain_ms=time_cuda(plain),
                       bound_ms=sampler_bound_ms(n, h, w8))
            rows.append(row)
            say(f"  nearest_binary_packed N={n}: device {row['ms'] * 1e3:.2f}"
                f" us/launch (plain {row['plain_ms'] * 1e3:.2f} us), eager "
                f"issue {row['eager_ms'] * 1e3:.2f} us/call (plain "
                f"{row['eager_plain_ms'] * 1e3:.2f} us), bound "
                f"{row['bound_ms'] * 1e3:.3f} us; bit-exact")
        self.sampler_rows = {r["n"]: r for r in rows}

        say(f"phase 3a ok: nearest_binary_packed bit-exact vs plain at N="
            f"{sorted(self.sampler_rows)}")
        self.fused_parity()
        self.fused_timing()

    def fused_cases(self):
        """(name, heat, kp_un, kp_ok) on the card: the 8 EuRoC frames and a
        TUM-VI 512x512 frame as the extractor decodes them, and the
        saturating fixture."""
        import torch

        from ppg_slam_tpu_torch.testing import saturating_case

        if hasattr(self, "_cases"):
            return self._cases
        dev = self.dev
        ex = self.extractor_f32()
        cases = []
        for k, frame in enumerate(self.frames):
            a = ex._device_outputs(frame)
            cases.append((f"euroc{k}", ex.device_heat(frame), a["kp_un"],
                          a["kp_ok"]))
        ex_t = self.extractor_tumvi()
        a = ex_t._device_outputs(self.tumvi_frame)
        cases.append(("tumvi", ex_t.device_heat(self.tumvi_frame),
                      a["kp_un"], a["kp_ok"]))
        cases.append(("saturating",) + saturating_case())
        self._cases = [(name,) + tuple(torch.from_numpy(x).to(dev)
                                       for x in arrs)
                       for name, *arrs in cases]
        return self._cases

    def fused_parity(self, cases=None, tag="phase 3b"):
        """Both fused kernels against the plain version on every case
        (default: fused_cases()): bit-equal except lscore (and the internal
        score), held to LSCORE_MAX_ULP. self.fused_err, the table's
        max_abs_err: the largest |kernel - plain| over every compared
        output of every call."""
        import torch

        from ppg_slam_tpu_torch.ops import pairs
        from ppg_slam_tpu_torch.ops.sampling import pack_binary_mask
        from ppg_slam_tpu_torch.testing import LSCORE_MAX_ULP, ulp_diff

        def abs_err(a, b):
            return float((a.double() - b.double()).abs().max())

        if not hasattr(self, "fused_err"):
            self.fused_err = {"pair_probe": 0.0, "line_validate": 0.0}
        worst_ulp, flips, summary = 0, 0, []
        for name, heat, kp, ok in cases or self.fused_cases():
            ref = pairs.probe_and_select(heat, kp, ok, impl="plain")
            dist, _, _ = pairs.candidate_geometry(kp, ref["ci"], ref["cj"])
            mask_gt = pack_binary_mask(heat > pairs.LINE_HEATMAP_THRESH)
            vref = pairs._validate_from_mask(mask_gt, heat, kp, ref["ci"],
                                             ref["cj"], dist,
                                             ref["cand_valid"])
            sel = pairs.pair_probe(heat, kp, ok)
            got = pairs.line_validate(heat, kp, ref["ci"], ref["cj"], dist,
                                      ref["cand_valid"])
            torch.cuda.synchronize()
            for key, val in ref.items():
                check(torch.equal(sel[key], val),
                      f"{name}: pair_probe {key} != plain")
                self.fused_err["pair_probe"] = max(
                    self.fused_err["pair_probe"], abs_err(sel[key], val))
            for key in ("overflow", "rate"):
                check(torch.equal(got[key], vref[key]),
                      f"{name}: line_validate {key} != plain")
            ulp = max(ulp_diff(got["lscore"], vref["lscore"]),
                      ulp_diff(got["score"], vref["score"]))
            check(ulp <= LSCORE_MAX_ULP,
                  f"{name}: lscore {ulp} ulp from plain")
            n_flip = int((got["good"] != vref["good"]).sum())
            check(n_flip == 0, f"{name}: good differs in {n_flip} "
                               "candidates")
            worst_ulp = max(worst_ulp, ulp)
            flips += n_flip
            self.fused_err["line_validate"] = max(
                [self.fused_err["line_validate"]]
                + [abs_err(got[key], vref[key])
                   for key in ("good", "lscore", "overflow", "rate",
                               "score")])
            summary.append(f"{name} n_cand {int(ref['n_cand'])} good "
                           f"{int(vref['good'].sum())}"
                           f"{' sat' if bool(ref['saturated']) else ''}"
                           f"{' overflow' if bool(vref['overflow']) else ''}")
        say(f"{tag} ok: pair_probe bit-equal and line_validate bit-equal "
            f"(good, overflow, rate) with lscore within {worst_ulp} ulp "
            f"(bound {LSCORE_MAX_ULP}), {flips} near-threshold good flips, "
            f"max_abs_err {self.fused_err}, on {len(summary)} cases: "
            + "; ".join(summary))

    def fused_timing(self, case=None):
        """Each fused kernel at a case's shapes (default: the main path's,
        EuRoC frame 0): one launch in a CUDA graph, host-clocked eager
        calls, the plain version from the same packed mask, and the bound;
        the rows, by kernel (the default's also in self.fused_rows)."""
        from ppg_slam_tpu_torch.ops import pairs
        from ppg_slam_tpu_torch.ops.sampling import pack_binary_mask

        name, heat, kp, ok = case or self.fused_cases()[0]
        h, w = heat.shape
        mask_ge = pack_binary_mask(heat >= pairs.LINE_HEATMAP_THRESH)
        mask_gt = pack_binary_mask(heat > pairs.LINE_HEATMAP_THRESH)
        sel = pairs._probe_from_mask(mask_ge, h, w, kp, ok)
        dist, _, _ = pairs.candidate_geometry(kp, sel["ci"], sel["cj"])
        vargs = (heat, kp, sel["ci"], sel["cj"], dist, sel["cand_valid"])
        vref = pairs._validate_from_mask(mask_gt, *vargs)
        runs = {
            "pair_probe": (
                lambda: pairs._pair_probe_launch(mask_ge, h, w, kp, ok),
                lambda: pairs._probe_from_mask(mask_ge, h, w, kp, ok),
                probe_bound(mask_ge, h, w, kp, ok, sel)),
            "line_validate": (
                lambda: pairs._line_validate_launch(mask_gt, *vargs),
                lambda: pairs._validate_from_mask(mask_gt, *vargs),
                validate_bound(mask_gt, heat, kp, vref)),
        }
        rows = {}
        for kname, (kernel, plain, (b_ms, b_by)) in runs.items():
            row = dict(ms=time_graph(kernel), eager_ms=time_cuda(kernel),
                       plain_ms=time_graph(plain),
                       eager_plain_ms=time_cuda(plain), bound_ms=b_ms,
                       bound_by=b_by, n_cand=int(sel["n_cand"]))
            rows[kname] = row
            say(f"  {kname} ({name} {w}x{h}, K {kp.shape[0]}, n_cand "
                f"{int(sel['n_cand'])}): device {row['ms'] * 1e3:.2f} "
                f"us/launch; plain {row['plain_ms'] * 1e3:.2f} us; eager "
                f"issue {row['eager_ms'] * 1e3:.2f} us/call (plain "
                f"{row['eager_plain_ms'] * 1e3:.2f} us); bound "
                f"{b_ms * 1e3:.3f} us ({b_by}) [{self.card}]")
        if case is None:
            self.fused_rows = rows
            say("phase 3 ok: kernels match their plain versions and are "
                "timed")
        return rows

    # ------------------------------------------------------------------
    def settings_camera(self, name):
        from ppg_slam_tpu_torch.pipeline.system import (camera_from_settings,
                                                        load_settings)

        return camera_from_settings(
            load_settings(os.path.join(ROOT, "configs", name)))

    def extractor_f32(self):
        if not hasattr(self, "_ex32"):
            from ppg_slam_tpu_torch.cli.profile_frontend import \
                synthetic_frames
            from ppg_slam_tpu_torch.frontend import PPGExtractor

            self.cam = self.settings_camera("euroc.yaml")
            self._ex32 = PPGExtractor(self.cam)
            self.frames = synthetic_frames(self.cam.height, self.cam.width,
                                           N_FRAMES, SEED)
        return self._ex32

    def extractor_tumvi(self):
        if not hasattr(self, "_ex_tumvi"):
            from ppg_slam_tpu_torch.cli.profile_frontend import \
                synthetic_frames
            from ppg_slam_tpu_torch.frontend import PPGExtractor

            cam = self.settings_camera("tumvi.yaml")
            check(cam.is_fisheye and (cam.width, cam.height) == (512, 512),
                  "tumvi.yaml is not 512x512 KB8")
            self._ex_tumvi = PPGExtractor(cam)
            self.tumvi_frame = synthetic_frames(cam.height, cam.width, 1,
                                                SEED + 100)[0]
        return self._ex_tumvi

    def reset_launches(self):
        from ppg_slam_tpu_torch.ops import pairs, sampling

        sampling.nearest_binary_packed.launches = 0
        pairs.pair_probe.launches = 0
        pairs.line_validate.launches = 0

    def read_launches(self, n_frames, what):
        """The kernels' launch counts since reset_launches(); each fused
        kernel must have launched once a frame."""
        from ppg_slam_tpu_torch.ops import pairs, sampling

        got = {"nearest_binary_packed": sampling.nearest_binary_packed.launches,
               "pair_probe": pairs.pair_probe.launches,
               "line_validate": pairs.line_validate.launches}
        for name in FUSED:
            check(got[name] == n_frames,
                  f"{what}: {name} launched {got[name]} times in {n_frames} "
                  "frames, not once a frame")
        return got

    def phase4_main_f32(self):
        import numpy as np
        import torch

        from ppg_slam_tpu_torch.frontend import PPGExtractor

        ex = self.extractor_f32()
        check((self.cam.width, self.cam.height) == (752, 480),
              "euroc.yaml is not 752x480")
        ex.extract(self.frames[-1])  # warm-up (cuDNN algorithm choice)
        torch.cuda.synchronize()
        self.reset_launches()
        feats, times = [], []
        for img in self.frames:
            t0 = time.perf_counter()
            feats.append(ex.extract(img))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = self.read_launches(len(self.frames), "f32 main path")
        self.launches = launches
        for k, f in enumerate(feats):
            check(f.n_kp > 50, f"frame {k}: only {f.n_kp} keypoints")
            check(len(f.edges) >= 1, f"frame {k}: no edges")
            norms = np.linalg.norm(f.desc, axis=1)
            check(np.allclose(norms, 1.0, atol=1e-4),
                  f"frame {k}: descriptor norms off by "
                  f"{np.abs(norms - 1).max()}")
        self.feats32 = feats

        # frame 0 against the port's own CPU run
        cpu = PPGExtractor(self.cam, device="cpu").extract(self.frames[0])
        g = feats[0]
        check(cpu.n_kp == g.n_kp, f"n_kp cuda {g.n_kp} vs cpu {cpu.n_kp}")
        kp_err = float(np.abs(cpu.kp_pos_un - g.kp_pos_un).max())
        check(kp_err < 1e-3, f"keypoints differ cuda vs cpu by {kp_err}")
        e_cpu = set(map(tuple, cpu.edges.tolist()))
        e_gpu = set(map(tuple, g.edges.tolist()))
        diff = sorted(e_cpu ^ e_gpu)
        if diff:
            heat_c = PPGExtractor(self.cam, device="cpu").device_heat(
                self.frames[0])
            heat_g = ex.device_heat(self.frames[0])
            say(f"  frame 0 edges cuda vs cpu differ in {len(diff)} of "
                f"{len(e_cpu | e_gpu)}: {diff[:8]}; max |heat cuda - cpu| "
                f"{np.abs(heat_c - heat_g).max():.3g} (threshold flips at "
                f"the 0.2 line mask)")
        check(len(diff) <= max(2, len(e_cpu) // 50),
              f"edges differ cuda vs cpu in {len(diff)} places")
        self.ms_f32 = statistics.median(times)
        say(f"phase 4 ok: EuRoC 752x480 radtan f32, {len(feats)} frames, "
            f"n_kp {[f.n_kp for f in feats]}, edges "
            f"{[len(f.edges) for f in feats]}; kernel launches {launches}; "
            f"cuda==cpu keypoints (max {kp_err:.2g} px), edges "
            f"{'equal' if not diff else f'{len(diff)} differ'}; median "
            f"{self.ms_f32:.2f} ms/frame [{self.card}]")

    def phase5_serving(self):
        import numpy as np
        import torch

        from ppg_slam_tpu_torch.frontend import PPGExtractor
        from ppg_slam_tpu_torch.ops.device_match import (MATCH_K, PAIR_CAP,
                                                         bank_update,
                                                         gated_match_packed,
                                                         unpack_match)

        dev = self.dev
        ex = PPGExtractor(self.cam, desc_transfer="device",
                          compute_dtype="bf16")
        ex.extract(self.frames[-1])
        torch.cuda.synchronize()
        self.reset_launches()
        feats, times = [], []
        for img in self.frames:
            t0 = time.perf_counter()
            feats.append(ex.extract(img))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = self.read_launches(len(self.frames), "serving path")
        for k, f in enumerate(feats):
            check(f.desc is None and f.desc_dev is not None,
                  f"frame {k}: descriptors not device-resident")
            check(f.n_kp > 50 and len(f.edges) >= 1,
                  f"frame {k}: n_kp {f.n_kp}, edges {len(f.edges)}")
        host0 = feats[0].descriptors
        check(np.allclose(np.linalg.norm(host0, axis=1), 1.0, atol=2e-2),
              "fetched descriptors not unit norm")

        # bank of frame 0's descriptors; gates around frame 0's keypoints
        f0 = feats[0]
        n0 = f0.n_kp
        max_kp = ex.max_kp
        bank = torch.zeros(4096, 256, device=dev)
        bank_update(bank, torch.arange(n0, device=dev), f0.desc_dev[:n0])
        bank_idx = torch.arange(n0, dtype=torch.int32, device=dev)
        r = 15.0
        c = torch.from_numpy(f0.kp_pos).to(dev)
        rects = torch.stack([c[:, 0] - r, c[:, 0] + r, c[:, 1] - r,
                             c[:, 1] + r], dim=1)

        def frame_inputs(f):
            pos = torch.full((max_kp, 2), -100.0, device=dev)
            pos[:f.n_kp] = torch.from_numpy(f.kp_pos).to(dev)
            valid = torch.zeros(max_kp, dtype=torch.bool, device=dev)
            valid[:f.n_kp] = torch.from_numpy(~f.kp_out).to(dev)
            return f.desc_dev, pos, valid

        inputs = [frame_inputs(f) for f in feats]
        bufs = []
        t_match = []
        for fd, pos, valid in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf = gated_match_packed(bank, bank_idx, fd, pos, valid, rects)
            bufs.append(buf.cpu().numpy())
            t_match.append((time.perf_counter() - t0) * 1e3)
        rows, kps, ds, n_pairs, n_over = unpack_match(
            bufs[0], min(PAIR_CAP, n0 * MATCH_K))
        self_hits = sum(1 for rr, kk, dd in zip(rows[:n_pairs], kps[:n_pairs],
                                                 ds[:n_pairs])
                        if rr == kk and dd < 5e-2)
        in_self = int((~f0.kp_out).sum())
        check(self_hits == in_self,
              f"frame 0 self-match: {self_hits} of {in_self} gated rows "
              "found their own keypoint")
        fd, pos, valid = inputs[1]
        ms_dev = time_cuda(lambda: gated_match_packed(
            bank, bank_idx, fd, pos, valid, rects), reps=20)
        self.ms_serving = statistics.median(times)
        say(f"phase 5 ok: serving (bf16, device descriptors), {len(feats)} "
            f"frames, n_kp {[f.n_kp for f in feats]}, kernel launches "
            f"{launches}; median {self.ms_serving:.2f} ms/frame; gated match "
            f"{n0} rows x {max_kp} kps: {statistics.median(t_match):.3f} "
            f"ms/match incl. fetch, {ms_dev:.3f} ms device; frame 0 "
            f"self-matched {self_hits}/{in_self} [{self.card}]")

    def phase6_batch(self):
        import numpy as np

        ex = self.extractor_f32()
        batch = ex.extract_batch(self.frames[:4])
        for k, (b, s) in enumerate(zip(batch, self.feats32[:4])):
            check(b.n_kp == s.n_kp, f"frame {k}: batch n_kp {b.n_kp} vs "
                                    f"{s.n_kp}")
            check(np.array_equal(b.kp_pos_un, s.kp_pos_un),
                  f"frame {k}: batch keypoints differ")
            check(np.array_equal(b.edges, s.edges),
                  f"frame {k}: batch edges differ")
            check(np.array_equal(b.colines, s.colines),
                  f"frame {k}: batch colines differ")
            d = float(np.abs(b.desc - s.desc).max())
            check(d < 1e-5, f"frame {k}: batch descriptors differ by {d}")
        say("phase 6 ok: extract_batch of 4 frames equals per-frame extract")

    def phase7_tumvi(self):
        import numpy as np

        f = self.extractor_tumvi().extract(self.tumvi_frame)
        check(f.n_kp > 50 and len(f.edges) >= 1,
              f"TUM-VI frame: n_kp {f.n_kp}, edges {len(f.edges)}")
        check(np.isfinite(f.kp_pos).all() and np.isfinite(f.edge_score).all(),
              "TUM-VI frame: non-finite output")
        say(f"phase 7 ok: TUM-VI 512x512 KB8 frame, n_kp {f.n_kp}, edges "
            f"{len(f.edges)}, colines {len(f.colines)}")

    # ------------------------------------------------------------------
    def phase8_estimator(self):
        """The estimator layer on the full-size EuRoC window, each call on
        CUDA through the default device and against the same call on CPU
        tensors (with the options that CUDA's defaults resolve to), timed
        and profiled. The front-end kernels' counts are reset before and
        read after: this path launches none of them."""
        import numpy as np
        import torch

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator import (FrameVIState, Prior15,
                                                  ba,
                                                  pose_inertial_optimization,
                                                  pose_optimization)
        from ppg_slam_tpu_torch.estimator.inertial_init import (
            InertialInitProblem, inertial_optimization)
        from ppg_slam_tpu_torch.geometry import so3
        from ppg_slam_tpu_torch.imu import Preintegrated

        t_phase = time.time()
        win = testing.EurocWindow(seed=SEED)
        cam = testing.EUROC_CAM
        gpu_ns = testing.port_namespace(None, cam)
        cpu_ns = testing.port_namespace("cpu", cam)
        self.reset_launches()
        t_step = [time.time()]

        def report(name, diffs, profiled):
            """Print a row; `profiled` is device_profile's result on one
            more call, or None where that call is not made."""
            prof = "not profiled"
            if profiled is not None:
                k, c, busy, syncs = profiled
                prof = (f"{k} kernels + {c} copies per call, device busy "
                        f"{busy:.3f} ms, {syncs} host syncs flagged")
            say(f"  {name}: " + ", ".join(
                f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in diffs.items())
                + f"; {prof}; step {time.time() - t_step[0]:.1f} s "
                f"[{self.card}]")
            t_step[0] = time.time()

        # ---- preintegration of the 19 links --------------------------------
        rig = gpu_ns.wm.Rig(cam)
        z6 = np.zeros(6, np.float32)

        def integrate(device, meas):
            p = Preintegrated(z6, rig.nga, rig.nga_walk, device=device)
            p.integrate_measurements(*meas)
            return p

        gpu_pre = [integrate(None, m) for m in win.links]
        check(all(p.device == self.dev for p in gpu_pre),
              "Preintegrated did not default to the card")
        cpu_pre = [integrate("cpu", m) for m in win.links]
        d_delta = d_cov = 0.0
        for g, c in zip(gpu_pre, cpu_pre):
            for key in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
                a, b = getattr(g.state, key), getattr(c.state, key)
                check(np.isfinite(a).all(), f"preintegration {key} not finite")
                d_delta = max(d_delta, float(np.abs(a - b).max()))
            d_cov = max(d_cov, float(np.abs(g.C - c.C).max()
                                     / np.abs(c.C).max()))
        check(d_delta <= EST_PREINT_ABS and d_cov <= EST_PREINT_COV_REL,
              f"preintegration cuda vs cpu: deltas {d_delta}, covariance "
              f"{d_cov} of its largest entry")
        n_samples = len(win.links[0][2])
        ms = host_ms(lambda _: integrate(None, win.links[0]))
        report("preintegration", dict(links=len(win.links),
                                      samples_per_link=n_samples,
                                      max_delta_diff=d_delta,
                                      max_cov_rel_diff=d_cov, ms=ms),
               device_profile(
                   lambda: integrate(None, win.links[0])))

        # ---- the maps ----------------------------------------------------
        pristine = {"cuda": win.build(gpu_ns, gpu_pre),
                    "cpu": win.build(cpu_ns, cpu_pre)}

        def fresh(side):
            """A copy of the window's map, untouched by any BA."""
            return copy.deepcopy(pristine[side])

        n_col = len(pristine["cuda"][0].map_colines)
        truth = win.seq.scene.points

        # ---- pose optimization on tracking frame 0 -----------------------
        f0 = win.frames[0]
        X, uv, valid, close = win.frame_inputs(0)
        n_match = int(valid.sum())

        def tens(arrays, device):
            return [torch.from_numpy(np.asarray(a)).to(device)
                    for a in arrays]

        po_args = {d: tens((f0["Rcw"], f0["tcw"], X, uv, valid), d)
                   for d in (self.dev, "cpu")}

        def run_po(device):
            return pose_optimization(*po_args[device], cam)

        def to_np(out):
            return [x.cpu().numpy() if torch.is_tensor(x) else x for x in out]

        g_po, c_po = to_np(run_po(self.dev)), to_np(run_po("cpu"))
        check(all(np.isfinite(x).all() for x in g_po[:2]),
              "pose_optimization: non-finite pose")
        _, tcw_t = win.seq.frame_tcw(f0["index"])
        d_state = max(float(np.abs(a - b).max())
                      for a, b in zip(g_po[:2], c_po[:2]))
        flips = int((g_po[2] != c_po[2]).sum())
        t_err = float(np.abs(g_po[1] - tcw_t).max())
        caught = not g_po[2][f0["outliers"]].any()
        check(d_state <= EST_STATE_ABS and flips <= EST_MASK_SHARE * n_match,
              f"pose_optimization cuda vs cpu: pose {d_state}, {flips} "
              "inlier flips")
        check(t_err < 1e-2 and caught, f"pose_optimization: translation "
              f"{t_err} m from the truth, outliers caught {caught}")
        ms = host_ms(lambda _: run_po(self.dev))
        report("pose_optimization", dict(
            obs=n_match, padded=len(valid), inliers=int(g_po[3]),
            max_pose_diff=d_state, inlier_flips=flips, t_err_m=t_err, ms=ms),
            device_profile(lambda: run_po(self.dev)))

        # ---- pose-inertial optimization, both variants -------------------
        last = pristine["cpu"][1][-1]
        zero_prior = (np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3),
                      np.zeros(3), np.zeros((15, 15)))

        def kf_state(k):
            return (k.imu_rotation(), k.imu_position(), k.velocity,
                    k.bias[:3], k.bias[3:])

        def guess(f):
            Rwc = f["Rcw"].T
            return (Rwc, -Rwc @ f["tcw"], last.velocity, last.bias[:3],
                    last.bias[3:])

        def pio_inputs(device, k, curr, prev, prior, prior_valid):
            """pose_inertial_optimization's arguments for tracking frame k,
            its preintegration integrated on `device`."""
            p = Preintegrated(z6, rig.nga, rig.nga_walk,
                              device=None if device != "cpu" else "cpu")
            p.integrate_measurements(*win.frames[k]["imu"])
            Xk, uvk, validk, closek = win.frame_inputs(k)
            t = lambda arrays: [torch.from_numpy(
                np.asarray(a, np.float32)).to(device) for a in arrays]
            return (FrameVIState(*t(curr)), FrameVIState(*t(prev)),
                    testing.preint_data(p, device),
                    Prior15(*t(prior), valid=torch.tensor(prior_valid,
                                                          device=device)),
                    *t((Xk, uvk)), torch.from_numpy(validk).to(device),
                    torch.from_numpy(closek).to(device),
                    *t((rig.Rcb, rig.tcb)), cam)

        pio_cpu_out = {}
        for name, k, fix_prev in (("pose_inertial_fix_prev", 0, True),
                                  ("pose_inertial_free_prev", 1, False)):
            if fix_prev:
                args = (k, guess(win.frames[0]), kf_state(last), zero_prior,
                        False)
            else:
                c0, _, _, pr = pio_cpu_out["pose_inertial_fix_prev"]
                cs = [x.numpy() for x in c0]
                prior = [x.numpy() for x in pr[:6]]
                Rwc = win.frames[1]["Rcw"].T
                args = (k, (Rwc, -Rwc @ win.frames[1]["tcw"], cs[2], cs[3],
                            cs[4]), cs, prior, True)
            g_args = pio_inputs(self.dev, *args)
            run = lambda: pose_inertial_optimization(*g_args,
                                                     fix_prev=fix_prev)
            g = run()
            c = pose_inertial_optimization(*pio_inputs("cpu", *args),
                                           fix_prev=fix_prev)
            pio_cpu_out[name] = c
            gs, cs_ = [x.cpu().numpy() for x in g[0]], [x.numpy()
                                                         for x in c[0]]
            check(all(np.isfinite(x).all() for x in gs)
                  and np.isfinite(g[3].H.cpu().numpy()).all(),
                  f"{name}: non-finite state or marginal")
            d = {f"d_{key}": float(np.abs(a - b).max())
                 for key, a, b in zip(("R", "t", "v", "bg", "ba"), gs, cs_)}
            flips = int((g[1].cpu() != c[1]).sum())
            t_true = win.seq.frame_poses[win.frames[k]["index"]][1]
            t_err = float(np.abs(gs[1] - t_true).max())
            # the accelerometer bias of a two-frame window is a soft mode
            # (in the free-prev variant the CPU's own f32 and f64 solves
            # part by 1.7e-3), so it is printed, not held
            check(max(d["d_R"], d["d_t"], d["d_v"], d["d_bg"])
                  <= EST_STATE_ABS and flips <= EST_MASK_SHARE * n_match,
                  f"{name} cuda vs cpu: {d}, {flips} inlier flips")
            check(t_err < 1e-2, f"{name}: {t_err} m from the truth")
            ms = host_ms(lambda _: run())
            report(name, dict(obs=n_match, inliers=int(g[2]), **d,
                              inlier_flips=flips, t_err_m=t_err, ms=ms),
                   device_profile(run))

        # ---- local, local-inertial and global BA ------------------------
        def centres(kfs):
            return np.stack([kf.camera_center() for kf in kfs])

        def point_err(m):
            """Median distance of the map's points from the truth."""
            return float(np.median(np.linalg.norm(np.stack(
                [mp.pos - truth[gid] for gid, mp in m[2].items()]), axis=1)))

        def obs_set(m):
            pos = {kf.mnId: i for i, kf in enumerate(m[1])}
            return {(g, pos[kf.mnId], i) for g, mp in m[2].items()
                    for kf, i in mp.observations.items()}

        entries = (
            ("local_bundle_adjustment", False,
             lambda m, **kw: ba.local_bundle_adjustment(m[1][-1], m[0],
                                                        **kw)),
            ("local_inertial_ba", False,
             lambda m, **kw: ba.local_inertial_ba(m[1][-1], m[0],
                                                  b_large=False, **kw)),
            ("global_bundle_adjustment", True,
             lambda m, **kw: ba.global_bundle_adjustment(m[0], **kw)),
        )
        cpu_kw = dict(device="cpu", pose_cg_iters=64, backtrack=True)
        for name, gauge, call in entries:
            g_map, c_map = fresh("cuda"), fresh("cpu")
            p_before = point_err(c_map)
            g_sum = call(g_map)
            c_sum = call(c_map, **cpu_kw)
            check(g_sum is not None and c_sum is not None,
                  f"{name}: nothing solved")
            cg, cc = centres(g_map[1]), centres(c_map[1])
            pg = np.stack([mp.pos for mp in g_map[2].values()])
            pc = np.stack([c_map[2][gid].pos for gid in g_map[2]])
            check(np.isfinite(cg).all() and np.isfinite(pg).all()
                  and np.isfinite(g_sum["final_chi2"]),
                  f"{name}: non-finite result")
            o, s = cc[0], 1.0
            if gauge:  # only KF 0 fixed: divide out the free scale
                s = float(np.median(np.linalg.norm(cc[1:] - o, axis=1)
                                    / np.linalg.norm(cg[1:] - o, axis=1)))
            d_c = float(np.abs(s * (cg - o) - (cc - o)).max())
            d_p = float(np.median(np.linalg.norm(s * (pg - o) - (pc - o),
                                                 axis=1)))
            d_chi2 = abs(g_sum["final_chi2"] - c_sum["final_chi2"]) \
                / c_sum["final_chi2"]
            n_obs_diff = len(obs_set(g_map) ^ obs_set(c_map))
            p_after = point_err(c_map)
            check(d_c <= EST_CENTRE_M and d_p <= EST_POINT_M
                  and d_chi2 <= EST_CHI2_REL
                  and n_obs_diff <= EST_MASK_SHARE * g_sum["n_obs"],
                  f"{name} cuda vs cpu: centres {d_c} m, median point {d_p}"
                  f" m, chi2 {d_chi2}, {n_obs_diff} observations differ")
            check(g_sum["final_chi2"] < 0.5 * g_sum["initial_chi2"],
                  f"{name}: chi2 {g_sum['initial_chi2']} -> "
                  f"{g_sum['final_chi2']}")
            ms = host_ms(lambda m: call(m), setup=lambda: fresh("cuda"))
            m_prof = fresh("cuda")
            report(name, dict(
                kfs=g_sum["n_kf"], points=g_sum["n_mp"], obs=g_sum["n_obs"],
                colines=n_col, iters=g_sum["iters_run"],
                solver_syncs=g_sum["host_syncs"], erased=g_sum["n_erased"],
                max_centre_diff_m=d_c, median_point_diff_m=d_p,
                chi2_rel_diff=d_chi2, obs_differing=n_obs_diff,
                chi2_before=g_sum["initial_chi2"],
                chi2_after=g_sum["final_chi2"],
                point_err_before_m=p_before, point_err_after_m=p_after,
                ms=ms),
                device_profile(lambda: call(m_prof)))

        # ---- inertial initialization over the 19 links -------------------
        kfs = pristine["cpu"][1]
        links = range(1, len(kfs))

        def st(key):
            return np.stack([getattr(gpu_pre[k - 1].state, key)
                             for k in links])

        C = [np.asarray(p.state.C, np.float64) for p in gpu_pre]
        host_prob = (np.arange(len(kfs) - 1), np.arange(1, len(kfs)),
                     st("dR"), st("dV"), st("dP"), st("JRg"), st("JVg"),
                     st("JVa"), st("JPg"), st("JPa"),
                     np.stack([p.b for p in gpu_pre]),
                     np.stack([testing.sqrtm_psd_inv(c[:9, :9]) for c in C]),
                     np.asarray([p.dT for p in gpu_pre], np.float32),
                     np.ones(len(kfs) - 1, bool))
        # the visual-only trajectory before initialization: the true body
        # poses in a frame rotated off gravity and at 1/INIT_SCALE scale
        Rv = so3.exp(np.float32([0.15, -0.1, 0.3]))
        body = [win.seq.frame_poses[i] for i in win.kf_frames]
        poses = (np.stack([Rv @ R for R, _ in body]).astype(np.float32),
                 np.stack([Rv @ t / INIT_SCALE for _, t in body]).astype(
                     np.float32),
                 np.zeros((len(kfs), 3), np.float32), z6[:3], z6[3:],
                 np.eye(3, dtype=np.float32), np.float32(1.0))

        init_args = {d: (*tens(poses, d),
                         InertialInitProblem(*tens(host_prob, d)))
                     for d in (self.dev, "cpu")}

        def run_init(device):
            return inertial_optimization(*init_args[device], prior_g=1e2,
                                         prior_a=1e10)

        g_in = [x.cpu().numpy() for x in run_init(self.dev)]
        c_in = [x.numpy() for x in run_init("cpu")]
        check(all(np.isfinite(x).all() for x in g_in),
              "inertial_optimization: non-finite result")
        d_in = {f"d_{key}": float(np.abs(a - b).max()) for key, a, b in
                zip(("v", "bg", "ba", "Rwg", "scale"), g_in, c_in)}
        # velocities come out in the visual frame's units: Rv v / scale
        v_err = float(np.abs(g_in[0] @ Rv * g_in[4]
                             - np.stack(win.vels)).max())
        scale_err = abs(float(g_in[4]) / INIT_SCALE - 1.0)
        check(max(d_in.values()) <= EST_STATE_ABS,
              f"inertial_optimization cuda vs cpu: {d_in}")
        check(scale_err < 1e-2 and v_err < 1e-2,
              f"inertial_optimization: scale {float(g_in[4])} of "
              f"{INIT_SCALE}, velocities {v_err} m/s from the truth")
        ms = host_ms(lambda _: run_init(self.dev))
        report("inertial_optimization", dict(
            links=len(kfs) - 1, **d_in, scale=float(g_in[4]),
            max_velocity_err=v_err, ms=ms),
            device_profile(lambda: run_init(self.dev)))

        self.estimator_map_level(win, fresh, tens, report)

        from ppg_slam_tpu_torch.ops import pairs, sampling

        counts = [sampling.nearest_binary_packed.launches,
                  pairs.pair_probe.launches, pairs.line_validate.launches]
        check(counts == [0, 0, 0],
              f"the estimator path launched front-end kernels: {counts}")
        say(f"phase 8 ok: estimator on the EuRoC 752x480 window ({len(kfs)}"
            f" KFs, {win.n_landmarks} landmarks, {n_col} colines, "
            f"{win.n_obs} observations, {n_match}-match tracking frames) "
            f"matches the CPU within its limits in "
            f"{time.time() - t_phase:.1f} s [{self.card}]")

    def estimator_map_level(self, win, fresh, tens, report):
        """Phase 8's map-level calls, each on CUDA through the default
        device against the same call on CPU tensors: two-view
        reconstruction between keyframes 0 and TV_KF, full_inertial_ba
        with b_init off and on (the CPU side with CUDA's backtracking), and
        on the map it solved the full-objective transform gain and the
        conformal scale search after a x INIT_SCALE mis-scaling."""
        import numpy as np
        import torch

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator import ba
        from ppg_slam_tpu_torch.geometry import so3
        from ppg_slam_tpu_torch.geometry.two_view import (
            make_ransac_sets, two_view_reconstruct)

        def centres(m):
            return np.stack([kf.camera_center() for kf in m[1]])

        # ---- two-view reconstruction ------------------------------------
        (f0, ids0), (f1, ids1) = win.views[0], win.views[TV_KF]
        _, i0, i1 = np.intersect1d(ids0, ids1, return_indices=True)
        host = (f0["kp_pos_un"][i0], f1["kp_pos_un"][i1],
                np.ones(len(i0), bool),
                make_ransac_sets(np.arange(len(i0)), seed=SEED),
                np.asarray(testing.EUROC_CAM.K(), np.float32))
        tv_args = {d: tens(host, d) for d in (self.dev, "cpu")}

        def run_tv(device):
            return two_view_reconstruct(*tv_args[device])

        g_tv = [x.cpu().numpy() for x in run_tv(self.dev)]
        c_tv = [x.numpy() for x in run_tv("cpu")]
        check(bool(g_tv[0]) and bool(c_tv[0]),
              f"two_view_reconstruct: ok {bool(g_tv[0])} on CUDA, "
              f"{bool(c_tv[0])} on the CPU")
        tri = g_tv[4] & c_tv[4]
        d_R = float(np.abs(g_tv[1] - c_tv[1]).max())
        d_t = float(np.abs(g_tv[2] - c_tv[2]).max())
        dist = np.linalg.norm(c_tv[3][tri], axis=1)
        d_pts = np.linalg.norm(g_tv[3][tri] - c_tv[3][tri], axis=1)
        d_X = float((d_pts / dist).max())
        # a pose difference of delta moves a point at distance d (in units
        # of the baseline, |t21| = 1; d is 22-142 on this pair) by up to
        # ~delta * d relative: each point is held to EST_TV_TOL * d
        d_Xd = float((d_pts / dist ** 2).max())
        flips = int((g_tv[4] != c_tv[4]).sum())
        (R1, t1), (R2, t2) = win.poses[0], win.poses[TV_KF]
        R21, t21 = R2 @ R1.T, t2 - R2 @ R1.T @ t1
        rot_err = float(np.linalg.norm(so3.log(
            (g_tv[1].T @ R21).astype(np.float32))))
        t_cos = float(g_tv[2] @ t21 / np.linalg.norm(g_tv[2])
                      / np.linalg.norm(t21))
        check(max(d_R, d_t, d_Xd) <= EST_TV_TOL
              and flips <= EST_MASK_SHARE * len(i0),
              f"two_view_reconstruct cuda vs cpu: R {d_R}, t {d_t}, points "
              f"{d_X} relative ({d_Xd} of their distance squared), {flips} "
              "triangulation flips")
        # a 0.21 m baseline over 4-12 m depth: the translation's direction
        # is loosely determined (the CPU reads 0.944), so these are sanity
        check(rot_err < 1e-2 and t_cos > 0.9,
              f"two_view_reconstruct: rotation {rot_err} rad from the truth,"
              f" translation direction cosine {t_cos}")
        report("two_view_reconstruct", dict(
            matches=len(i0), triangulated=int(g_tv[4].sum()),
            max_R_diff=d_R, max_t_diff=d_t, max_point_rel_diff=d_X,
            max_point_diff_per_dist2=d_Xd,
            tri_flips=flips, rot_err_rad=rot_err, t_dir_cos=t_cos,
            ms=host_ms(lambda _: run_tv(self.dev))),
            device_profile(lambda: run_tv(self.dev)))

        # ---- full_inertial_ba, as IMU initialization calls it -----------
        # b_init on: the first IMU initialization's call, on the window
        # mis-scaled x FIBA_SCALE, which only the conformal search undoes
        I3 = np.eye(3, dtype=np.float32)
        for name, scale, kw in (
                ("full_inertial_ba", 1.0, dict(b_init=False)),
                ("full_inertial_ba_b_init", FIBA_SCALE, dict(
                    b_init=True, prior_g=1e2, prior_a=1e10,
                    conformal_shrink_cum=0.6))):
            def start(side, scale=scale):
                mm = fresh(side)
                mm[0].apply_scaled_rotation(I3, scale, scale_vel=True)
                return mm

            g_map, c_map = start("cuda"), start("cpu")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g_sum = ba.full_inertial_ba(g_map[0], iters=100, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            c_sum = ba.full_inertial_ba(c_map[0], iters=100, device="cpu",
                                        backtrack=True, **kw)
            cg, cc = centres(g_map), centres(c_map)
            check(np.isfinite(cg).all()
                  and np.isfinite(g_sum["final_chi2"])
                  and g_sum["final_chi2"] < g_sum["initial_chi2"],
                  f"{name}: chi2 {g_sum['initial_chi2']} -> "
                  f"{g_sum['final_chi2']}")
            d_c = float(np.abs(cg - cc).max())
            d_p = float(np.median([np.linalg.norm(mp.pos - c_map[2][g].pos)
                                   for g, mp in g_map[2].items()]))
            d_vb = max(float(np.abs(np.concatenate([a.velocity, a.bias])
                                    - np.concatenate([b.velocity, b.bias])
                                    ).max())
                       for a, b in zip(g_map[1], c_map[1]))
            d_chi2 = abs(g_sum["final_chi2"] - c_sum["final_chi2"]) \
                / c_sum["final_chi2"]
            sg, sc = g_sum["conformal_scales"], c_sum["conformal_scales"]
            same_scales = len(sg) == len(sc) and all(
                abs(a - b) <= EST_SCALE_REL * b for a, b in zip(sg, sc))
            check(d_c <= EST_FIBA_M and d_p <= EST_FIBA_M
                  and d_vb <= EST_FIBA_VB and d_chi2 <= EST_FIBA_CHI2_REL
                  and same_scales,
                  f"{name} cuda vs cpu: centres {d_c} m, median point {d_p}"
                  f" m, velocities and biases {d_vb}, chi2 {d_chi2}, "
                  f"conformal scales {sg} vs {sc}")
            report(name, dict(
                kfs=g_sum["n_kf"], points=g_sum["n_mp"], obs=g_sum["n_obs"],
                iters=g_sum["iters_run"], solver_syncs=g_sum["host_syncs"],
                conformal_scales=sg, max_centre_diff_m=d_c,
                median_point_diff_m=d_p, max_vel_bias_diff=d_vb,
                chi2_rel_diff=d_chi2, chi2_before=g_sum["initial_chi2"],
                chi2_after=g_sum["final_chi2"], ms=ms),
                # the b_init call's 125 iterations are too slow to profile
                # inside the smoke's time
                None if kw["b_init"] else device_profile(
                    lambda: ba.full_inertial_ba(start("cuda")[0], iters=100,
                                                **kw)))
            if not kw["b_init"]:
                solved = c_map

        # ---- the full-objective transform gain --------------------------
        # on the map full_inertial_ba (b_init off) solved on the CPU: the
        # window as built is far from its optimum
        Rgw = so3.exp(np.float32([0.05, -0.02, 0.1]))
        d_gain, gains = 0.0, {}
        for name, R, s in (("identity", I3, 1.0), ("rotated_0.3", Rgw, 0.3)):
            g, c = (ba.whole_map_transform_gain(solved[0], R, s, device=d)
                    for d in (None, "cpu"))
            check(all(np.isfinite(g)), f"whole_map_transform_gain {name}: "
                                       f"{g}")
            d_gain = max(d_gain, *(abs(a - b) / b for a, b in zip(g, c)))
            gains[name] = g
        c0, c1 = gains["identity"]
        check(d_gain <= EST_GAIN_REL and abs(c1 - c0) <= 1e-5 * c0,
              f"whole_map_transform_gain cuda vs cpu: {d_gain} relative; "
              f"{gains}")
        m = solved[0]
        report("whole_map_transform_gain", dict(
            chi2=c0, chi2_rotated_0p3=gains["rotated_0.3"][1],
            max_rel_diff=d_gain,
            ms=host_ms(lambda _: ba.whole_map_transform_gain(m, Rgw, 0.3))),
            device_profile(lambda: ba.whole_map_transform_gain(m, Rgw, 0.3)))

        # ---- the conformal scale search on a mis-scaled map -------------
        def misscaled():
            mm = copy.deepcopy(solved)
            mm[0].apply_scaled_rotation(I3, INIT_SCALE, scale_vel=True)
            return mm

        g_map, c_map = misscaled(), misscaled()
        s_g = ba.conformal_scale_refine(g_map[0], lo=0.3)
        s_c = ba.conformal_scale_refine(c_map[0], lo=0.3, device="cpu")
        d_c = float(np.abs(centres(g_map) - centres(c_map)).max())
        check(abs(s_g - s_c) <= EST_SCALE_REL * s_c and d_c <= EST_CENTRE_M,
              f"conformal_scale_refine cuda vs cpu: {s_g} vs {s_c}, centres "
              f"{d_c} m")
        check(abs(s_g * INIT_SCALE - 1.0) < 0.1,
              f"conformal_scale_refine: {s_g} undoes x{INIT_SCALE} to "
              f"x{s_g * INIT_SCALE}")
        report("conformal_scale_refine", dict(
            scale=s_g, scale_cpu=s_c, max_centre_diff_m=d_c,
            ms=host_ms(lambda mm: ba.conformal_scale_refine(mm[0], lo=0.3),
                       setup=misscaled)),
            device_profile(lambda: ba.conformal_scale_refine(
                misscaled()[0], lo=0.3)))

    # ------------------------------------------------------------------
    def system_settings(self, out_dir):
        """Phase 9's settings: configs/euroc.yaml with the distortion
        zeroed (its corridor is rendered undistorted), the corridor IMU's
        noise densities and a 2 s IMU initialization time; its path."""
        return self.config_settings("euroc.yaml", out_dir, SYS_IMU_INI_TIME,
                                    pinhole=True)

    def config_settings(self, name, out_dir, ini_time, pinhole=False):
        """configs/<name> with the rendered corridor's IMU noise densities
        and IMU.IniTime = ini_time, its camera block as shipped (pinhole:
        the radtan coefficients zeroed), written to out_dir; its path."""
        import re

        from ppg_slam_tpu_torch import testing

        with open(os.path.join(ROOT, "configs", name)) as f:
            text = f.read()
        edits = [("IMU.NoiseGyro", testing.CORRIDOR_NOISE_GYRO),
                 ("IMU.NoiseAcc", testing.CORRIDOR_NOISE_ACC),
                 ("IMU.IniTime", ini_time)]
        if pinhole:
            edits += [(k, 0.0) for k in ("Camera.k1", "Camera.k2",
                                         "Camera.p1", "Camera.p2")]
        for key, val in edits:
            text, n = re.subn(rf"^{re.escape(key)}:.*$", f"{key}: {val!r}",
                              text, flags=re.M)
            check(n == 1, f"{name} has no single {key}")
        path = os.path.join(out_dir, name.replace(".yaml", "_corridor.yaml"))
        with open(path, "w") as f:
            f.write(text)
        return path

    def drive_system(self, system, corridor, n_frames, on_frame=None):
        """Track the first n_frames of the corridor through
        System.track_monocular; per frame, the host ms and the profiler's
        stage times it added. on_frame(k) runs before frame k."""
        from ppg_slam_tpu_torch.utils import profiler

        rows = []
        last_t = -1.0
        imu = corridor.imu
        for k in range(n_frames):
            if on_frame is not None:
                on_frame(k)
            t = corridor.times[k]
            meas = imu[(imu[:, 6] > last_t) & (imu[:, 6] <= t + 1e-9)]
            last_t = t
            before = {n: s.total for n, s in profiler.stats.items()}
            t0 = time.perf_counter()
            system.track_monocular(corridor.frames[k], t, meas)
            ms = (time.perf_counter() - t0) * 1e3
            stages = {n: (s.total - before.get(n, 0.0)) * 1e3
                      for n, s in profiler.stats.items()}
            rows.append(dict(ms=ms, stages=stages, state=system.state,
                             n_kf=system.map.n_keyframes(),
                             n_mp=system.map.n_map_points(),
                             imu=system.map.imu_initialized))
        return rows

    def phase9_system(self):
        """The port's System on the rendered corridor at EuRoC width in the
        serving configuration, on the card: tracks through monocular and
        IMU initialization, within SYS_ATE_M of the truth, every
        estimator call on CUDA, the fused kernels launched once an
        extracted frame. Then the first SYS_F32_FRAMES frames in f32 on
        CUDA and on the CPU: the same initialization."""
        import tempfile

        import numpy as np

        from ppg_slam_tpu_torch.pipeline import OK, System
        from ppg_slam_tpu_torch.utils import profiler
        from ppg_slam_tpu_torch.utils.evaluation import align_and_ate

        t_phase = time.time()
        voc = os.path.join(ROOT, "assets", "voc_euroc_9x3.npz")
        corridor = self.sys_corridor()

        with tempfile.TemporaryDirectory() as tmp_dir:
            settings = self.system_settings(tmp_dir)
            system = System(voc, settings, desc_transfer="device",
                            compute_dtype="bf16")
            check(system.device.type == "cuda"
                  and system.tracking.device.type == "cuda"
                  and system.local_mapping.device.type == "cuda"
                  and system.loop_closing.device.type == "cuda"
                  and system.loop_closing.active,
                  "System did not default to the card with active loop "
                  "closing")
            profiler.reset()
            busy = BusyWindow(SYS_FRAMES - SYS_BUSY_FRAMES)
            self.reset_launches()
            rows = self.drive_system(system, corridor, SYS_FRAMES, busy)
            busy_ms, wall_ms = busy.stop()
            self.sys_launches = self.read_launches(SYS_FRAMES,
                                                   "System main path")
            tr = system.tracking
            dm = tr._dev_matcher
            devices = {k: v for k, v in profiler.counters.items()
                       if k.startswith("device.")}
            n_loops = system.loop_closing.n_loops_closed
            detect = profiler.stats.get("loop_closing.detect")

        states = [r["state"] for r in rows]
        check(OK in states, "tracking never initialized")
        k_init = states.index(OK)
        k_imu = next((k for k, r in enumerate(rows) if r["imu"]), None)
        check(states[-1] == OK, f"last state {states[-1]}, not OK; state "
              f"events {tr.state_events}")
        check(k_imu is not None, "the IMU never initialized")
        check(n_loops == 0 and not profiler.counters.get("loops_closed"),
              f"{n_loops} loops closed on the straight corridor")
        check(detect is not None and detect.count > 0,
              "loop closing saw no keyframe")
        check(dm is not None and dm.device.type == "cuda"
              and dm.n_dispatches > 0,
              "tracking's DeviceMatcher did not run on the card")
        off_card = {k: v for k, v in devices.items()
                    if not k.endswith(".cuda")}
        check(not off_card, f"estimator calls off the card: {off_card}")
        never = [n for n in SYS_DEVICE_CALLS
                 if f"device.{n}.cuda" not in devices]
        check(not never, f"never ran on the System's path: {never}")
        per_call = {n: [round(r["stages"][f"tracking.{n}"], 1) for r in rows
                        if r["stages"].get(f"tracking.{n}", 0.0) > 0.0]
                    for n in ("imu_init", "full_inertial_ba")}
        check(per_call["full_inertial_ba"], "full_inertial_ba never ran")
        kfs = sorted((kf for kf in system.map.all_keyframes()
                      if not kf.is_bad()), key=lambda kf: kf.timestamp)
        est, gt = [], []
        for kf in kfs:
            Rcw, tcw = corridor.cam_poses[int(round(kf.timestamp
                                                     * corridor.fps))]
            est.append(kf.camera_center())
            gt.append(-Rcw.T @ tcw)
        ate = align_and_ate(np.stack(est), np.stack(gt), with_scale=True)
        check(np.isfinite(ate.rmse) and ate.rmse < SYS_ATE_M,
              f"KF-ATE {ate.rmse} m against the truth (limit {SYS_ATE_M})")

        # per-frame split over the steady inertial frames
        steady = [r for k, r in enumerate(rows)
                  if k_imu is not None and k > k_imu + 5]
        split = {}
        for name, keys in (("frame", None),
                           ("extract", ("tracking.extract",)),
                           ("preintegrate", ("tracking.preintegrate",)),
                           ("match", ("tracking.match",)),
                           ("pose", ("tracking.pose_opt",
                                     "tracking.pose_inertial")),
                           ("keyframe", ("tracking.keyframe",))):
            vals = [r["ms"] if keys is None else
                    sum(r["stages"].get(n, 0.0) for n in keys)
                    for r in steady]
            split[name] = statistics.median(vals) if vals else float("nan")
            split[name + "_mean"] = (statistics.fmean(vals) if vals
                                     else float("nan"))
        events = [(e["kind"], round(e["t"], 2), round(e["scale"], 4),
                   e["applied"]) for e in tr.init_events]
        self.sys_result = dict(split=split, busy_ms=busy_ms, wall_ms=wall_ms)
        say(f"  loop closing (active): {detect.count} keyframes, detect "
            f"{detect.total / detect.count * 1e3:.2f} ms per keyframe (max "
            f"{detect.max * 1e3:.2f}), 0 loops closed [{self.card}]")
        say(f"  System serving: init frame {k_init}, IMU init frame {k_imu}"
            f", {len(kfs)} KFs, {system.map.n_map_points()} map points; "
            f"KF-ATE {ate.rmse:.4f} m (scale {ate.scale:.4f}); events "
            f"{events}; IMU-init calls {per_call['imu_init']} ms, "
            f"full_inertial_ba in them {per_call['full_inertial_ba']} ms; "
            f"launches {self.sys_launches}; DeviceMatcher {dm.n_dispatches} "
            f"matches on {dm.device}; estimator calls by device {devices}")
        say(f"  System serving per steady frame ({len(steady)} frames, "
            f"median host ms): " + ", ".join(
                f"{k} {v:.2f}" for k, v in split.items())
            + f"; device busy {busy_ms:.1f} of {wall_ms:.1f} ms over "
            f"{SYS_BUSY_FRAMES} frames ({100 * busy_ms / wall_ms:.1f} %) "
            f"[{self.card}]")
        say("  System stages over the run:\n" + "\n".join(
            "    " + line for line in profiler.report().splitlines()))
        say(f"  init_events {tr.init_events}")

        # the first frames again in f32 (host descriptors), CUDA and CPU
        out, t_rerun = {}, {}
        for dev in (None, "cpu"):
            t0 = time.time()
            with tempfile.TemporaryDirectory() as d:
                s32 = System(voc, self.system_settings(d), device=dev)
                r32 = self.drive_system(s32, corridor, SYS_F32_FRAMES)
            st = [r["state"] for r in r32]
            check(OK in st, f"f32 rerun on {dev or 'cuda'}: no "
                            "initialization")
            out[dev or "cuda"] = (st.index(OK), r32[-1]["n_mp"],
                                  r32[-1]["n_kf"])
            t_rerun[dev or "cuda"] = round(time.time() - t0, 1)
        (k_g, mp_g, kf_g), (k_c, mp_c, kf_c) = out["cuda"], out["cpu"]
        check(k_g == k_c and abs(mp_g - mp_c) <= SYS_MP_REL * mp_c,
              f"f32 rerun: init frame {k_g} vs {k_c} on the CPU, map points"
              f" {mp_g} vs {mp_c}")
        say(f"phase 9 ok: System (serving) tracked {SYS_FRAMES} rendered "
            f"752x480 frames: init frame {k_init}, IMU init frame {k_imu}, "
            f"last state OK, KF-ATE {ate.rmse:.4f} m < "
            f"{SYS_ATE_M} m; active loop closing, 0 loops; fused kernels "
            f"once a frame; "
            f"estimators on the card; f32 rerun of {SYS_F32_FRAMES} frames: "
            f"init frame {k_g} (CPU {k_c}), map points {mp_g} (CPU {mp_c})"
            f", KFs {kf_g} (CPU {kf_c}), rerun s {t_rerun}; in "
            f"{time.time() - t_phase:.1f} s "
            f"[{self.card}]")

    # ------------------------------------------------------------------
    def phase10_loop_closing(self):
        """Loop closing on the card. (b) the synthetic loop end to end:
        testing.make_loop_sequence through Tracking, LocalMapping and an
        active LoopClosing on CUDA with the EuRoC vocabulary, held to
        tests/test_loop_closing.py's checks; (a) Sim3 exp/log, the Sim3
        RANSAC, optimize_sim3 and both essential graphs (at the loop map's
        size and at 300 keyframes) on CUDA against the same call on CPU
        tensors, timed and profiled; (c) the background GBA against the
        synchronous one, and a stopped run; (d) the loop map through a
        checkpoint; (e) the same loop through configs/tumvi.yaml's
        Kannala-Brandt camera block as shipped (512x512, T_b_c1) with the
        TUM vocabulary, held to (b)'s checks, the loop GBA profiled, then
        the loop GBA once more on the final map, which past 64 keyframes
        takes the implicit route."""
        t_phase = time.time()
        loop = self.loop_run()
        self.loop_map, self.loop_voc = loop["map"], loop["voc"]
        self.loop_functions(loop["n_kf"])
        self.background_gba()
        self.checkpoint(loop)
        self.reset_launches()
        fish = self.loop_run(config=LOOP_FISH_CONFIG, tag="(e)")
        self.fish_loop_launches = self.read_launches(0, "(e) fisheye loop")
        say(f"phase 10 ok: loop closing on the card: {loop['summary']}; "
            f"fisheye: {fish['summary']}; in {time.time() - t_phase:.1f} s "
            f"[{self.card}]")

    def loop_run(self, config=None, tag="(b)"):
        """The loop sequence through Tracking, LocalMapping and an active
        LoopClosing on the card: (b) on testing.CAM with identity
        extrinsics and the EuRoC vocabulary, or (e) through configs/<config>'s
        camera and T_b_c1 with the TUM vocabulary, its loop GBAs profiled."""
        import numpy as np
        import torch

        import ppg_slam_tpu_torch.worldmap as pwm
        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.bow import Vocabulary
        from ppg_slam_tpu_torch.pipeline import (OK, LocalMapping,
                                                 LoopClosing, Tracking)
        from ppg_slam_tpu_torch.pipeline.system import load_settings
        from ppg_slam_tpu_torch.utils import profiler
        from ppg_slam_tpu_torch.utils.evaluation import ate_rmse

        t0 = time.time()
        pwm.reset_ids()
        if config is None:
            cam, Tbc, voc_name = testing.CAM, None, "voc_euroc_9x3.npz"
            pinned = LOOP_PINNED_ATE_M
        else:
            cam = self.settings_camera(config)
            Tbc = load_settings(os.path.join(ROOT, "configs", config))["Tbc"]
            voc_name, pinned = "voc_tum_9x3.npz", LOOP_FISH_PINNED_ATE_M
        seq = testing.make_loop_sequence(
            n_frames=LOOP_FRAMES, cam=cam, Tbc=Tbc,
            overrun=0 if config is None else LOOP_FISH_OVERRUN)
        voc = Vocabulary.load(os.path.join(ROOT, "assets", voc_name))
        saved = pwm.Map.imu_ini_time
        pwm.Map.imu_ini_time = SYS_IMU_INI_TIME
        wmap = pwm.Map(pwm.Rig(cam, Tbc=Tbc, freq=200.0), vocabulary=voc)
        tracking = Tracking(wmap, testing.SyntheticExtractor(seq))
        lc = LoopClosing(wmap, active=True)
        lm = LocalMapping(wmap, tracking=tracking, loop_closer=lc)
        tracking.local_mapper = lm
        lc.local_mapper = lm
        check(all(m.device == self.dev for m in (tracking, lm, lc)),
              "the loop run's modules did not default to the card")

        # a keyframe's truth by its timestamp: a tracking reset, which a
        # round-off can set off just after the init, restarts the frame ids
        # from 0, so kf.frame_id is then no index into the sequence
        frame_of = {t: i for i, t in enumerate(seq.frame_times)}

        def truth(kf):
            return seq.frame_twc(frame_of[kf.timestamp])

        def kf_ate():
            kfs = [kf for kf in wmap.keyframes if not kf.is_bad()]
            return ate_rmse(np.stack([kf.camera_center() for kf in kfs]),
                            np.stack([truth(kf)[1] for kf in kfs]),
                            with_scale=True)

        pre = {}
        correct = lc.correct_loop

        def pre_loop_then_correct():
            pre.setdefault("ate", kf_ate())
            pre.setdefault("kf_id", lc.current_kf.mnId)
            correct()

        lc.correct_loop = pre_loop_then_correct
        card = f".{self.dev.type}"
        gbas = []
        solve_gba = lc._solve_gba

        def timed_gba(loop_kf_id, abort_check=None):
            # each loop GBA's summary (KF count, chi2), host ms and route,
            # the route from the solve counters around it; (e)'s first (the
            # loop's own) under device_profile, for its device busy share
            keys = (f"device.solve_ba_implicit{card}",
                    f"device.solve_ba{card}")
            before = [profiler.counters.get(k, 0) for k in keys]
            out = {}

            def run():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out["summary"] = solve_gba(loop_kf_id,
                                           abort_check=abort_check)
                torch.cuda.synchronize()
                out["ms"] = (time.perf_counter() - t1) * 1e3

            prof = None
            if config is not None and not gbas:
                prof = device_profile(run)
            else:
                run()
            n_impl, n_solves = (profiler.counters.get(k, 0) - b
                                for k, b in zip(keys, before))
            gbas.append(dict(out, prof=prof, implicit=n_impl,
                             solves=n_solves,
                             route="implicit" if n_impl else "dense"))
            return out["summary"]

        lc._solve_gba = timed_gba
        profiler.reset()
        last_t = -1.0
        try:
            for i in range(seq.n_frames):
                t = seq.frame_times[i]
                tracking.grab_imu(seq.imu_between(last_t, t))
                last_t = t
                tracking.grab_image(np.zeros((2, 2), np.uint8), t)
        finally:
            pwm.Map.imu_ini_time = saved
        wall = time.time() - t0
        devices = {k: v for k, v in profiler.counters.items()
                   if k.startswith("device.")}
        stats = {n: s for n, s in profiler.stats.items()
                 if n.startswith("loop_closing.")}

        check(tracking.state == OK, f"loop run: last state "
                                    f"{tracking.state}, not OK")
        check(wmap.n_keyframes() >= 30, f"loop run: {wmap.n_keyframes()} "
                                        f"keyframes")
        check(wmap.imu_initialized and wmap.inertial_ba1,
              "loop run: no IMU initialization / VIBA1")
        check(lc.n_loops_closed >= 1 and "kf_id" in pre,
              "loop run: no loop was closed")
        check(pre["kf_id"] > 0.6 * wmap.max_kf_id,
              f"loop run: the loop fired on KF {pre['kf_id']} of "
              f"{wmap.max_kf_id}")
        errs = []
        for kf in wmap.keyframes:
            if not kf.is_bad():
                Rd = kf.Rcw @ truth(kf)[0]
                errs.append(np.degrees(np.arccos(np.clip(Rd[1, 1], -1, 1))))
        rp = float(np.median(errs))
        check(rp < 2.0, f"loop run: median roll/pitch error {rp} deg")
        post = kf_ate()
        check(post < pre["ate"] and post < 2 * pinned,
              f"loop run: KF-ATE {pre['ate']} m before the loop, {post} m "
              f"after (limit {2 * pinned})")
        check(lc.gba_error is None, f"loop GBA failed: {lc.gba_error}")
        off_card = {k: v for k, v in devices.items() if not k.endswith(card)}
        check(not off_card, f"loop run: calls off the card: {off_card}")
        never = [n for n in LOOP_DEVICE_CALLS
                 if f"device.{n}{card}" not in devices]
        check(not never, f"loop run: never ran on the card: {never}")
        det = stats["loop_closing.detect"]
        ms = {n.split(".", 1)[1]: round(s.total / s.count * 1e3, 1)
              for n, s in stats.items()}
        head = (f"  {tag} loop run: {seq.n_frames} frames in {wall:.1f} s, "
                f"{wmap.n_keyframes()} KFs (max id {wmap.max_kf_id}), "
                f"{tracking.n_resets} tracking reset(s), "
                f"{lc.n_loops_closed} loop(s) closed on KF {pre['kf_id']}; "
                f"KF-ATE {pre['ate']:.4f} -> {post:.4f} m (limit "
                f"{2 * pinned}); median roll/pitch error {rp:.3f} deg; detect "
                f"{det.count} KFs, {det.total / det.count * 1e3:.1f} ms per "
                f"KF (max {det.max * 1e3:.1f}); ms per call {ms} (correct "
                f"includes the essential graph and the GBA); calls by device "
                f"{devices}; ")
        summary = (f"loop closed on KF {pre['kf_id']}, KF-ATE "
                   f"{pre['ate']:.4f} -> {post:.4f} m")
        check(len(gbas) == lc.n_loops_closed,
              f"{tag}: {len(gbas)} loop GBAs for {lc.n_loops_closed} loops")
        if config is not None:
            after, step = self.final_map_gba(wmap, lc, tag, kf_ate)
            check(np.isfinite(after) and after < 2 * pinned,
                  f"{tag}: KF-ATE {after} m after the final map's GBA (limit "
                  f"{2 * pinned})")
        for g in gbas:
            self.check_loop_gba(g, tag)

        def row(g):
            sm = g["summary"]
            text = (f"{g['route']} route, {sm['n_kf']} KFs, {g['solves']} "
                    f"solve_ba calls, chi2 {sm['initial_chi2']:.6g} -> "
                    f"{sm['final_chi2']:.6g}, {g['ms']:.1f} ms")
            if g["prof"] is None:
                return text
            k, c, busy, syncs = g["prof"]
            return (text + f" under the profiler: {k} kernels + {c} copies, "
                    f"device busy {busy:.1f} ms ({100 * busy / g['ms']:.1f} "
                    f"%), {syncs} host syncs flagged")

        loop_gba = gbas[0]
        text = head + f"loop GBA: {row(loop_gba)}"
        summary += (f", loop GBA {loop_gba['route']} at "
                    f"{loop_gba['summary']['n_kf']} KFs")
        if config is not None:
            final = gbas[-1]
            text += (f"; the final map's GBA: {row(final)}, KF-ATE after it "
                     f"{after:.4f} m; {step}")
            summary += (f", final GBA {final['route']} at "
                        f"{final['summary']['n_kf']} KFs")
        say(text + f" [{self.card}]")
        return dict(map=wmap, voc=voc, n_kf=wmap.n_keyframes(),
                    summary=summary)

    def check_loop_gba(self, g, tag):
        """A loop GBA as timed_gba read it: it solved, chi2 fell, and every
        solve took the route its size gives the entry points on CUDA
        (implicit from ba.IMPLICIT_MIN_KF keyframes on)."""
        import numpy as np

        from ppg_slam_tpu_torch.estimator.ba import IMPLICIT_MIN_KF

        s = g["summary"]
        check(s is not None and np.isfinite(s["final_chi2"])
              and s["final_chi2"] < s["initial_chi2"],
              f"{tag}: a loop GBA's chi2 did not fall: {s}")
        want = s["n_kf"] >= IMPLICIT_MIN_KF
        check(g["solves"] >= 1
              and g["implicit"] == (g["solves"] if want else 0),
              f"{tag}: the loop GBA at {s['n_kf']} KFs took "
              f"{g['implicit']} implicit-route solves of {g['solves']}")

    def final_map_gba(self, wmap, lc, tag, kf_ate):
        """(e) after its run: the final map, which must hold at least
        ba.IMPLICIT_MIN_KF keyframes, through the loop GBA once more (the
        implicit route, with the Kannala-Brandt projection Jacobians),
        that GBA's first LM step first held to the dense route's on the same
        map, CUDA's sums in a fixed order. Returns (kf_ate() after it, a
        line on that step)."""
        import dataclasses

        from ppg_slam_tpu_torch.estimator.ba import IMPLICIT_MIN_KF
        from ppg_slam_tpu_torch.estimator.ba_core import solve_ba

        n_kf = wmap.n_keyframes()
        check(n_kf >= IMPLICIT_MIN_KF,
              f"{tag}: the final map holds {n_kf} KFs, fewer than the "
              f"implicit route's {IMPLICIT_MIN_KF}")
        problem = self.window_problem(wmap, "fiba")
        args = self.solve_args(problem, self.dev, wmap.rig)
        one = dataclasses.replace(problem[4], iters=1)
        first = {}
        with deterministic_sums():
            for route in ("dense", "implicit"):
                first[route] = solve_ba(*args, one,
                                        implicit=route == "implicit")
        c0 = float(first["implicit"][2]["chi2_hist"][0])
        c1 = float(first["implicit"][2]["final_chi2"])
        s_t, s_p, s_c = self.step_diff(first["implicit"], first["dense"],
                                       args)
        check(c1 < c0 and s_t <= ROUTE_STEP_REL and s_p <= ROUTE_STEP_REL,
              f"{tag} final map, {n_kf} KFs: the implicit route's first LM "
              f"step (chi2 {c0} -> {c1}) against the dense route's: KF "
              f"positions {s_t}, points {s_p} of the step; chi2 {s_c}")
        lc.run_global_ba(max(kf.mnId for kf in wmap.all_keyframes()))
        return kf_ate(), (f"its first LM step, implicit vs dense: chi2 "
                          f"{c0:.6g} -> {c1:.6g}, KF {s_t:.3g}, point "
                          f"{s_p:.3g} of the step, chi2 {s_c:.3g}")

    def loop_functions(self, n_loop):
        """(a) each loop-closing function on CUDA against the same call on
        CPU tensors, with its host ms, kernels and host syncs per call."""
        import numpy as np
        import torch

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator import pose_graph as pg
        from ppg_slam_tpu_torch.geometry import Sim3
        from ppg_slam_tpu_torch.matching import Sim3Solver

        def row(name, diffs, fn):
            k, c, busy, syncs = device_profile(fn)
            say(f"  (a) {name}: " + ", ".join(
                f"{n} {v:.3g}" if isinstance(v, float) else f"{n} {v}"
                for n, v in diffs.items())
                + f"; ms {host_ms(lambda _: fn()):.2f}; {k} kernels + {c} "
                f"copies per call, device busy {busy:.3f} ms, {syncs} host "
                f"syncs flagged [{self.card}]")

        # ---- Sim3 exp / log over the four branches ---------------------
        rng = np.random.RandomState(SEED)
        xi = (rng.randn(4096, 7) * 0.4).astype(np.float32)
        q = len(xi) // 4
        small = xi[:2 * q, 3:6]
        xi[:2 * q, 3:6] = small * (rng.uniform(1e-7, 8e-6, (2 * q, 1))
                                   / np.linalg.norm(small, axis=1,
                                                    keepdims=True))
        xi[:q, 6] = rng.uniform(-8e-6, 8e-6, q)
        xi[2 * q:3 * q, 6] = rng.uniform(-8e-6, 8e-6, q)
        x = {d: torch.from_numpy(xi).to(d) for d in (self.dev, "cpu")}
        # the reference's formulas cancel in f32 where |sigma| is small but
        # above the branch's 1e-5 (measured on the CPU: 9.3e-5 off the f64
        # value at sigma = 1.8e-4), so each device is held to the f64 value
        # and CUDA's error to the CPU's f32 error
        x64 = x["cpu"].double()
        ref = (Sim3.exp(x64), Sim3.exp(x64).log())
        err = {}
        for d in x:
            e, lg = Sim3.exp(x[d]), Sim3.exp(x[d]).log()
            err[d] = (max(float((a.cpu().double() - b).abs().max())
                          for a, b in zip(e, ref[0])),
                      float((lg.cpu().double() - ref[1]).abs().max()))
        d_exp, d_log = err[self.dev]
        check(d_exp <= 2 * err["cpu"][0] + LC_SIM3_ABS
              and d_log <= 2 * err["cpu"][1] + LC_SIM3_ABS,
              f"Sim3 exp/log off the f64 values: cuda {err[self.dev]}, "
              f"cpu {err['cpu']}")
        row("Sim3.exp+log", dict(n=len(xi), exp_err_vs_f64=d_exp,
                                 log_err_vs_f64=d_log,
                                 exp_err_vs_f64_cpu=err["cpu"][0],
                                 log_err_vs_f64_cpu=err["cpu"][1]),
            lambda: Sim3.exp(x[self.dev]).log())

        # ---- the Sim3 RANSAC ----------------------------------------------
        for fix_scale in (False, True):
            X1, X2, uv1, uv2, _, _ = testing.sim3_matches(
                n=LC_RANSAC_MATCHES, s=1.0 if fix_scale else 1.2)

            def solve(device, fix_scale=fix_scale, data=(X1, X2, uv1, uv2)):
                solver = Sim3Solver(*data, testing.CAM, fix_scale=fix_scale,
                                    min_inliers=15, device=device)
                return solver, solver.iterate(300)

            (sg, rg), (sc, rc) = solve(None), solve("cpu")
            check(sg.device == self.dev, "Sim3Solver not on the card")
            same = (all(np.array_equal(a, b) for a, b in zip(sg._hyp,
                                                               sc._hyp))
                    and np.array_equal(rg[1], rc[1]) and rg[2:] == rc[2:]
                    and sg.iterations_done == sc.iterations_done)
            check(same and rg[0] is not None,
                  f"Sim3Solver fix_scale={fix_scale}: cuda and cpu differ "
                  f"or found no Sim3 ({rg[2]} vs {rc[2]} inliers)")
            row(f"Sim3Solver fix_scale={fix_scale}", dict(
                matches=len(X1), hypotheses=sg.max_iterations,
                inliers=rg[2], masks_equal=True), lambda: solve(None))

        # ---- optimize_sim3 -------------------------------------------------
        S0, X1, X2, uv1, uv2, (R, t, s), bad = testing.sim3_pair()
        args = {d: [torch.from_numpy(np.asarray(a, np.float32)).to(d)
                    for a in (*S0, X1, X2, uv1, uv2)]
                for d in (self.dev, "cpu")}
        for fix_scale in (False, True):
            og, oc = (pg.optimize_sim3(*args[d], testing.CAM, testing.CAM,
                                       fix_scale=fix_scale)
                      for d in (self.dev, "cpu"))
            d_s = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(og[:3], oc[:3]))
            check(d_s <= LC_OPT_ABS and torch.equal(og[3].cpu(), oc[3])
                  and (fix_scale or abs(float(og[2]) - s) < 0.01),
                  f"optimize_sim3 fix_scale={fix_scale} cuda vs cpu: "
                  f"{d_s}, inliers {int(og[4])} vs {int(oc[4])}")
            row(f"optimize_sim3 fix_scale={fix_scale}", dict(
                points=len(X1), inliers=int(og[4]), max_diff=d_s),
                lambda fs=fix_scale: pg.optimize_sim3(
                    *args[self.dev], testing.CAM, testing.CAM,
                    fix_scale=fs)[4].item())

        # ---- both essential graphs, at the loop map's size and at 300 -----
        for n in (n_loop, LC_GRAPH_KFS):
            for four in (True, False):
                g = testing.pose_graph_ring(n, seed=SEED, four_dof=four)

                def run(device, g=g, four=four):
                    a = {k: torch.from_numpy(v).to(device)
                         for k, v in g.items()}
                    if four:
                        R_, t_ = pg.optimize_essential_graph_4dof(
                            a["Rwb"], a["twb"], pg.Graph4DoF(
                                a["i"], a["j"], a["dRij"], a["dtij"]),
                            a["fixed"])
                        Rcw = R_.transpose(1, 2)
                        return (Rcw, -(Rcw @ t_[..., None])[..., 0],
                                torch.ones_like(t_[:, 0]))
                    return pg.optimize_essential_graph(
                        a["Rcw"], a["tcw"], a["s"], pg.Sim3Graph(
                            a["i"], a["j"], a["SR"], a["St"], a["Ss"]),
                        a["fixed"])

                og, oc = run(self.dev), run("cpu")
                d_R = float((og[0].cpu() - oc[0]).abs().max())
                cg, cc = (-(o[0].transpose(1, 2) @ (o[1] / o[2][:, None])
                            [..., None])[..., 0].cpu() for o in (og, oc))
                d_c = float((cg - cc).abs().max())
                e0 = loop_error(g["Rcw"], g["tcw"], g["s"], g)
                eg = loop_error(*(o.cpu().numpy() for o in og), g)
                ec = loop_error(*(o.numpy() for o in oc), g)
                check(d_R <= LC_GRAPH_R and d_c <= LC_GRAPH_M
                      and eg < 0.5 * e0 and ec < 0.5 * e0,
                      f"{'4-DoF' if four else 'Sim3'} graph at {n} KFs: "
                      f"cuda vs cpu R {d_R}, centres {d_c} m; loop error "
                      f"{e0} -> {eg} (cuda) / {ec} (cpu)")
                row(f"{'optimize_essential_graph_4dof' if four else 'optimize_essential_graph'}"
                    f" {n} KFs", dict(edges=len(g["i"]), loop_err=e0,
                                      loop_err_after=eg,
                                      loop_err_after_cpu=ec,
                                      max_R_diff=d_R, max_centre_diff_m=d_c),
                    lambda run=run: run(self.dev)[0].sum().item())

    def background_gba(self):
        """(c) the background GBA on a small map: start_gba_thread +
        poll_gba(wait=True) applies and agrees with the synchronous
        run_global_ba; a stopped run changes no pose."""
        import numpy as np

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.pipeline import LoopClosing

        base = testing.small_gba_map(seed=21)
        kf2 = base[1][2]
        truth = kf2.tcw.copy()
        kf2.set_pose(kf2.Rcw, kf2.tcw + np.float32([0.05, 0.0, 0.0]))
        (m_t, k_t, _), (m_s, k_s, _), (m_x, k_x, _) = (
            copy.deepcopy(base) for _ in range(3))
        loop_kf = k_t[-1].mnId

        lc_t = LoopClosing(m_t, active=False)
        lc_t.threaded_gba = True
        t0 = time.perf_counter()
        lc_t.start_gba_thread(loop_kf)
        applied = lc_t.poll_gba(wait=True)
        ms_thread = (time.perf_counter() - t0) * 1e3
        check(applied and not lc_t.gba_running and lc_t.gba_error is None,
              f"background GBA: applied {applied}, error {lc_t.gba_error}")
        lc_s = LoopClosing(m_s, active=False)
        t0 = time.perf_counter()
        lc_s.run_global_ba(loop_kf)
        ms_sync = (time.perf_counter() - t0) * 1e3

        def centres(kfs):
            return np.stack([k.camera_center() for k in kfs])

        def points(m):
            return np.stack([p.pos for p in sorted(m.all_map_points(),
                                                   key=lambda p: p.mnId)])

        # only KF 0 is fixed, so the visual GBA keeps a free scale, along
        # which CUDA's unordered sums move it between runs (scales
        # 0.9989-1.0016, 9.4 mm median point): divided out about KF 0, as
        # phase 8 does for its GBA, the two agree to 3.6e-7 m (centres) and
        # 2.3e-6 m (median point) over six runs, held at phase 8's limits
        ct, cs = centres(k_t), centres(k_s)
        o = cs[0]
        scale = float(np.median(np.linalg.norm(cs[1:] - o, axis=1)
                                / np.linalg.norm(ct[1:] - o, axis=1)))
        d_c = float(np.abs(scale * (ct - o) - (cs - o)).max())
        d_p = float(np.median(np.linalg.norm(
            scale * (points(m_t) - o) - (points(m_s) - o), axis=1)))
        fixed = float(np.linalg.norm(k_t[2].tcw - truth))
        check(d_c <= EST_CENTRE_M and d_p <= EST_POINT_M and fixed < 0.04,
              f"background GBA vs synchronous: centres {d_c} m, points "
              f"{d_p} m (scale {scale}); the perturbed KF {fixed} m off")

        before = [k.tcw.copy() for k in k_x]
        lc_x = LoopClosing(m_x, active=False)
        lc_x.threaded_gba = True
        lc_x.start_gba_thread(loop_kf)
        lc_x.stop_gba = True
        lc_x._gba_thread.join()
        check(not lc_x.poll_gba(wait=True)
              and all(np.array_equal(k.tcw, b) for k, b in zip(k_x, before)),
              "a stopped background GBA changed the map")
        say(f"  (c) background GBA ({len(k_t)} KFs, "
            f"{m_t.n_map_points()} points): applied, against the "
            f"synchronous run centres {d_c:.3g} m, median point {d_p:.3g} m "
            f"(free scale {scale:.6f} divided out); "
            f"perturbed KF {fixed:.4f} m from the truth; threaded "
            f"{ms_thread:.1f} ms, synchronous {ms_sync:.1f} ms; a stopped "
            f"run changed no pose [{self.card}]")

    def checkpoint(self, loop):
        """(d) the loop run's map through save_map / load_map: the same
        keyframe and map-point ids, poses and points bit-equal."""
        import tempfile

        import numpy as np

        from ppg_slam_tpu_torch.worldmap import load_map, save_map

        src = loop["map"]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "loop.ppgmap")
            t0 = time.perf_counter()
            save_map(src, path)
            t1 = time.perf_counter()
            got = load_map(path, vocabulary=loop["voc"])
            t2 = time.perf_counter()
            size = os.path.getsize(path)
        kfs = [sorted(m.keyframes, key=lambda k: k.mnId) for m in (got, src)]
        mps = [sorted(m.map_points, key=lambda p: p.mnId)
               for m in (got, src)]
        check([k.mnId for k in kfs[0]] == [k.mnId for k in kfs[1]]
              and [p.mnId for p in mps[0]] == [p.mnId for p in mps[1]],
              "checkpoint: keyframe or map-point ids changed")
        check(all(np.array_equal(a.Rcw, b.Rcw) and np.array_equal(a.tcw,
                                                                  b.tcw)
                  for a, b in zip(*kfs))
              and all(np.array_equal(a.pos, b.pos) for a, b in zip(*mps)),
              "checkpoint: poses or points changed")
        check(all(k.preintegrated is None
                  or k.preintegrated.device == self.dev for k in kfs[0]),
              "checkpoint: the loaded preintegration is not on the card")
        say(f"  (d) checkpoint: {len(kfs[0])} KFs, {len(mps[0])} map "
            f"points, {size / 1e6:.2f} MB; save {(t1 - t0) * 1e3:.1f} ms, "
            f"load (BoW re-index included) {(t2 - t1) * 1e3:.1f} ms; ids, "
            f"poses and points bit-equal [{self.card}]")

    # ------------------------------------------------------------------
    def phase11_cli(self):
        """The user entry points on the card, with configs/euroc.yaml's
        camera as shipped (radtan). (a) the first CLI_FRAMES frames of
        phase 9's corridor put through testing.distort_frames (the radtan
        images EuRoC's camera takes) as a EuRoC ASL folder (PNGs written by
        datasets/png.py, the 200 Hz IMU, the body trajectory as truth);
        (b) `cli.mono_inertial.run` on it in the serving configuration
        with the prefetcher, the threaded GBA, renders, --eval-gt and
        --save-map: every frame from the init on tracked; (c)
        FramePrefetcher against extract() frame by frame, bit-equal, in the
        serving and f32 configurations; (d) the CLI again with --load-map on
        a stretch from one of (b)'s keyframes: it starts LOST and
        relocalizes; (e) cli.train_vocabulary on 8 of the frames."""
        import tempfile

        t_phase = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            folder, settings, gt = self.cli_data(tmp)
            run = self.cli_run(tmp, folder, settings, gt)
            self.cli_launches = run["launches"]
            self.cli_prefetch_parity()
            resume = self.cli_resume(tmp, settings, gt, run,
                                     self.cli_corridor())
            self.cli_vocabulary(tmp, folder, settings)
        say(f"phase 11 ok: the CLI on the card: {run['summary']}; "
            f"{resume}; prefetch bit-equal; vocabulary CLI; in "
            f"{time.time() - t_phase:.1f} s [{self.card}]")

    def sys_corridor(self):
        """Phase 9's corridor: testing.render_corridor(SYS_CORRIDOR_FRAMES,
        seed 7) with euroc.yaml's Tbc, 752x480."""
        if not hasattr(self, "corridor"):
            self.corridor = self.fixture("phase9")
        return self.corridor

    def cli_corridor(self):
        """Phase 9's corridor as EuRoC's radtan camera takes it: the frames
        through testing.distort_frames, the poses and the IMU as they
        were."""
        if not hasattr(self, "_cli_corridor"):
            import types

            from ppg_slam_tpu_torch import testing

            corridor = self.sys_corridor()
            cam = self.settings_camera("euroc.yaml")
            check(not cam.is_fisheye and any(cam.dist),
                  "euroc.yaml has no radtan distortion")
            self._cli_corridor = types.SimpleNamespace(**vars(corridor))
            self._cli_corridor.frames = testing.distort_frames(
                corridor.frames, cam)
        return self._cli_corridor

    def cli_data(self, tmp):
        """(a) The ASL folder of the distorted corridor, euroc.yaml's
        settings (its camera as shipped) and the truth."""
        from ppg_slam_tpu_torch import testing

        t0 = time.time()
        corridor = self.cli_corridor()
        folder = os.path.join(tmp, "corridor")
        gt = testing.write_asl_folder(corridor, folder,
                                      frames=range(CLI_FRAMES))
        settings = self.config_settings("euroc.yaml", tmp, SYS_IMU_INI_TIME)
        say(f"  (a) ASL folder: {CLI_FRAMES} PNGs of 752x480 (radtan, "
            f"euroc.yaml's k1..p2), {len(corridor.imu)} IMU rows, truth in "
            f"TUM format, {time.time() - t0:.1f} s")
        return folder, settings, gt

    def cli_run(self, tmp, folder, settings, gt, kind="euroc",
                voc="voc_euroc_9x3.npz", n_frames=CLI_FRAMES,
                render_size=(500, 752), loop_closing=True, tag="(b)"):
        """(b) The README's run command, in-process, on the card: the
        `kind` CLI on `folder`, every frame from the init on tracked, the
        IMU initialized, within SYS_ATE_M of the truth, the fused kernels
        launched once a frame. render_size: the frame render's (rows,
        cols), None for no renders."""
        import numpy as np

        from ppg_slam_tpu_torch.cli.mono_inertial import run
        from ppg_slam_tpu_torch.datasets import read_gray
        from ppg_slam_tpu_torch.pipeline import OK

        out = os.path.join(tmp, f"out_{kind}")
        renders = os.path.join(tmp, f"renders_{kind}")
        os.makedirs(out)
        map_path = os.path.join(tmp, f"{kind}.ppgmap")
        self.reset_launches()
        t0 = time.time()
        stats = run(kind, os.path.join(ROOT, "assets", voc), settings,
                    os.path.join(ROOT, "assets", "ppg_weights.npz"),
                    folder, out_dir=out, progress_every=0, serving=True,
                    async_frontend=True, threaded_gba=True,
                    render_dir=renders if render_size else "",
                    render_every=CLI_RENDER_EVERY,
                    loop_closing=loop_closing, eval_gt=gt,
                    save_map=map_path)
        wall = time.time() - t0
        launches = self.read_launches(n_frames, f"the {kind} CLI run")
        stages = stats["stages"]
        counters = stages.get("counters", {})
        states = stats["states"]
        check(stats["frames"] == n_frames and states[-1] == OK,
              f"CLI {kind}: {stats['frames']} frames, last state "
              f"{states[-1:]}, state events {stats['state_events']}")
        k_init = states.index(OK)
        check(all(st == OK for st in states[k_init:]),
              f"CLI {kind}: a frame after the init ({k_init}) not tracked: "
              f"states {states}")
        check(stages.get("tracking.imu_init", {}).get("count", 0) >= 1,
              f"CLI {kind}: the IMU never initialized (init frame "
              f"{k_init}, {stats['keyframes']} KFs, events "
              f"{stats['state_events']})")
        check(stats["device"].startswith("cuda"), f"CLI ran on "
                                                  f"{stats['device']}")
        off_card = {k: v for k, v in counters.items()
                    if k.startswith("device.") and not k.endswith(".cuda")}
        check(not off_card, f"CLI {kind}: calls off the card: {off_card}")
        for name, min_rows in (("CameraTrajectory.txt", n_frames // 2),
                               ("KeyFrameTrajectory.txt", 5)):
            rows = np.loadtxt(os.path.join(out, name), ndmin=2)
            check(rows.shape[1] == 8 and len(rows) >= min_rows
                  and np.isfinite(rows).all(),
                  f"CLI {kind}: {name} has {rows.shape} rows, not TUM")
        check(np.isfinite(stats["ate_rmse"])
              and stats["ate_rmse"] < SYS_ATE_M,
              f"CLI {kind}: ATE {stats['ate_rmse']} m (limit {SYS_ATE_M})")
        if render_size:
            pngs = sorted(os.listdir(renders))
            n_r = n_frames // CLI_RENDER_EVERY
            check(len(pngs) == 2 * n_r, f"CLI {kind}: renders {pngs}")
            for name in pngs:
                img = read_gray(os.path.join(renders, name))
                want = ((768, 1024) if name.startswith("map_")
                        else render_size)
                check(img.shape == want,
                      f"CLI {kind}: render {name} is {img.shape}")
        kf_t = np.loadtxt(os.path.join(out, "KeyFrameTrajectory.txt"),
                          ndmin=2)[:, 0]
        split = {k[len("tracking."):]: round(v["mean_ms"], 1)
                 for k, v in stages.items()
                 if k.startswith("tracking.") and isinstance(v, dict)}
        decode = (f"; png.read_gray of one frame: "
                  f"{self.cli_decode_ms(tmp, folder)}" if kind == "euroc"
                  else "")
        say(f"  {tag} CLI {kind} run (serving, prefetch, threaded GBA"
            f"{'' if loop_closing else ', --no-loop-closing'}): "
            f"{stats['frames']} frames in {wall:.1f} s, init frame "
            f"{k_init}, frame median {stats['median_ms']:.1f} ms, mean "
            f"{stats['mean_ms']:.1f}, p95 {stats['p95_ms']:.1f}; "
            f"{stats['keyframes']} KFs, {stats['map_points']} map points, "
            f"ATE {stats['ate_rmse']:.4f} m; launches {launches}; stage mean "
            f"ms {split}; device {stats['device']}{decode} [{self.card}]")
        return dict(map=map_path, out=out, kf_t=kf_t, launches=launches,
                    kind=kind, voc=voc, wall=wall, stats=stats,
                    summary=(f"{n_frames} frames, median "
                             f"{stats['median_ms']:.1f} ms, ATE "
                             f"{stats['ate_rmse']:.4f} m"))

    def cli_decode_ms(self, tmp, folder):
        """The host's PNG decode of one 752x480 frame, median of 5: as the
        CLI's folder stores it (filter 0: the row-at-a-time branch of
        datasets/png.py), and with its rows cycling through all five
        filters (the average and Paeth filters take the anti-diagonal
        branch). Both read back the frame exactly."""
        from ppg_slam_tpu_torch.datasets import read_gray

        data = os.path.join(folder, "mav0", "cam0", "data")
        plain = os.path.join(data, sorted(os.listdir(data))[0])
        img = read_gray(plain)
        mixed = os.path.join(tmp, "filters_01234.png")
        with open(mixed, "wb") as f:
            f.write(filtered_png(img))
        ms = {}
        for name, path in (("filter 0", plain), ("filters 0-4", mixed)):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = read_gray(path)
                times.append((time.perf_counter() - t0) * 1e3)
                check((got == img).all(), f"png.read_gray: {name} differs")
            ms[name] = f"{statistics.median(times):.2f} ms"
        return ms

    def cli_prefetch_parity(self):
        """(c) FramePrefetcher(batch=4, depth=2) against extract(), frame
        by frame, bit-equal, serving and f32; and the raw device outputs of
        one extract_batch_async batch against one frame's."""
        import numpy as np
        import torch

        from ppg_slam_tpu_torch.frontend import PPGExtractor
        from ppg_slam_tpu_torch.frontend.prefetch import FramePrefetcher

        frames = self.cli_corridor().frames[:CLI_PREFETCH_FRAMES]
        cam = self.settings_camera("euroc.yaml")
        for cfg in (dict(desc_transfer="device", compute_dtype="bf16"),
                    dict()):
            ex = PPGExtractor(cam, **cfg)
            pf = FramePrefetcher(ex, batch=4, depth=2)
            for f in frames:
                pf.feed(f)
            got = [pf.get() for _ in frames]
            ref = [ex.extract(f) for f in frames]
            for k, (g, r) in enumerate(zip(got, ref)):
                for name in ("kp_pos", "kp_pos_un", "kp_score", "kp_out",
                             "edges", "edge_score", "colines"):
                    check(np.array_equal(getattr(g, name), getattr(r, name)),
                          f"(c) {cfg}: frame {k} {name} differs")
                check(g.connected == r.connected,
                      f"(c) {cfg}: frame {k} connected differs")
                check(np.array_equal(g.descriptors, r.descriptors),
                      f"(c) {cfg}: frame {k} host descriptors differ")
                if cfg:
                    check(torch.equal(g.desc_dev, r.desc_dev),
                          f"(c) {cfg}: frame {k} desc_dev differs")
            raw = ex.extract_batch_async(frames[:4]).host_outputs()
            for k, a in enumerate(raw):
                b = ex._device_outputs(frames[k])
                check(a.keys() == b.keys() and all(
                    np.array_equal(a[n], b[n]) for n in a),
                      f"(c) {cfg}: frame {k} raw outputs differ")
        say(f"  (c) prefetch: {CLI_PREFETCH_FRAMES} frames through "
            f"FramePrefetcher(4, 2) on the extractor's stream equal "
            f"extract() bit for bit (keypoints, scores, edges, colines, "
            f"descriptors on host and device; candidates, good, lscore), "
            f"serving and f32")

    def cli_resume(self, tmp, settings, gt, run, corridor, tag="(d)"):
        """(d) --load-map of (b)'s map on a stretch of `corridor` (the one
        the run tracked) that starts at one of its keyframes: tracking
        starts LOST, is OK within CLI_RELOC_WITHIN frames, at a pose within
        CLI_RELOC_M of the truth."""
        import numpy as np

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.cli.mono_inertial import run as cli
        from ppg_slam_tpu_torch.pipeline import LOST, OK
        from ppg_slam_tpu_torch.utils.evaluation import (associate,
                                                         load_tum, umeyama)

        kind = run["kind"]
        t_kf = float(next(t for t in run["kf_t"]
                          if t >= 1.0 + CLI_RESUME_KF_T))  # stamps from 1 s
        k0 = int(round((t_kf - 1.0) * corridor.fps))
        check(k0 + CLI_RESUME_FRAMES <= len(corridor.frames),
              f"{tag} no {CLI_RESUME_FRAMES} rendered frames from frame {k0}")
        folder = os.path.join(tmp, f"resume_{kind}")
        testing.write_asl_folder(corridor, folder,
                                 frames=range(k0, k0 + CLI_RESUME_FRAMES))
        out = os.path.join(tmp, f"out_resume_{kind}")
        os.makedirs(out)
        self.reset_launches()
        t0 = time.time()
        stats = cli(kind, os.path.join(ROOT, "assets", run["voc"]),
                    settings, os.path.join(ROOT, "assets",
                                           "ppg_weights.npz"),
                    folder, out_dir=out, progress_every=0, serving=True,
                    async_frontend=True, threaded_gba=True,
                    load_map=run["map"])
        wall = time.time() - t0
        launches = self.cli_resume_launches = self.read_launches(
            CLI_RESUME_FRAMES, f"{tag} the resumed {kind} run")
        ev = stats["state_events"]
        check(ev and ev[0]["to_state"] == LOST and ev[0]["t"] is None,
              f"{tag} the resumed run did not start LOST: {ev}")
        states = stats["states"]
        check(OK in states[:CLI_RELOC_WITHIN],
              f"{tag} not relocalized within {CLI_RELOC_WITHIN} frames: "
              f"states {states}, events {ev}")
        k_ok = states.index(OK)
        # the first run's Sim3 alignment to the truth, applied to the
        # relocalized frame's position
        te, pe = load_tum(os.path.join(run["out"], "CameraTrajectory.txt"))
        tg, pg = load_tum(gt)
        ie, ig = associate(te, tg)
        s, R, t = umeyama(pe[ie], pg[ig])
        tr, pr = load_tum(os.path.join(out, "CameraTrajectory.txt"))
        j = int(np.argmin(np.abs(tg - tr[0])))
        err = float(np.linalg.norm(s * R @ pr[0] + t - pg[j]))
        check(abs(tg[j] - tr[0]) < 1e-3 and err < CLI_RELOC_M,
              f"{tag} relocalized {err:.4f} m from the truth (limit "
              f"{CLI_RELOC_M})")
        counters = stats["stages"].get("counters", {})
        reloc = stats["stages"].get("tracking.relocalization", {})
        say(f"  {tag} resume ({kind}): --load-map from KF at {t_kf:.2f} s "
            f"(frame {k0}),"
            f" {len(states)} frames in {wall:.1f} s: started LOST, OK at "
            f"frame {k_ok} ({reloc.get('count', 0)} relocalization calls, "
            f"mean {reloc.get('mean_ms', float('nan')):.1f} ms), "
            f"relocalized centre {err:.4f} m from the truth; states "
            f"{states}; frame median {stats['median_ms']:.1f} ms; "
            f"relocalizations {counters.get('relocalization_attempts')}; "
            f"launches {launches} [{self.card}]")
        return f"resumed LOST, relocalized at frame {k_ok}, {err:.4f} m"

    def cli_vocabulary(self, tmp, folder, settings):
        """(e) cli.train_vocabulary on the card over 8 of the frames, a
        small tree; the file loads and transforms one frame's features."""
        from ppg_slam_tpu_torch.bow import Vocabulary
        from ppg_slam_tpu_torch.cli import train_vocabulary

        out = os.path.join(tmp, "voc.bin")
        t0 = time.time()
        train_vocabulary.main([settings, os.path.join(ROOT, "assets",
                                                      "ppg_weights.npz"),
                               folder, out, "--k", str(CLI_VOC_K),
                               "--L", str(CLI_VOC_L),
                               "--every", str(CLI_VOC_EVERY)])
        wall = time.time() - t0
        voc = Vocabulary.load(out)
        desc = self.extractor_f32().extract(
            self.cli_corridor().frames[0]).descriptors
        bow, _ = voc.transform(desc)
        check(voc.k == CLI_VOC_K and voc.L == CLI_VOC_L
              and voc.n_words > CLI_VOC_K and bow,
              f"(e) vocabulary: k {voc.k}, L {voc.L}, {voc.n_words} words, "
              f"{len(bow)} words in a frame")
        say(f"  (e) vocabulary CLI: {CLI_FRAMES // CLI_VOC_EVERY} frames, "
            f"{voc.n_words} words, {os.path.getsize(out)} bytes in "
            f"{wall:.1f} s; a frame's {len(desc)} descriptors -> "
            f"{len(bow)} words")

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def phase12_large_and_mesh(self):
        """Large windows and the device mesh. (a) global and full inertial
        BA's problems on prefixes of one 300-keyframe EuRoC-width window
        (testing.EurocWindow(long=True)) at 64-300 KFs, each solved on
        CUDA through both routes of solve_ba (dense fold, implicit
        matvecs), held to each other and, at 64 and 66 KFs, to the CPU;
        timed, profiled, their peak memory read; and the entry points' own
        route at each size, from the profiler's counters. (b)
        solve_ba_sharded over Mesh([cuda:0, cuda:0]) (and over distinct
        cards where there are two) on make_vi_problem and on the 128-KF
        window against the single-device solve, the sharded dry run,
        global and full inertial BA with mesh= on phase 10's loop map
        against no mesh, and extract_batch(mesh=) on the 8 EuRoC frames of
        phases 4-5, bit-equal, the fused kernels launched once a frame."""
        t_phase = time.time()
        large = self.large_windows()
        mesh = self.mesh_paths(large)
        say(f"phase 12 ok: large windows {list(LARGE_KFS)} KFs through both "
            f"routes, implicit from 66 KFs; the mesh: {mesh}; in "
            f"{time.time() - t_phase:.1f} s [{self.card}]")

    def window_problem(self, wmap, flavor):
        """(states, points, prob, kf_dof, opts) of global (visual) or full
        inertial BA on `wmap`, host arrays as the entry points gather them,
        with the options they resolve to on CUDA past 64 KFs, but a fixed
        iteration count (tol 0): with the entry points' early exit the
        two routes can stop an iteration apart."""
        import numpy as np

        from ppg_slam_tpu_torch.estimator import ba

        rig = wmap.rig
        kfs = sorted(wmap.all_keyframes(), key=lambda k: k.mnId)
        mps = wmap.all_map_points()
        kf_index = {k.mnId: i for i, k in enumerate(kfs)}
        mp_index = {mp.mnId: j for j, mp in enumerate(mps)}
        states = ba._body_states(kfs, rig)
        points = np.stack([mp.pos for mp in mps]).astype(np.float32)
        r_kf, r_mp, r_uv, _ = ba._gather_reproj(kfs, kf_index, mps, mp_index)
        c_idx, c_w, _ = ba._gather_colines(wmap, mp_index)
        kf_dof = np.zeros((len(kfs), 15), bool)
        if flavor == "gba":
            prob = ba._pad_problem(r_kf, r_mp, r_uv, c_idx, c_w)
            kf_dof[:, :6] = True
            kf_dof[0] = False
            opts = ba.BAOptions(iters=20, lambda0=1e-5, pose_cg_iters=64,
                                backtrack=True, tol=0.0)
        else:
            links = ba._gather_links(kfs, kf_index)
            prob = ba._pad_problem(r_kf, r_mp, r_uv, c_idx, c_w, links=links,
                                   bias_priors=([len(kfs) - 1], [1e2],
                                                [1e6]))
            kf_dof[:] = True
            kf_dof[0, :6] = False
            opts = ba.BAOptions(iters=25, lambda0=1e-5, reproj_kernel="huber",
                                pose_cg_iters=64, backtrack=True, tol=0.0)
        return states, points, prob, kf_dof, opts

    def solve_args(self, problem, device, rig=None):
        """solve_ba's positional arguments of a window_problem on `device`:
        with `rig`, its camera and mount, else testing.EUROC_CAM's, mounted
        as the body."""
        import numpy as np
        import torch

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator.ba_core import BAProblem, KFStates

        states, points, prob, kf_dof, _ = problem
        Rcb, tcb, cam = ((rig.Rcb, rig.tcb, rig.cam) if rig is not None else
                         (np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), testing.EUROC_CAM))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (KFStates(*map(t, states)), t(points), BAProblem(*map(t, prob)),
                t(kf_dof), torch.ones(len(points), dtype=torch.bool,
                                      device=device),
                t(Rcb), t(tcb), cam)

    def route_diff(self, a, b, gauge):
        """(max KF position difference, median point difference, chi2
        relative difference) of two solves' (states, points, info); with
        `gauge`, the free scale divided out about KF 0 first (only KF 0 is
        fixed in a visual GBA)."""
        import numpy as np

        (sa, pa, ia), (sb, pb, ib) = a, b
        ta, tb = sa.t.cpu().double().numpy(), sb.t.cpu().double().numpy()
        qa, qb = pa.cpu().double().numpy(), pb.cpu().double().numpy()
        o, s = tb[0], 1.0
        if gauge:
            s = float(np.median(np.linalg.norm(tb[1:] - o, axis=1)
                                / np.linalg.norm(ta[1:] - o, axis=1)))
        d_t = float(np.abs(s * (ta - o) - (tb - o)).max())
        d_p = float(np.median(np.linalg.norm(s * (qa - o) - (qb - o),
                                             axis=1)))
        ca, cb = float(ia["final_chi2"]), float(ib["final_chi2"])
        return d_t, d_p, abs(ca - cb) / cb

    def step_diff(self, a, b, start):
        """(KF position, point, chi2) differences of two first LM steps,
        (states, points, info) each, from `start` (solve_ba's arguments):
        the largest KF position difference over the largest KF step, the
        median point difference over the median point step, and chi2
        relative."""
        import numpy as np

        (sa, pa, ia), (sb, pb, ib) = a, b
        host = lambda x: x.cpu().double().numpy()
        t0, p0 = host(start[0].t), host(start[1])
        da, db = host(sa.t) - t0, host(sb.t) - t0
        qa, qb = host(pa) - p0, host(pb) - p0
        d_t = float(np.linalg.norm(da - db, axis=1).max()
                    / np.linalg.norm(db, axis=1).max())
        d_p = float(np.median(np.linalg.norm(qa - qb, axis=1))
                    / np.median(np.linalg.norm(qb, axis=1)))
        ca, cb = float(ia["final_chi2"]), float(ib["final_chi2"])
        return d_t, d_p, abs(ca - cb) / cb

    def large_windows(self):
        """Phase 12 (a); returns its rows and the 128-KF problems with
        their single-device solves."""
        import dataclasses

        import numpy as np
        import torch

        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator import ba
        from ppg_slam_tpu_torch.estimator.ba_core import solve_ba
        from ppg_slam_tpu_torch.imu import Preintegrated
        from ppg_slam_tpu_torch.utils import profiler

        t0 = time.time()
        cam = testing.EUROC_CAM
        win = testing.EurocWindow(seed=SEED, n_kf=max(LARGE_KFS),
                                  n_points=LARGE_POINTS, long=True)
        cpu_ns = testing.port_namespace("cpu", cam)
        rig = cpu_ns.wm.Rig(cam)
        pre = []
        for meas in win.links:
            p = Preintegrated(np.zeros(6, np.float32), rig.nga, rig.nga_walk,
                              device="cpu")
            p.integrate_measurements(*meas)
            pre.append(p)
        say(f"  (a) window: {max(LARGE_KFS)} KFs, {win.n_landmarks} "
            f"landmarks, {win.n_obs} observations "
            f"({win.n_obs / max(LARGE_KFS):.0f} a KF), built in "
            f"{time.time() - t0:.1f} s")
        rows, keep = [], {}
        for n in LARGE_KFS:
            t_size = time.time()
            wmap, kfs, _ = win.build(cpu_ns, pre, n_kf=n)
            for flavor in ("gba", "fiba"):
                problem = self.window_problem(wmap, flavor)
                opts = problem[4]
                args = self.solve_args(problem, self.dev)
                gauge = flavor == "gba"
                first, held = {}, {}
                for route in ("dense", "implicit"):
                    def call(o=opts, route=route):
                        return solve_ba(*args, o,
                                        implicit=route == "implicit")
                    # the first LM step, which the routes are held by at
                    # every size (also the warm-up)
                    with deterministic_sums():
                        first[route] = call(dataclasses.replace(opts,
                                                                iters=1))
                        if n in LARGE_CPU_KFS:
                            held[route] = call()
                    # two iterations under the profiler
                    k, c, busy, flagged = device_profile(
                        lambda: call(dataclasses.replace(opts, iters=2)))
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t1 = time.perf_counter()
                    full = call()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t1) * 1e3
                    mem = torch.cuda.max_memory_allocated() / 2 ** 20
                    held.setdefault(route, full)
                    info = full[2]
                    c0, c1 = (float(info["chi2_hist"][0]),
                              float(info["final_chi2"]))
                    check(np.isfinite(c1) and c1 < c0,
                          f"{flavor} {n} KFs {route}: chi2 {c0} -> {c1}")
                    rows.append(dict(
                        flavor=flavor, n_kf=n, route=route,
                        n_mp=int(len(problem[1])),
                        n_obs=int(problem[2].r_kf.shape[0]), ms=ms,
                        iters=int(info["iters_run"]),
                        host_syncs=int(info["host_syncs"]), peak_mib=mem,
                        device_ms_per_iter=busy / 2, kernels_per_iter=k / 2,
                        copies_per_iter=c / 2, syncs_flagged_per_iter=(
                            flagged / 2), chi2_before=c0, chi2_after=c1))
                row = {r["route"]: r for r in rows[-2:]}
                s_t, s_p, s_c = self.step_diff(first["implicit"],
                                               first["dense"], args)
                check(s_t <= ROUTE_STEP_REL and s_p <= ROUTE_STEP_REL,
                      f"{flavor} {n} KFs implicit vs dense on CUDA, first "
                      f"step: KF positions {s_t}, points {s_p} of the "
                      f"step; chi2 {s_c}")
                d_t, d_p, d_c = self.route_diff(held["implicit"],
                                                held["dense"], gauge)
                if n in LARGE_CPU_KFS:
                    check(d_c <= ROUTE_CHI2_REL and d_t <= EST_FIBA_M
                          and d_p <= EST_FIBA_M,
                          f"{flavor} {n} KFs implicit vs dense on CUDA: KF "
                          f"positions {d_t} m, median point {d_p} m, chi2 "
                          f"{d_c}")
                row["implicit"].update(
                    step_vs_dense_t_rel=s_t, step_vs_dense_point_rel=s_p,
                    step_vs_dense_chi2_rel=s_c, vs_dense_t_m=d_t,
                    vs_dense_point_m=d_p, vs_dense_chi2_rel=d_c)
                if n in LARGE_CPU_KFS:
                    # the route the entry points take at this size
                    route = "implicit" if n >= ba.IMPLICIT_MIN_KF else "dense"
                    cres = solve_ba(*self.solve_args(problem, "cpu"), opts,
                                    implicit=route == "implicit")
                    e_t, e_p, e_c = self.route_diff(held[route], cres, gauge)
                    check(e_c <= (EST_CHI2_REL if gauge
                                  else EST_FIBA_CHI2_REL)
                          and e_t <= EST_FIBA_M and e_p <= EST_FIBA_M,
                          f"{flavor} {n} KFs {route} cuda vs cpu: KF "
                          f"positions {e_t} m, median point {e_p} m, chi2 "
                          f"{e_c}")
                    row[route].update(vs_cpu_t_m=e_t, vs_cpu_point_m=e_p,
                                      vs_cpu_chi2_rel=e_c)
                if n == MESH_KFS:
                    keep[flavor] = (problem, first, held)
                    # how far the PCG(64) step is from the exact one
                    with deterministic_sums():
                        exact = solve_ba(*args, dataclasses.replace(
                            opts, iters=1, pose_cg_iters=0))
                    row["dense"]["step_vs_cholesky_t_rel"], row["dense"][
                        "step_vs_cholesky_point_rel"], _ = self.step_diff(
                            first["dense"], exact, args)
                for route in ("dense", "implicit"):
                    r = row[route]
                    say(f"  (a) {flavor} {n} KFs {route}: {r['n_mp']} "
                        f"points, {r['n_obs']} obs, {r['iters']} iters, "
                        f"{r['ms']:.1f} ms a call, {r['host_syncs']} host "
                        f"syncs, peak {r['peak_mib']:.0f} MiB; an iteration "
                        f"(2 profiled): {r['device_ms_per_iter']:.2f} device "
                        f"ms, {r['kernels_per_iter']:.0f} kernels + "
                        f"{r['copies_per_iter']:.0f} copies, "
                        f"{r['syncs_flagged_per_iter']:.0f} syncs flagged; "
                        f"chi2 {r['chi2_before']:.6g} -> "
                        f"{r['chi2_after']:.6g}"
                        + (f"; implicit vs dense: first step KF {s_t:.3g},"
                           f" point {s_p:.3g} of the step, chi2 {s_c:.3g}; "
                           f"after "
                           f"{r['iters']} iters KF {d_t:.3g} m, point "
                           f"{d_p:.3g} m, chi2 {d_c:.3g}" if route ==
                           "implicit" else "")
                        + (f"; PCG(64) first step against Cholesky's: KF "
                           f"{r['step_vs_cholesky_t_rel']:.3g}, point "
                           f"{r['step_vs_cholesky_point_rel']:.3g} of the "
                           f"step" if "step_vs_cholesky_t_rel" in r else "")
                        + (f"; vs cpu: KF {r['vs_cpu_t_m']:.3g} m, point "
                           f"{r['vs_cpu_point_m']:.3g} m, chi2 "
                           f"{r['vs_cpu_chi2_rel']:.3g}"
                           if "vs_cpu_t_m" in r else "") + f" [{self.card}]")
            # the entry points' own route on this map: global BA, then full
            # inertial BA from its result, with CUDA's sums in a fixed order.
            # With atomic sums the state global BA leaves varies from run to
            # run, and from a rare such state the PCG(64) full inertial BA
            # rejects every step up to the 16-rejection cap and ends where
            # it began; the reference, from such a state, accepts a step
            # only after 15 rejections (ROADMAP section 3). The fixed order
            # makes the check below a property of the code, not of the run
            routes = {}
            for flavor, call in (
                    ("gba", lambda: ba.global_bundle_adjustment(wmap)),
                    ("fiba", lambda: ba.full_inertial_ba(wmap))):
                profiler.reset()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with deterministic_sums():
                    summary = call()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                cnt = profiler.counters
                dev = self.dev.type
                n_impl = cnt.get(f"device.solve_ba_implicit.{dev}", 0)
                n_all = cnt.get(f"device.solve_ba.{dev}", 0)
                want = n >= ba.IMPLICIT_MIN_KF
                check(n_all >= 1 and n_impl == (n_all if want else 0)
                      and not [k for k in cnt if k.startswith("device.")
                               and not k.endswith(f".{dev}")],
                      f"{flavor} entry point at {n} KFs: routes {cnt}")
                check(summary["final_chi2"] < summary["initial_chi2"],
                      f"{flavor} entry point at {n} KFs: chi2 "
                      f"{summary['initial_chi2']} -> "
                      f"{summary['final_chi2']}")
                routes[flavor] = (f"{'implicit' if want else 'dense'} "
                                  f"({n_impl}/{n_all} solves), "
                                  f"{ms:.0f} ms")
                rows.append(dict(flavor=flavor, n_kf=n, route="entry",
                                 implicit_solves=n_impl, solves=n_all,
                                 ms=ms, iters=summary["iters_run"]))
            say(f"  (a) {n} KFs entry points: global BA {routes['gba']}, "
                f"full inertial BA {routes['fiba']}; size in "
                f"{time.time() - t_size:.1f} s [{self.card}]")
        return dict(rows=rows, keep=keep)

    def mesh_paths(self, large):
        """Phase 12 (b); returns its summary."""
        import dataclasses
        import tempfile

        import numpy as np
        import torch

        from ppg_slam_tpu_torch.estimator import ba
        from ppg_slam_tpu_torch.estimator.ba_core import BAOptions, solve_ba
        from ppg_slam_tpu_torch.parallel import (Mesh, dryrun_sharded_ba_step,
                                                 make_vi_problem,
                                                 solve_ba_sharded)
        from ppg_slam_tpu_torch.utils import profiler
        from ppg_slam_tpu_torch.worldmap import load_map, save_map

        # every comparison below runs with deterministic sums (see
        # large_windows); the whole 128-KF sharded solves run, and are
        # timed, without them
        out = {}
        meshes = {"cuda:0 x2": Mesh([self.dev, self.dev])}
        if torch.cuda.device_count() >= 2:
            meshes["cuda:0+cuda:1"] = Mesh(["cuda:0", "cuda:1"])
        # make_vi_problem and the 128-KF window, both routes
        cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
            **VI_5KF, device=self.dev)
        eye = torch.eye(3, device=self.dev)
        z3 = torch.zeros(3, device=self.dev)
        vi_args = (states, points, prob, kf_dof, mp_free, eye, z3, cam)
        for mname, mesh in meshes.items():
            for route in ("dense", "implicit"):
                implicit = route == "implicit"
                opts = BAOptions(iters=6, lambda0=1e-2, tol=0.0,
                                 pose_cg_iters=64)
                profiler.reset()
                with deterministic_sums():
                    ref = solve_ba(*vi_args, opts, implicit=implicit)
                    got = solve_ba_sharded(*vi_args, opts, mesh,
                                           implicit=implicit)
                check(profiler.counters.get(
                    f"device.solve_ba_sharded.{self.dev.type}") == 1,
                    f"make_vi_problem over {mname}: {profiler.counters}")
                d_t, d_p, d_c = self.route_diff(got, ref, gauge=False)
                d_p = float((got[1] - ref[1]).abs().max())
                check(d_c <= VI_CHI2_REL and d_t <= VI_T_M
                      and d_p <= VI_POINT_M,
                      f"make_vi_problem {route} over {mname} vs one device:"
                      f" KF {d_t} m, points {d_p} m, chi2 {d_c}")
                out[f"vi {route} {mname}"] = dict(t_m=d_t, point_max_m=d_p,
                                                  chi2_rel=d_c)
                for flavor, (problem, first, single) in large[
                        "keep"].items():
                    # held by the first LM step, as the routes are (phase
                    # 12 (a)); the whole solve timed, its gap reported
                    args = self.solve_args(problem, self.dev)
                    gauge = flavor == "gba"
                    with deterministic_sums():
                        step = solve_ba_sharded(
                            *args, dataclasses.replace(problem[4], iters=1),
                            mesh, implicit=implicit)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    got = solve_ba_sharded(*args, problem[4], mesh,
                                           implicit=implicit)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t1) * 1e3
                    s_t, s_p, s_c = self.step_diff(step, first[route], args)
                    check(s_t <= ROUTE_STEP_REL and s_p <= ROUTE_STEP_REL,
                          f"{flavor} {MESH_KFS} KFs {route} over {mname} vs "
                          f"one device, first step: KF {s_t}, point {s_p} of "
                          f"the step; chi2 {s_c}")
                    d_t, d_p, d_c = self.route_diff(got, single[route], gauge)
                    out[f"{flavor}{MESH_KFS} {route} {mname}"] = dict(
                        step_t_rel=s_t, step_point_rel=s_p, step_chi2_rel=s_c,
                        t_m=d_t, point_m=d_p, chi2_rel=d_c, ms=ms,
                        single_ms=next(
                            r["ms"] for r in large["rows"]
                            if (r["flavor"], r["n_kf"], r["route"])
                            == (flavor, MESH_KFS, route)))
            dryrun_sharded_ba_step(mesh)
        for k, v in out.items():
            say(f"  (b) {k}: " + ", ".join(f"{a} {b:.3g}"
                                           for a, b in v.items())
                + f" [{self.card}]")

        # GBA and FIBA with mesh= on clones of phase 10's loop map
        mesh = meshes["cuda:0 x2"]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "loop.ppgmap")
            save_map(self.loop_map, path)
            clones = [load_map(path, vocabulary=self.loop_voc)
                      for _ in range(4)]
        for name, fn in (("global_bundle_adjustment",
                          ba.global_bundle_adjustment),
                         ("full_inertial_ba", ba.full_inertial_ba)):
            m_mesh, m_one = clones.pop(), clones.pop()
            profiler.reset()
            with deterministic_sums():
                s_mesh = fn(m_mesh, mesh=mesh)
                check(profiler.counters.get(
                    f"device.solve_ba_sharded.{self.dev.type}", 0) >= 1,
                    f"{name}(mesh=): {profiler.counters}")
                s_one = fn(m_one)
            cm = np.stack([k.camera_center() for k in sorted(
                m_mesh.all_keyframes(), key=lambda k: k.mnId)])
            co = np.stack([k.camera_center() for k in sorted(
                m_one.all_keyframes(), key=lambda k: k.mnId)])
            o, s = co[0], 1.0
            if name == "global_bundle_adjustment":
                s = float(np.median(np.linalg.norm(co[1:] - o, axis=1)
                                    / np.linalg.norm(cm[1:] - o, axis=1)))
            d_c = float(np.abs(s * (cm - o) - (co - o)).max())
            d_x = abs(s_mesh["final_chi2"] - s_one["final_chi2"]) \
                / s_one["final_chi2"]
            check(d_c <= EST_FIBA_M and d_x <= ROUTE_CHI2_REL
                  and s_mesh["final_chi2"] < s_mesh["initial_chi2"],
                  f"{name}(mesh=) on the loop map vs no mesh: centres "
                  f"{d_c} m, chi2 {d_x} ({s_mesh['initial_chi2']} -> "
                  f"{s_mesh['final_chi2']})")
            say(f"  (b) {name}(mesh=cuda:0 x2) on the loop map "
                f"({s_mesh['n_kf']} KFs): centres {d_c:.3g} m, chi2 "
                f"{d_x:.3g} from no mesh [{self.card}]")

        # extract_batch over the mesh on phases 4-5's frames
        ex = self.extractor_f32()
        ref = ex.extract_batch(self.frames)
        torch.cuda.synchronize()
        self.reset_launches()
        got = ex.extract_batch(self.frames, mesh=mesh)
        torch.cuda.synchronize()
        self.mesh_launches = self.read_launches(len(self.frames),
                                                "extract_batch(mesh=)")
        for k, (g, r) in enumerate(zip(got, ref)):
            for key in ("kp_pos", "kp_pos_un", "kp_score", "kp_out", "edges",
                        "edge_score", "colines", "desc"):
                check(np.array_equal(getattr(g, key), getattr(r, key)),
                      f"extract_batch(mesh=) frame {k}: {key} differs")
        check(len(got) == len(ref) == len(self.frames),
              "extract_batch(mesh=): frame count")
        say(f"  (b) extract_batch(mesh=cuda:0 x2) of {len(self.frames)} "
            f"frames bit-equal to extract_batch; launches "
            f"{self.mesh_launches} [{self.card}]")
        return (f"sharded solves within limits over {list(meshes)}"
                + (" (one card: distinct cards not run)"
                   if torch.cuda.device_count() < 2 else "")
                + f", extract_batch bit-equal, launches {self.mesh_launches}")

    def phase13_fisheye(self):
        """The Kannala-Brandt configurations end to end on the card, each
        camera block as shipped, on the corridor rendered through a wider
        pinhole canvas and resampled into the fisheye. (a) the README's
        `tumvi` command with configs/tumvi.yaml (512x512) on TUMVI_FRAMES
        frames through the IMU init, --eval-gt, then --load-map on a
        stretch from one of its keyframes: it starts LOST and relocalizes
        through the fisheye PnP; (b) the `uma` command with
        --no-loop-closing and configs/uma.yaml (1024x768, 12 fps, a 250 Hz
        IMU) on UMA_FRAMES frames through the IMU init; (c)
        configs/tumvi1024.yaml (1024x1024): pair_probe and line_validate
        against their plain versions and timed at the 1024x1024 and
        1024x768 shapes, then the System on T1024_FRAMES frames with the
        stage split of its steady frames. The fused kernels launch once a
        frame in every run."""
        import tempfile

        t_phase = time.time()
        self.fish_launches = {}
        with tempfile.TemporaryDirectory() as tmp:
            a = self.fisheye_cli(tmp, "tumvi", "tumvi.yaml", "(13a)",
                                 resume=True)
            b = self.fisheye_cli(tmp, "uma", "uma.yaml", "(13b)")
        c = self.fisheye_1024()
        say(f"phase 13 ok: the Kannala-Brandt configurations on the card: "
            f"tumvi 512x512 {a}; uma 1024x768 {b}; tumvi 1024x1024 {c}; in "
            f"{time.time() - t_phase:.1f} s [{self.card}]")

    def fisheye_corridor(self, config):
        """configs/<config>'s camera and the corridor it takes (FIXTURES):
        rendered through testing.fisheye_canvas(cam) with the config's
        T_b_c1 and resampled into the fisheye by testing.distort_frames."""
        from ppg_slam_tpu_torch import testing

        cam = self.settings_camera(config)
        check(cam.is_fisheye, f"{config} is not Kannala-Brandt")
        canvas = testing.fisheye_canvas(cam)
        corridor = self.fixture(config)
        _, n_frames, fps, imu_hz = FIXTURES[config]
        say(f"  {config}: {n_frames} frames {cam.width}x{cam.height} KB8 "
            f"from a {canvas.width}x{canvas.height} canvas (f "
            f"{canvas.fx:.1f}), {len(corridor.imu)} IMU rows at "
            f"{imu_hz:g} Hz, {fps:g} fps")
        return cam, corridor

    def fisheye_cli(self, tmp, kind, config, tag, resume=False):
        """(13a), (13b): one fisheye configuration through the CLI (and,
        with resume, the --load-map run); its summary."""
        from ppg_slam_tpu_torch import testing

        cam, corridor = self.fisheye_corridor(config)
        n_frames = len(corridor.frames)
        if kind == "uma":
            self.uma_frame = (cam, corridor.frames[8])
        folder = os.path.join(tmp, kind)
        writer = (testing.write_uma_folder if kind == "uma"
                  else testing.write_asl_folder)
        gt = writer(corridor, folder, frames=range(n_frames))
        settings = self.config_settings(config, tmp, SYS_IMU_INI_TIME)
        run = self.cli_run(tmp, folder, settings, gt, kind=kind,
                           voc="voc_tum_9x3.npz", n_frames=n_frames,
                           render_size=None, loop_closing=kind != "uma",
                           tag=tag)
        self.fish_launches[f"{kind}_cli"] = run["launches"]
        summary = run["summary"]
        if resume:
            summary += "; " + self.cli_resume(tmp, settings, gt, run,
                                              corridor, tag=tag)
            self.fish_launches[f"{kind}_resume"] = self.cli_resume_launches
        return summary

    def fisheye_case(self, name, cam, frame):
        """(name, heat, kp_un, kp_ok) of one frame on the card, as the f32
        extractor decodes it."""
        import torch

        from ppg_slam_tpu_torch.frontend import PPGExtractor

        ex = PPGExtractor(cam)
        a = ex._device_outputs(frame)
        return (name,) + tuple(torch.from_numpy(x).to(self.dev) for x in (
            ex.device_heat(frame), a["kp_un"], a["kp_ok"]))

    def fisheye_1024(self):
        """(13c): the fused kernels at the 1024x1024 and 1024x768 shapes,
        then configs/tumvi1024.yaml's System; its summary."""
        import tempfile

        from ppg_slam_tpu_torch.pipeline import OK, System
        from ppg_slam_tpu_torch.utils import profiler

        cam, corridor = self.fisheye_corridor("tumvi1024.yaml")
        check((cam.width, cam.height) == (1024, 1024),
              "tumvi1024.yaml is not 1024x1024")
        cases = [self.fisheye_case("tumvi1024", cam, corridor.frames[8]),
                 self.fisheye_case("uma", *self.uma_frame)]
        self.fused_parity(cases, tag="  (13c) 1024x1024 and 1024x768")
        self.fish_rows = {f"{int(c[1].shape[1])}x{int(c[1].shape[0])}":
                          self.fused_timing(c) for c in cases}
        voc = os.path.join(ROOT, "assets", "voc_tum_9x3.npz")
        with tempfile.TemporaryDirectory() as d:
            system = System(voc, self.config_settings(
                "tumvi1024.yaml", d, SYS_IMU_INI_TIME),
                desc_transfer="device", compute_dtype="bf16")
            profiler.reset()
            self.reset_launches()
            busy = BusyWindow(T1024_FRAMES - T1024_BUSY_FRAMES)
            t0 = time.time()
            rows = self.drive_system(system, corridor, T1024_FRAMES, busy)
            busy_ms, busy_wall_ms = busy.stop()
            wall = time.time() - t0
            self.fish_launches["tumvi1024_system"] = self.read_launches(
                T1024_FRAMES, "(13c) the 1024x1024 System")
        states = [r["state"] for r in rows]
        check(OK in states, f"(13c) no init: states {states}")
        k_init = states.index(OK)
        check(all(st == OK for st in states[k_init:])
              and len(states) - k_init >= T1024_TRACKED,
              f"(13c) not {T1024_TRACKED} tracked frames after the init "
              f"({k_init}): states {states}")
        k_imu = next((k for k, r in enumerate(rows) if r["imu"]), None)
        # the pose-inertial frames after the IMU init, else the visual ones
        inertial = k_imu is not None and len(rows) - k_imu > 4
        first = k_imu + 2 if inertial else k_init + 2
        steady = rows[first:] if inertial else rows[first:k_imu]
        check(steady, f"(13c) no steady frame: states {states}")
        split = {}
        for name, keys in (("frame", None),
                           ("extract", ("tracking.extract",)),
                           ("preintegrate", ("tracking.preintegrate",)),
                           ("match", ("tracking.match",)),
                           ("pose", ("tracking.pose_opt",
                                     "tracking.pose_inertial")),
                           ("keyframe", ("tracking.keyframe",))):
            vals = [r["ms"] if keys is None else
                    sum(r["stages"].get(n, 0.0) for n in keys)
                    for r in steady]
            split[name] = statistics.median(vals) if vals else float("nan")
            split[name + "_mean"] = (statistics.fmean(vals) if vals
                                     else float("nan"))
        self.fish_split = split
        say(f"  (13c) System 1024x1024 (serving): {T1024_FRAMES} frames in "
            f"{wall:.1f} s, init frame {k_init}, IMU init frame {k_imu}, "
            f"{rows[-1]['n_kf']} KFs, {rows[-1]['n_mp']} map points; per "
            f"steady frame ({len(steady)} frames from frame {first}, host "
            f"ms, pose = {'pose-inertial' if inertial else 'pose'}"
            f"): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + f"; device busy {busy_ms:.1f} of {busy_wall_ms:.1f} ms over "
            f"the last {T1024_BUSY_FRAMES} frames (from frame "
            f"{T1024_FRAMES - T1024_BUSY_FRAMES}; "
            f"{100 * busy_ms / busy_wall_ms:.1f} %); launches "
            f"{self.fish_launches['tumvi1024_system']} [{self.card}]")
        return (f"kernels bit-equal at 1024x1024 and 1024x768, "
                f"{len(states) - k_init} frames tracked from frame {k_init}, "
                f"steady frame median {split['frame']:.1f} ms")

    # ------------------------------------------------------------------
    def kernel_table(self):
        rows = [self.sampler_rows[n] for n in MAIN_SIZES]
        table = [{
            "name": "nearest_binary_packed",
            "route": "cuda",
            "source": "ppg_slam_tpu_torch/kernels/nearest_binary_packed.cu",
            "replaces": "ppg_slam_tpu/ops/sampling.py:104",
            # the main path (the System, phase 9) launches the fused
            # kernels below instead
            "launches": self.sys_launches["nearest_binary_packed"],
            "launches_frontend": self.launches["nearest_binary_packed"],
            "launches_cli": self.cli_launches["nearest_binary_packed"],
            "launches_fisheye": {run: got["nearest_binary_packed"] for run,
                                 got in self.fish_launches.items()},
            "launches_mesh": self.mesh_launches["nearest_binary_packed"],
            # phase 10 (e): the fisheye loop on synthetic features
            "launches_fisheye_loop":
                self.fish_loop_launches["nearest_binary_packed"],
            "on_main_path": False,
            "max_abs_err": self.max_abs_err,
            # one frame's four sampler calls at their former main-path sizes
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            "library_ms": None,
        }]
        for name in FUSED:
            row = self.fused_rows[name]
            table.append({
                "name": name,
                "route": "cuda",
                "source": f"ppg_slam_tpu_torch/kernels/{name}.cu",
                "replaces": "ppg_slam_tpu/ops/sampling.py:104",
                "stage": {"pair_probe": "ppg_slam_tpu/ops/pairs.py:67",
                          "line_validate": "ppg_slam_tpu/ops/pairs.py:197"
                          }[name],
                "launches": self.sys_launches[name],
                "launches_frontend": self.launches[name],
                "launches_cli": self.cli_launches[name],
                "launches_mesh": self.mesh_launches[name],
                "launches_fisheye_loop": self.fish_loop_launches[name],
                "launches_fisheye": {run: got[name] for run, got in
                                     self.fish_launches.items()},
                "on_main_path": True,
                "max_abs_err": self.fused_err[name],
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": None,
                "eager_ms": row["eager_ms"],
                "shapes": {shape: {k: rows[name][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "eager_ms",
                    "n_cand")} for shape, rows in self.fish_rows.items()},
            })
        return {"kernels": table}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ppg_slam_tpu_torch")):
        print("chip_smoke.py: the ppg_slam_tpu_torch package is missing "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA GPU", file=sys.stderr)
        return 1
    smoke = Smoke()
    phases = [smoke.phase1_card, smoke.phase2_build,
              smoke.phase3_kernel_parity, smoke.phase4_main_f32,
              smoke.phase5_serving, smoke.phase6_batch, smoke.phase7_tumvi,
              smoke.phase8_estimator, smoke.phase9_system,
              smoke.phase10_loop_closing, smoke.phase11_cli,
              smoke.phase12_large_and_mesh, smoke.phase13_fisheye]
    for k, phase in enumerate(phases, 1):
        try:
            phase()
        except Exception as exc:  # every phase's failure is fatal
            traceback.print_exc()
            print(f"phase {k} FAILED: {exc}", flush=True)
            return 1
    print(json.dumps(smoke.kernel_table()), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
