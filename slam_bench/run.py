"""One run of one cell of the benchmark of ppg_slam_tpu_torch, on the card.

    python3 -m slam_bench.run --workload tumvi-cruise --seed 17 \\
        --seconds 51 --trace 0

from the root of a checkout. The cell (BENCHMARK.json) names a configuration
(configs/<name>.json: the settings the System runs, its deployment, the
limits of the comparison) and a traffic mix (traffic/<name>.json: the
corridor's motion). Set-up renders the corridor from the seed on the card,
builds the System as the configuration deploys it, and tracks frames, fed
ahead through System.feed_frame as the CLI does, until the map has its IMU
initialization and first inertial refinement and five frames more. The
window then tracks frames as fast as the System takes them (a closed loop:
the CLI's --realtime-factor 0) for --seconds, ending with the frame that
returns past it. After the window the System is stopped, and the front-end's
outputs of a sample of the window's frames and the window's poses are
judged: against a plain float32 forward of the nets (slam_bench/reference)
and against the generator's truth.

Standard output ends with one JSON line: correct, attempted (the window's
frames), failed (those whose tracking did not end OK), metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics, each from
metrics/<name>.py), device, with --trace 1 a breakdown, and last the numbers
compared, each with its limit. Exits non-zero with no result where no CUDA
device is present or fewer than the cell asks for, where a module of jax,
jaxlib, flax or ppg_slam_tpu is loaded, or where the set-up does not reach
the steady inertial state. Writes only under TMPDIR and the checkout's
.bench_cache/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return time.time()
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel and extension caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
# one thread in each CPU pool (set before numpy and torch load): the System
# issues its device work from one host thread, and a pool's idle threads
# would spin on the cores beside it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "ppg_slam_tpu")
SETUP_AFTER_VIBA1 = 5   # frames tracked after the first inertial refinement
SAMPLE_FRAMES = 12      # window frames whose front-end is judged
SETUP_CHUNK = 8         # frames rendered at a time during set-up
SE3_POSES = 6           # the fewest centres a rigid alignment is judged on


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", " | ")


class Run:
    """One run: set-up, window, judgement. `plant(system)`, where given, is
    called once the set-up is done (the faults test breaks the timed path
    there)."""

    def __init__(self, cell: dict, cfg: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 plant=None):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.dev, self.plant = device, plant
        self.notes = []

    # -- traffic ---------------------------------------------------------
    def _traffic(self):
        import numpy as np

        from . import render

        s, tr = self.cfg["settings"], self.traffic
        sysc = self.cfg["system"]
        self.cam = render.camera(s)
        self.lookahead = (sysc["prefetch_batch"] * sysc["prefetch_depth"]
                          if sysc["async_frontend"] else 0)
        self.cap = (tr["frames"]["setup_max"]
                    + int(tr["frames"]["window_fps_cap"] * self.seconds)
                    + 2 * self.lookahead + 2)
        motion = tr["motion"]
        self.scene = render.Scene(tr["scene_seed"], self.cap,
                                  motion["speed_m_per_frame"],
                                  float(self.cfg["render"]["reach_m"]),
                                  self.dev)
        canvas = (render.fisheye_canvas(self.cam) if self.cam.kind == "kb8"
                  else None)
        self.renderer = render.Renderer(self.scene, self.cam, self.seed,
                                        canvas)
        self.motion = render.Motion(
            tr["imu_seed"], motion, np.asarray(s["IMU.T_b_c1"], np.float32),
            self.cam.fps, float(s["IMU.Frequency"]),
            float(s["IMU.NoiseGyro"]), float(s["IMU.NoiseAcc"]))
        self.frames = []
        self.imu = np.zeros((0, 7))

    def ensure(self, n: int) -> None:
        """Render frames until `n` exist (at most the cap)."""
        import numpy as np

        n = min(n, self.cap)
        while len(self.frames) < n:
            lo = len(self.frames)
            hi = min(n, lo + 64)
            self.motion.advance(hi)
            imgs = self.renderer.render(
                [(k, *self.motion.camera_pose(k)) for k in range(lo, hi)])
            self.frames.extend(list(imgs.cpu().numpy()))
        self.imu = self.motion.imu_rows() if self.motion.imu else \
            np.zeros((0, 7))

    def truth(self, k: int):
        """(Rcw, tcw) of frame k's camera in the generator's world."""
        return self.motion.camera_pose(k)

    # -- the System --------------------------------------------------------
    def _system(self, tmp: str):
        from ppg_slam_tpu_torch.pipeline import System

        from . import registry

        path = os.path.join(tmp, "settings.yaml")
        with open(path, "w") as f:
            f.write(registry.settings_yaml(self.cfg["settings"]))
        sysc, assets = self.cfg["system"], self.cfg["assets"]
        return System(
            os.path.join(ROOT, assets["vocabulary"]), path,
            weights_path=os.path.join(ROOT, assets["weights"]),
            active_loop_closing=sysc["active_loop_closing"],
            async_frontend=sysc["async_frontend"],
            prefetch_batch=sysc["prefetch_batch"],
            prefetch_depth=sysc["prefetch_depth"],
            threaded_gba=sysc["threaded_gba"],
            async_mapping=sysc["async_mapping"],
            desc_transfer=sysc["desc_transfer"],
            compute_dtype=sysc["compute_dtype"], device=self.dev)

    def step(self, k: int):
        """Feed ahead and track frame k: (latency s, Frame, state)."""
        import numpy as np

        sysm = self.system
        t = k / self.cam.fps
        t_prev = (k - 1) / self.cam.fps if k else -np.inf
        ts = self.imu[:, 6]
        meas = self.imu[(ts > t_prev + 1e-9) & (ts <= t + 1e-9)]
        t0 = time.perf_counter()
        if sysm.prefetcher is not None:
            while self.fed <= k or self.fed < min(k + 1 + self.lookahead,
                                                  len(self.frames)):
                sysm.feed_frame(self.frames[self.fed])
                self.fed += 1
        frame = sysm.track_monocular(self.frames[k], t, meas)
        sysm.poll_background()
        return time.perf_counter() - t0, frame, sysm.state

    def setup(self, tmp: str) -> None:
        from ppg_slam_tpu_torch.utils import profiler

        t0 = time.time()
        self._traffic()
        self.ensure(SETUP_CHUNK + self.lookahead + 1)
        t_render = time.time() - t0
        self.system = self._system(tmp)
        t_build = time.time() - t0 - t_render
        profiler.reset()
        self.fed, k, after = 0, 0, None
        max_setup = self.traffic["frames"]["setup_max"]
        events = {}
        while after is None or after < SETUP_AFTER_VIBA1:
            if k >= max_setup:
                raise RuntimeError(
                    f"set-up did not reach the steady inertial state in "
                    f"{max_setup} frames ({events}; resets "
                    f"{self.system.tracking.n_resets})")
            self.ensure(k + 1 + self.lookahead + SETUP_CHUNK)
            _, _, state = self.step(k)
            m = self.system.map
            for key, flag in (("init", state == self.OK),
                              ("imu", m.imu_initialized),
                              ("viba1", m.inertial_ba1)):
                if flag:
                    events.setdefault(key, k)
            if state != self.OK:
                events["not_ok"] = events.get("not_ok", 0) + 1
            k += 1
            if m.inertial_ba1 and state == self.OK:
                after = 0 if after is None else after + 1
            else:
                after = None
        resets0 = self.system.tracking.n_resets
        self.notes.append(f"frames of {events}")
        self.first = k
        t_frames = time.time() - t0 - t_render - t_build
        want = (self.first + int(self.traffic["frames"]["window_fps_cap"]
                                 * self.seconds) + self.lookahead + 1)
        self.ensure(want)
        self.renderer = self.scene = None  # every frame is rendered
        if self.dev == "cuda":
            import torch

            torch.cuda.synchronize()
        self.resets0 = resets0
        say(f"set-up: render {t_render:.2f} s, System {t_build:.2f} s, "
            f"{self.first} frames {t_frames:.2f} s, window frames "
            f"{len(self.frames) - self.first} rendered "
            f"{time.time() - t0 - t_render - t_build - t_frames:.2f} s; "
            f"{self.system.map.n_keyframes()} KFs; resets {resets0}; "
            + "; ".join(self.notes))

    # -- the window --------------------------------------------------------
    def window(self) -> None:
        import numpy as np

        from ppg_slam_tpu_torch.utils import profiler

        from . import trace as tr

        if self.plant is not None:
            self.plant(self.system)
        rng = np.random.RandomState((self.seed + 13) % 2 ** 32)
        self.sample, self.rows = [], []
        before = {n: (s.count, s.total) for n, s in profiler.stats.items()}
        kfs0 = self.system.map.n_keyframes()
        spans = tr.Spans()
        self.spans, self.device_trace = spans, None
        wait = [0.0]
        if self.trace:
            pf = self.system.prefetcher
            if pf is not None:
                get = pf.get

                def timed_get():
                    with spans.span("frontend_wait"):
                        t0 = time.perf_counter()
                        try:
                            return get()
                        finally:
                            wait[0] += time.perf_counter() - t0
                pf.get = timed_get
            self.device_trace = tr.DeviceTrace().__enter__()
        capture = spans.capture(profiler) if self.trace else None
        if capture is not None:
            capture.__enter__()
        t_open = time.perf_counter()
        deadline = t_open + self.seconds
        exhausted = False
        try:
            while True:
                k = self.first + len(self.rows)
                if k >= len(self.frames) - self.lookahead - 1:
                    exhausted = True
                    break
                if self.trace:
                    with spans.span("frame"):
                        lat, frame, state = self.step(k)
                else:
                    lat, frame, state = self.step(k)
                self.rows.append(dict(
                    k=k, lat=lat,
                    ok=state == self.OK and frame.has_pose,
                    R=frame.Rcw.copy(), tc=frame.tcw.copy(),
                    epoch=self.system.map.transform_epoch))
                i = len(self.rows) - 1
                if i < SAMPLE_FRAMES:
                    self.sample.append((k, frame.feats))
                else:
                    j = rng.randint(0, i + 1)
                    if j < SAMPLE_FRAMES:
                        self.sample[j] = (k, frame.feats)
                if time.perf_counter() >= deadline:
                    break
        finally:
            self.window_s = time.perf_counter() - t_open
            if capture is not None:
                capture.__exit__(None, None, None)
            if self.device_trace is not None:
                self.device_trace.__exit__(None, None, None)
        if exhausted:
            say(f"the window used up the {len(self.frames)} frames rendered "
                f"after {self.window_s:.2f} s: it ends at the last frame")
        self.frontend_wait_s = wait[0]
        self.stats = {n: (s.count - before.get(n, (0, 0.0))[0],
                          s.total - before.get(n, (0, 0.0))[1])
                      for n, s in profiler.stats.items()}
        self.window_kfs = self.system.map.n_keyframes() - kfs0
        self.epochs = len({r["epoch"] for r in self.rows})
        self.resets = self.system.tracking.n_resets - self.resets0

    # -- after the window ----------------------------------------------------
    def collect(self) -> None:
        """Read what the judgement needs from the System, then stop it."""
        import torch

        sysm = self.system
        self.judged = []
        for k, f in sorted(self.sample, key=lambda s: s[0]):
            n = f.n_kp
            desc = (f.desc_dev[:n].clone() if f.desc_dev is not None
                    else torch.from_numpy(f.descriptors[:n].copy()))
            self.judged.append((k, f.kp_pos.copy(), f.kp_score.copy(), desc))
        self.sample = None
        sysm.local_mapping.stop()
        if sysm.loop_closing.threaded_gba:
            sysm.loop_closing.poll_gba(wait=True)
        self.system = None

    def judge(self) -> dict:
        """The numbers compared: the front-end's on the sampled window
        frames against the plain nets (pooled over the sample); the
        window's camera centres against the truth (RMS, cm). The IMU makes
        the map metric, so the centres are aligned to the truth by a rigid
        motion alone (no scale): all at once where the window stays in one
        map frame; otherwise each map frame apart, leaving out a map frame
        with fewer than SE3_POSES centres, where a rigid fit leaves little
        residual."""
        import numpy as np
        import torch

        from . import arith, render
        from .reference import frontend as ref

        nets = ref.Nets(ref.load_weights(
            os.path.join(ROOT, self.cfg["assets"]["weights"]), self.dev))
        cam = self.cam
        if cam.kind == "pinhole" and any(abs(d) > 0 for d in cam.dist):
            def undistort(xy):
                return render.radtan_undistort(xy.astype(np.float32), cam)
        else:
            def undistort(xy):
                return xy.astype(np.float32)
        frames = []
        for k, pos, score, desc in self.judged:
            out = nets.forward(torch.from_numpy(self.frames[k]).to(self.dev))
            xy = ref.greedy_nms(out["junc"].cpu().numpy())
            frames.append(ref.compare(out, xy, undistort(xy), pos, score,
                                      desc))
        # a whole-map transform (an IMU scale refinement, a loop
        # correction) moves every pose after it into another map frame
        errs = []
        for epoch in sorted({r["epoch"] for r in self.rows}):
            rows = [r for r in self.rows if r["ok"] and r["epoch"] == epoch]
            if len(rows) < SE3_POSES:
                continue
            est = np.stack([arith.camera_center(r["R"], r["tc"])
                            for r in rows])
            gt = np.stack([arith.camera_center(*self.truth(r["k"]))
                           for r in rows])
            errs.append(arith.aligned_errors(est, gt, with_scale=False))
        track = float("inf")
        self.n_judged = sum(len(e) for e in errs)
        if errs:
            e = np.concatenate(errs)
            track = float(np.sqrt((e * e).mean())) * 100.0
        return dict(ref.pooled(frames), track_ate_cm=track)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run: Run, bench: dict, numbers: dict, device: dict,
                trace_summary) -> dict:
    import types

    from . import arith, registry

    limits = run.cfg["limits"]
    correct = (len(run.rows) > 0
               and all(v <= limits[k] for k, v in numbers.items()))
    # a number with nothing to read (inf) goes out as null: strict JSON
    checks = {k: dict(value=v if math.isfinite(v) else None, limit=limits[k])
              for k, v in numbers.items()}
    view = types.SimpleNamespace(
        latencies=[r["lat"] for r in run.rows], window_s=run.window_s,
        setup_s=run.setup_s, stats=run.stats,
        frontend_wait_s=run.frontend_wait_s, trace=trace_summary, arith=arith)
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, run.cell["name"], kind):
        v = registry.reader(m["name"])(view)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    out = dict(correct=bool(correct), attempted=len(run.rows),
               failed=sum(not r["ok"] for r in run.rows), metrics=metrics,
               device=device)
    if trace_summary is not None:
        device["busy_s"] = trace_summary["busy_s"]
        device["window_s"] = trace_summary["window_s"]
        out["breakdown"] = trace_summary["breakdown"]
    out["checks"] = checks
    return out


def execute(run: Run, bench: dict) -> dict:
    """Set-up, window, judgement of `run`: the result line (a dict)."""
    import gc
    import tempfile

    import torch

    from ppg_slam_tpu_torch.pipeline import OK

    run.OK = OK
    cuda = run.dev == "cuda"
    with tempfile.TemporaryDirectory(prefix="slam_bench_") as tmp:
        run.setup(tmp)
        if cuda:
            say(f"card before the window: {card_state()}")
        run.setup_s = time.time() - T_START
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        run.window()
        if cuda:
            torch.cuda.synchronize()
            peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(run.cell["chips"]))
            say(f"card after the window: {card_state()}")
    device = (dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=run.cell["chips"], memory_peak_bytes=peak) if cuda
              else dict(platform="cpu", kind="cpu", count=0,
                        memory_peak_bytes=0))
    summary = None
    if run.device_trace is not None:
        t0 = time.time()
        summary = run.device_trace.summary(run.spans)
        run.device_trace = None
        say(f"trace read in {time.time() - t0:.2f} s")
    run.collect()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    line = result_line(run, bench, run.judge(), device, summary)
    say(f"window: {len(run.rows)} frames in {run.window_s:.3f} s, "
        f"{run.window_kfs} keyframes, {run.epochs} map frames ("
        f"{run.n_judged} poses judged), resets "
        f"{run.resets}, failed "
        f"{line['failed']}; setup_s {run.setup_s:.3f}")
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from . import registry

    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        say(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    run = Run(cell, registry.config(cell["config"]),
              registry.traffic(cell["traffic"]), args.seed, args.seconds,
              bool(args.trace))
    line = execute(run, bench)
    found = forbidden_modules()
    if found:
        say(f"no result: modules {found} are loaded")
        return 3
    for k, c in line["checks"].items():
        say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
