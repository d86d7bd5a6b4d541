"""Dataset drivers: mono_inertial_{euroc,tumvi,uma}, a port of
ppg_slam_tpu/cli/mono_inertial.py.

CLI-compatible with the reference binaries (positional args: vocabulary,
settings, net weights, dataset folder — try_euroc.cpp:17-26), producing
TUM-format CameraTrajectory.txt / KeyFrameTrajectory.txt in the output
directory on completion. Images are read with datasets/png.py (what
cv2.imread(path, IMREAD_GRAYSCALE) returns); everything runs on `--device`
(CUDA unless told otherwise).

Usage:
    python -m ppg_slam_tpu_torch.cli.mono_inertial euroc VOC SETTINGS WEIGHTS DATA
    python -m ppg_slam_tpu_torch.cli.mono_inertial tumvi VOC SETTINGS WEIGHTS DATA
    python -m ppg_slam_tpu_torch.cli.mono_inertial uma   VOC SETTINGS WEIGHTS DATA
Optional flags: --out-dir DIR --max-frames N --realtime-factor F
--render-dir D --render-every N --no-loop-closing --eval-gt GT
--async-frontend --threaded-gba --async-mapping --serving
--save-map P --load-map P --device DEV
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def run(dataset_kind: str, voc: str, settings: str, weights: str,
        data: str, out_dir: str = ".", max_frames: int = 0,
        realtime_factor: float = 0.0, progress_every: int = 100,
        render_dir: str = "", render_every: int = 10,
        loop_closing: bool = True, eval_gt: str = "",
        async_frontend: bool = False, threaded_gba: bool = False,
        async_mapping: bool = False, serving: bool = False,
        save_map: str = "", load_map: str = "", device=None) -> dict:
    """Track a dataset folder end to end; returns the run's stats (frames,
    per-frame ms, keyframes, map points, loops, per-stage profile, the
    tracking state after each frame and the state changes, the device,
    and ate_rmse with eval_gt)."""
    import torch

    from ..datasets import load_euroc, load_tumvi, load_uma, read_gray
    from ..pipeline import System
    from ..utils import profiler

    profiler.reset()  # per-run stage stats (the process-global profiler
    #                   otherwise accumulates across runs in one process)
    loader = {"euroc": load_euroc, "tumvi": load_tumvi, "uma": load_uma}[
        dataset_kind]
    images, stamps, imu = loader(data)
    if max_frames:
        images = images[:max_frames]
        stamps = stamps[:max_frames]

    slam = System(voc, settings, weights_path=weights or None,
                  use_viewer=bool(render_dir), viewer_out_dir=render_dir,
                  viewer_every=render_every,
                  active_loop_closing=loop_closing,
                  async_frontend=async_frontend, threaded_gba=threaded_gba,
                  async_mapping=async_mapping,
                  desc_transfer="device" if serving else "f32",
                  compute_dtype="bf16" if serving else "f32",
                  load_map_path=load_map or None, device=device)
    t_last_imu = -np.inf
    t_track, states = [], []
    lookahead = (slam.prefetcher.batch * slam.prefetcher.depth
                 if slam.prefetcher is not None else 0)
    imgs_cache = {}

    def read(k):
        if k not in imgs_cache:
            if os.path.exists(images[k]):
                imgs_cache[k] = read_gray(images[k])
            else:
                imgs_cache[k] = None
        return imgs_cache[k]

    fed = 0
    for k, (path, ts) in enumerate(zip(images, stamps)):
        img = read(k)
        imgs_cache.pop(k, None)
        if img is None:
            print(f"warning: missing image {path}", file=sys.stderr)
            continue
        sel = (imu[:, 6] > t_last_imu) & (imu[:, 6] <= ts)
        t_last_imu = ts
        t0 = time.perf_counter()
        if slam.prefetcher is not None:
            while fed <= k or fed < min(k + 1 + lookahead, len(images)):
                nxt = read(fed)
                if nxt is not None:
                    slam.feed_frame(nxt)
                fed += 1
        slam.track_monocular(img, float(ts), imu[sel])
        slam.poll_background()
        dt = time.perf_counter() - t0
        t_track.append(dt)
        states.append(slam.state)
        if realtime_factor > 0:
            budget = (stamps[min(k + 1, len(stamps) - 1)] - ts) \
                / realtime_factor
            if dt < budget:
                time.sleep(budget - dt)
        if progress_every and k % progress_every == 0:
            print(f"[{k}/{len(images)}] state={slam.state} "
                  f"kfs={slam.map.n_keyframes()} "
                  f"mps={slam.map.n_map_points()} track={dt*1e3:.1f}ms")
    slam.shutdown(out_dir, save_map_path=save_map)
    arr = np.asarray(t_track)
    dev = slam.device
    stats = dict(frames=len(arr), mean_ms=float(arr.mean() * 1e3),
                 median_ms=float(np.median(arr) * 1e3),
                 p95_ms=float(np.percentile(arr, 95) * 1e3),
                 keyframes=slam.map.n_keyframes(),
                 map_points=slam.map.n_map_points(),
                 loops=slam.loop_closing.n_loops_closed,
                 device=(f"cuda ({torch.cuda.get_device_name(dev)})"
                         if dev.type == "cuda" else str(dev)))
    print(profiler.report(), file=sys.stderr)
    stats["stages"] = profiler.summary()
    stats["states"] = states
    stats["state_events"] = slam.tracking.state_events
    if eval_gt:
        from ..utils.evaluation import evaluate_files

        res = evaluate_files(os.path.join(out_dir, "CameraTrajectory.txt"),
                             eval_gt, with_scale=True)
        stats["ate_rmse"] = res.rmse
        print(f"ATE RMSE (Sim3, {res.n_pairs} pairs): {res.rmse:.4f} m")
    print({k: v for k, v in stats.items()
           if k not in ("stages", "states", "state_events")})
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="ppg_slam_tpu_torch.cli.mono_inertial")
    ap.add_argument("kind", choices=["euroc", "tumvi", "uma"])
    ap.add_argument("vocabulary")
    ap.add_argument("settings")
    ap.add_argument("weights")
    ap.add_argument("dataset")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--realtime-factor", type=float, default=0.0)
    ap.add_argument("--render-dir", default="",
                    help="dump offline-viewer PNGs (map + frame overlay)")
    ap.add_argument("--render-every", type=int, default=10)
    ap.add_argument("--no-loop-closing", action="store_true",
                    help="disable loop closing (the reference UMA config's "
                         "ActiveLoop: 0 intent)")
    ap.add_argument("--eval-gt", default="",
                    help="ground-truth trajectory (TUM or EuRoC CSV); "
                         "report Sim3 ATE RMSE after the run")
    ap.add_argument("--async-frontend", action="store_true",
                    help="extract frames ahead of tracking on the "
                         "extractor's own CUDA stream")
    ap.add_argument("--threaded-gba", action="store_true",
                    help="run loop-closure global BA on a background thread")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local mapping + loop closing on a consumer "
                         "thread (the reference's 4-thread deployment)")
    ap.add_argument("--save-map", default="",
                    help="checkpoint the final map to this path")
    ap.add_argument("--load-map", default="",
                    help="resume from a saved map: tracking starts LOST "
                         "and relocalizes into it")
    ap.add_argument("--serving", action="store_true",
                    help="serving config: bf16 nets + device-resident "
                         "descriptors with device-side gated matching")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    a = ap.parse_args(argv)
    run(a.kind, a.vocabulary, a.settings, a.weights, a.dataset,
        out_dir=a.out_dir, max_frames=a.max_frames,
        realtime_factor=a.realtime_factor, render_dir=a.render_dir,
        render_every=a.render_every, loop_closing=not a.no_loop_closing,
        eval_gt=a.eval_gt, async_frontend=a.async_frontend,
        threaded_gba=a.threaded_gba, async_mapping=a.async_mapping,
        serving=a.serving, save_map=a.save_map, load_map=a.load_map,
        device=a.device)


if __name__ == "__main__":
    main()
