"""ATE evaluation CLI: `python -m ppg_slam_tpu_torch.cli.evaluate EST GT [options]`
(a copy of ppg_slam_tpu/cli/evaluate.py).

The one-command equivalent of the reference's offline evo evaluation of its
TUM-format CameraTrajectory.txt / KeyFrameTrajectory.txt
(Viewer.cpp:853-959; BASELINE.md 5%-ATE targets).
Monocular(-inertial pre-scale) runs need --scale (Sim3 alignment); use
--no-scale for gravity-aligned metric trajectories.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.evaluation import evaluate_files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ppg_slam_tpu_torch.cli.evaluate",
        description="Umeyama-aligned ATE RMSE between TUM-format "
                    "trajectories (estimate vs ground truth).")
    ap.add_argument("estimate", help="estimated trajectory (TUM format)")
    ap.add_argument("ground_truth",
                    help="ground truth (TUM format or EuRoC CSV)")
    sc = ap.add_mutually_exclusive_group()
    sc.add_argument("--scale", dest="scale", action="store_true",
                    default=True,
                    help="Sim3 (scaled) alignment — default, monocular")
    sc.add_argument("--no-scale", dest="scale", action="store_false",
                    help="SE3 alignment (metric trajectories)")
    ap.add_argument("--max-diff", type=float, default=0.02,
                    help="max stamp difference for association [s]")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of a table")
    ap.add_argument("--rpe", type=float, metavar="DELTA", default=0.0,
                    help="also report translational RPE over DELTA-second "
                         "windows (evo_rpe equivalent; local drift)")
    args = ap.parse_args(argv)

    res = evaluate_files(args.estimate, args.ground_truth,
                         with_scale=args.scale, max_diff=args.max_diff)
    rpe = None
    if args.rpe > 0:
        from ..utils.evaluation import evaluate_files_rpe

        rpe = evaluate_files_rpe(args.estimate, args.ground_truth,
                                 delta=args.rpe, with_scale=args.scale,
                                 max_diff=args.max_diff)
    if args.json:
        out = {"ate_rmse": res.rmse, "mean": res.mean,
               "median": res.median, "max": res.max,
               "pairs": res.n_pairs, "scale": res.scale}
        if rpe is not None:
            out["rpe_rmse"] = rpe.rmse
            out["rpe_delta_s"] = args.rpe
        print(json.dumps(out))
    else:
        print(f"ATE ({'Sim3' if args.scale else 'SE3'} alignment, "
              f"{res.n_pairs} pairs)")
        print(f"  rmse    {res.rmse:.6f} m")
        print(f"  mean    {res.mean:.6f} m")
        print(f"  median  {res.median:.6f} m")
        print(f"  max     {res.max:.6f} m")
        if args.scale:
            print(f"  scale   {res.scale:.6f}")
        if rpe is not None:
            print(f"RPE trans ({args.rpe:g} s windows, {rpe.n_pairs} pairs)")
            print(f"  rmse    {rpe.rmse:.6f} m")
            print(f"  median  {rpe.median:.6f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
