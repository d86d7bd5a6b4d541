"""pose_inertial_replay_share: % of the window's tracking.pose_inertial
calls that replayed pose_inertial_optimization's CUDA graph (the program's
pose_inertial.replay timer); None where the program has no such timer (a
program without the replay) or made no call."""


def read(run):
    n = run.stats.get("tracking.pose_inertial", (0, 0.0))[0]
    if not n or "pose_inertial.replay" not in run.stats:
        return None
    return 100.0 * run.stats["pose_inertial.replay"][0] / n
