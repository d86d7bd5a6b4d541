"""pose_inertial_ms: host ms a call of the program's stage timer
tracking.pose_inertial over the window."""


def read(run):
    n, total = run.stats.get("tracking.pose_inertial", (0, 0.0))
    return total / n * 1e3 if n else None
