"""pose_inertial_eager_ms: host ms a tracking.pose_inertial call spends
inside the program's pose_inertial.prior_sqrt and pose_inertial.marginal
timers (the prior's eigh before the solve, the marginalization's svd and
eigh after it), over the window; None where the program has no such timers
or made no call.

Each timer is the host's clock around calls that read their status on the
host, so it also holds what the stream had to finish first: on the CUDA
graph's path, pose_inertial.prior_sqrt waits for the inputs' upload issued
just before it, and pose_inertial.marginal for the tail of the replayed
graph, whose launch returns before the graph ends. The device time of the
eager kernels alone is under these spans in slam_bench.attribution's
stages."""


def read(run):
    n = run.stats.get("tracking.pose_inertial", (0, 0.0))[0]
    names = ("pose_inertial.prior_sqrt", "pose_inertial.marginal")
    if not n or not all(k in run.stats for k in names):
        return None
    return sum(run.stats[k][1] for k in names) / n * 1e3
