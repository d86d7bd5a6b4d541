"""preintegrate_ms: host ms a window frame in the program's stage timer
tracking.preintegrate."""


def read(run):
    n, total = run.stats.get("tracking.preintegrate", (0, 0.0))
    return total / len(run.latencies) * 1e3 if n and run.latencies else None
