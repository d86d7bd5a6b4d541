"""match_ms: host ms a window frame in the program's stage timer
tracking.match (the tracking.device_match timers run inside it)."""


def read(run):
    n, total = run.stats.get("tracking.match", (0, 0.0))
    return total / len(run.latencies) * 1e3 if n and run.latencies else None
