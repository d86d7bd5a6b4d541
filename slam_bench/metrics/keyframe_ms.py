"""keyframe_ms: host ms a keyframe in the program's stage timer
tracking.keyframe over the window (keyframe creation with the synchronous
mapping it runs)."""


def read(run):
    n, total = run.stats.get("tracking.keyframe", (0, 0.0))
    return total / n * 1e3 if n else None
