"""loop_detect_ms: host ms a keyframe of the program's stage timer
loop_closing.detect over the window."""


def read(run):
    n, total = run.stats.get("loop_closing.detect", (0, 0.0))
    return total / n * 1e3 if n else None
