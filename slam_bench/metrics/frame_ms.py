"""frame_ms: the window's time over the frames that returned in it (ms)."""


def read(run):
    if not run.latencies:
        return None
    return run.window_s / len(run.latencies) * 1e3
