"""frontend_get_ms: host ms a window frame in the program's stage timer
frontend.get (FramePrefetcher.get: tracking waiting for the frame's
features, the event wait and the host graph build included)."""


def read(run):
    n, total = run.stats.get("frontend.get", (0, 0.0))
    return total / len(run.latencies) * 1e3 if n and run.latencies else None
