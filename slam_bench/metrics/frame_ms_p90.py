"""frame_ms_p90: the 90th percentile of the window's per-frame latency of
feed + System.track_monocular (ms), over all its frames."""


def read(run):
    if not run.latencies:
        return None
    return run.arith.percentile(run.latencies, 90) * 1e3
