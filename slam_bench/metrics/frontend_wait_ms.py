"""frontend_wait_ms: host ms a window frame that tracking waits in
System.prefetcher.get for the frame's features (the harness's span)."""


def read(run):
    if not run.latencies or not run.frontend_wait_s:
        return None
    return run.frontend_wait_s / len(run.latencies) * 1e3
