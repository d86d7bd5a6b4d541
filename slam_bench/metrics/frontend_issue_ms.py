"""frontend_issue_ms: host ms a window frame in the program's stage timer
frontend.dispatch (FramePrefetcher issuing a batch's upload, nets and
decode through PPGExtractor.extract_batch_async)."""


def read(run):
    n, total = run.stats.get("frontend.dispatch", (0, 0.0))
    return total / len(run.latencies) * 1e3 if n and run.latencies else None
