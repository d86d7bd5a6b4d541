"""lba_ms: host ms a call of the program's stage timer local_mapping.lba
over the window."""


def read(run):
    n, total = run.stats.get("local_mapping.lba", (0, 0.0))
    return total / n * 1e3 if n else None
