"""setup_s: from the process's start until the window opens (s)."""


def read(run):
    return run.setup_s
