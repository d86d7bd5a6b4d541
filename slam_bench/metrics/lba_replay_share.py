"""lba_replay_share: % of the window's local_mapping.lba calls whose solve
replayed local BA's LM iterations from CUDA graphs (the program's
local_ba.replay timer); None where the program has no such timer (a
program without the replay) or made no call."""


def read(run):
    n = run.stats.get("local_mapping.lba", (0, 0.0))[0]
    if not n or "local_ba.replay" not in run.stats:
        return None
    return 100.0 * run.stats["local_ba.replay"][0] / n
