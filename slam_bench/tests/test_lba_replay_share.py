"""The lba_replay_share reader on fixed views of a window's stage timers
(CPU)."""

import types

import pytest

from slam_bench import registry


@pytest.mark.parametrize("stats,share", [
    ({"local_mapping.lba": (20, 9.6), "local_ba.replay": (20, 1.2)}, 100.0),
    ({"local_mapping.lba": (20, 9.6), "local_ba.replay": (19, 1.2)}, 95.0),
    # a program with the replay whose window replayed no solve
    ({"local_mapping.lba": (20, 9.6), "local_ba.replay": (0, 0.0)}, 0.0),
    # a program without the replay (the timer never appears), or no call
    ({"local_mapping.lba": (20, 13.0)}, None),
    ({"local_mapping.lba": (0, 0.0), "local_ba.replay": (0, 0.0)}, None),
])
def test_the_lba_replay_share_reads_replays_over_calls(stats, share):
    read = registry.reader("lba_replay_share")
    assert read(types.SimpleNamespace(stats=stats)) == share
    metric = {m["name"]: m for m in registry.benchmark()["per_layer"]}[
        "lba_replay_share"]
    assert metric["layer"] == "mapping"
    assert metric["workloads"] == ["tumvi-cruise", "euroc-cruise"]
