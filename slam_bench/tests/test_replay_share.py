"""The pose_inertial_replay_share reader on fixed views of a window's
stage timers (CPU)."""

import types

import pytest

from slam_bench import registry


def view(stats):
    return types.SimpleNamespace(stats=stats)


@pytest.mark.parametrize("stats,share", [
    ({"tracking.pose_inertial": (40, 3.2), "pose_inertial.replay": (40, 0.1)},
     100.0),
    ({"tracking.pose_inertial": (40, 3.2), "pose_inertial.replay": (38, 0.1)},
     95.0),
    # a program with the replay whose window made none
    ({"tracking.pose_inertial": (40, 3.2), "pose_inertial.replay": (0, 0.0)},
     0.0),
    # a program without the replay (the timer never appears), or no call
    ({"tracking.pose_inertial": (40, 24.0)}, None),
    ({"tracking.pose_inertial": (0, 0.0), "pose_inertial.replay": (0, 0.0)},
     None),
])
def test_the_replay_share_reads_replays_over_calls(stats, share):
    read = registry.reader("pose_inertial_replay_share")
    assert read(view(stats)) == share
    names = {m["name"] for m in registry.benchmark()["per_layer"]}
    assert "pose_inertial_replay_share" in names
