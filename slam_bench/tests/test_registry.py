"""The harness finds configurations, traffic mixes and metrics by name: a
new one is a new file."""

import json
import os
import shutil

import pytest

from slam_bench import registry


@pytest.fixture
def tree(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(registry.HERE + "/configs", base / "configs")
    shutil.copytree(registry.HERE + "/traffic", base / "traffic")
    shutil.copytree(registry.HERE + "/metrics", base / "metrics")
    return str(base)


def test_a_new_config_traffic_and_metric_are_found_by_name(tree):
    cfg = registry.config("tumvi-512", tree)
    cfg["name"] = "tumvi-512.wide"
    cfg["settings"]["Camera.width"] = 800.0
    with open(os.path.join(tree, "configs", "tumvi-512.wide.json"), "w") as f:
        json.dump(cfg, f)
    mix = registry.traffic("cruise", tree)
    mix["motion"]["speed_m_per_frame"] = 0.2
    with open(os.path.join(tree, "traffic", "fast.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tree, "metrics", "frames.per-window.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.latencies))\n")
    assert registry.config("tumvi-512.wide", tree)["settings"][
        "Camera.width"] == 800.0
    assert registry.traffic("fast", tree)["motion"][
        "speed_m_per_frame"] == 0.2
    read = registry.reader("frames.per-window", tree)
    assert read(type("R", (), {"latencies": [1, 2, 3]})) == 3.0
    # the shipped ones are untouched
    assert registry.config("tumvi-512")["settings"]["Camera.width"] == 512.0


def test_every_metric_and_cell_of_the_benchmark_resolves():
    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    for w in bench["workloads"]:
        assert registry.workload(bench, w["name"]) is w
        registry.config(w["config"])
        registry.traffic(w["traffic"])
    for c in bench["configs"]:
        assert c["file"] == f"slam_bench/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    with pytest.raises(KeyError):
        registry.workload(bench, "no-such-cell")


def test_metrics_of_a_cell_follow_their_workloads_key():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in registry.metrics_of(bench, "x", "per_layer")] \
        == ["a", "b"]
    assert [m["name"] for m in registry.metrics_of(bench, "y", "per_layer")] \
        == ["a"]


def test_settings_yaml_is_what_the_program_reads(tmp_path):
    from ppg_slam_tpu_torch.pipeline.system import load_settings

    cfg = registry.config("tumvi-512")
    path = tmp_path / "s.yaml"
    path.write_text(registry.settings_yaml(cfg["settings"]))
    s = load_settings(str(path))
    shipped = load_settings(os.path.join(registry.ROOT, "configs",
                                         "tumvi.yaml"))
    for k, v in shipped.items():
        if k in ("noise_gyro", "noise_acc", "imu_ini_time"):
            continue
        if hasattr(v, "shape"):
            assert (s[k] == v).all()
        else:
            assert s[k] == v, k
    assert (s["noise_gyro"], s["noise_acc"], s["imu_ini_time"]) == (
        1.7e-3, 2e-2, 2.0)
