"""Finds the benchmark's parts by name: BENCHMARK.json at the checkout's
root, and under this directory configs/<name>.json, traffic/<name>.json and
metrics/<name>.py. A new configuration, traffic mix or metric is a new file;
nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "configs", name + ".json"))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "traffic", name + ".json"))


def reader(name: str, base: str = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slam_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The entries of bench[kind] ("end_to_end" or "per_layer") that the
    cell reports: those without a workloads key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def settings_yaml(settings: dict) -> str:
    """An OpenCV FileStorage YAML document of a configuration's settings
    (what the program's load_settings reads): numbers and quoted strings,
    and 4x4 lists as !!opencv-matrix blocks."""
    lines = ["%YAML:1.0"]
    for key, val in settings.items():
        if isinstance(val, list):
            rows, cols = len(val), len(val[0])
            data = ", ".join(repr(float(v)) for row in val for v in row)
            lines += [f"{key}: !!opencv-matrix", f"   rows: {rows}",
                      f"   cols: {cols}", "   dt: f", f"   data: [{data}]"]
        elif isinstance(val, str):
            lines.append(f'{key}: "{val}"')
        else:
            lines.append(f"{key}: {float(val)!r}")
    return "\n".join(lines) + "\n"
