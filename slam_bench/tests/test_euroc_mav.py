"""The euroc-mav configuration (EuRoC MAV's 752x480 radtan pinhole and
200 Hz IMU) and its cell euroc-cruise:

* its settings are configs/euroc.yaml's, but for the one key it lists as
  reduced (IMU.IniTime), reduced from the shipped value: the IMU is made
  and weighed with the ADIS16448's shipped noise densities;
* the plain reference, with render.radtan_undistort for the positions the
  program reports, equals the program's f32 extractor on a radtan crop
  with seeded random weights: Run.judge's radtan branch reads 0 where the
  program computes what the reference computes;
* the int8 control and the state left unchanged read over its limits: on
  the CPU on one seed each, on the card on three (each seed's readings
  printed, as test_control.py and test_faults.py print tumvi-512's);
* the pose_inertial_eager_ms reader.
"""

import os
import types

import numpy as np
import pytest
import torch

import ppg_slam_tpu_torch  # noqa: F401  (sets TF32 off on import)
from slam_bench import registry, render
from slam_bench import run as harness
from slam_bench.reference import frontend as ref
from slam_bench.tests import test_control, test_faults

CONFIG, CELL = "euroc-mav", "euroc-cruise"
REDUCED = {"IMU.IniTime": "imu_ini_time"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def test_settings_are_the_shipped_yaml_but_the_reduced_keys(tmp_path):
    from ppg_slam_tpu_torch.pipeline.system import load_settings

    cfg = registry.config(CONFIG)
    assert sorted(cfg["reduced"]) == sorted(REDUCED)
    path = tmp_path / "s.yaml"
    path.write_text(registry.settings_yaml(cfg["settings"]))
    s = load_settings(str(path))
    shipped = load_settings(os.path.join(registry.ROOT, cfg["file_from"]))
    assert sorted(s) == sorted(shipped)
    for k, v in shipped.items():
        if k in REDUCED.values():
            continue
        if hasattr(v, "shape"):
            assert (s[k] == v).all(), k
        else:
            assert s[k] == v, k
    for key, name in REDUCED.items():
        r = cfg["reduced"][key]
        assert shipped[name] == r["source"] != r["run"] == s[name], key
    cam = render.camera(cfg["settings"])
    assert (cam.kind, cam.width, cam.height) == ("pinhole", 752, 480)
    assert cam.dist == (shipped["k1"], shipped["k2"], shipped["p1"],
                        shipped["p2"])


def _random_weights(path, seed: int = 7) -> str:
    """The weight file's keys and shapes with seeded random values: He-scaled
    convs, so activations stay of order one, and a junction head scaled up
    so that its softmax picks clear junctions."""
    rng = np.random.RandomState(seed)
    out = {}
    with np.load(os.path.join(registry.ROOT, "assets", "ppg_weights.npz")) \
            as z:
        for k in z.files:
            shape = z[k].shape
            if k.endswith("/w"):
                scale = np.sqrt(2.0 / np.prod(shape[:3]))
                if k.startswith("junction/convPb"):
                    scale *= 8.0
                a = rng.randn(*shape) * scale
            elif k.endswith("bn_var"):
                a = 1.0 + rng.rand(*shape)
            elif k.endswith("bn_gamma"):
                a = 1.0 + 0.1 * rng.randn(*shape)
            else:
                a = 0.05 * rng.randn(*shape)
            out[k] = a.astype(np.float32)
    np.savez(path, **out)
    return str(path)


def test_the_reference_equals_the_programs_f32_extractor_on_a_radtan_crop(
        tmp_path):
    from ppg_slam_tpu_torch import testing
    from ppg_slam_tpu_torch.frontend import PPGExtractor
    from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel

    s = registry.config(CONFIG)["settings"]
    x0, y0, w, h = 24, 16, 192, 128  # the top-left corner: the most distorted
    crop = dict(s, **{"Camera.cx": s["Camera.cx"] - x0,
                      "Camera.cy": s["Camera.cy"] - y0,
                      "Camera.width": float(w), "Camera.height": float(h)})
    cam = render.camera(crop)
    corridor = testing.render_corridor(n_frames=2, seed=3,
                                       cam=testing.EUROC_CAM)
    img = np.ascontiguousarray(corridor.frames[1][y0:y0 + h, x0:x0 + w])
    weights = _random_weights(tmp_path / "w.npz")
    ex = PPGExtractor(CameraModel(kind=CAM_PINHOLE, fx=cam.fx, fy=cam.fy,
                                  cx=cam.cx, cy=cam.cy, dist=cam.dist,
                                  width=w, height=h),
                      weights_path=weights, device="cpu")
    f = ex.extract(img)
    out = ref.Nets(ref.load_weights(weights, "cpu")).forward(
        torch.from_numpy(img))
    xy = ref.greedy_nms(out["junc"].numpy())
    assert len(xy) > 20 and f.n_kp == len(xy)
    pos = render.radtan_undistort(xy.astype(np.float32), cam)
    # the crop's corner is distorted by pixels: positions are not the grid's
    assert np.abs(pos - xy).max() > 2.0
    got = ref.pooled([ref.compare(out, xy, pos, f.kp_pos, f.kp_score,
                                  torch.from_numpy(f.descriptors))])
    assert got["kp_miss"] == 0.0, got
    assert got["score_gap"] <= 1e-5 and got["desc_gap"] <= 1e-5, got


def test_the_int8_control_fails_on_the_cpu():
    r = test_control.readings(CONFIG, test_control.SEEDS[0], "cpu", 2)
    assert test_control.fails(r), r


def _run(device, seed, plant=None, small=False):
    bench = registry.benchmark()
    cell = registry.workload(bench, CELL)
    traffic = registry.traffic(cell["traffic"])
    seconds = bench["run_seconds"]
    if small:
        traffic["frames"].update(setup_max=120, window_fps_cap=3)
        seconds = test_faults.SECONDS
    run = harness.Run(cell, registry.config(CONFIG), traffic, seed, seconds,
                      False, device=device, plant=plant)
    line = harness.execute(run, bench)
    return line["checks"]["track_ate_cm"]["value"], line


def test_the_state_left_unchanged_fails_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        frozen, line = _run("cpu", test_faults.SEED,
                            test_faults.plant_unchanged, small=True)
    finally:
        torch.set_num_threads(n)
    print("unchanged", {k: c["value"] for k, c in line["checks"].items()})
    assert not line["correct"], line["checks"]
    limit = registry.config(CONFIG)["limits"]["track_ate_cm"]
    assert frozen is None or frozen > limit


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card):
    for seed in test_control.SEEDS:
        r = test_control.readings(CONFIG, seed, card, 12)
        print(f"control {CONFIG} seed {seed}: {r['control']} limits "
              f"{r['limits']}", flush=True)
        assert test_control.fails(r), r


@pytest.mark.cuda
def test_the_pose_number_readings_on_the_card(card):
    limit = registry.config(CONFIG)["limits"]["track_ate_cm"]
    for seed in test_faults.CARD_SEEDS:
        with test_faults.tf32():
            control, line = _run(card, seed)
        print(f"tf32 {CONFIG} seed {seed}: {control} correct "
              f"{line['correct']} frames {line['attempted']}", flush=True)
        frozen, line = _run(card, seed, test_faults.plant_unchanged)
        print(f"unchanged {CONFIG} seed {seed}: {frozen} correct "
              f"{line['correct']} frames {line['attempted']}", flush=True)
        assert frozen is None or frozen > limit


@pytest.mark.parametrize("stats,ms", [
    ({"tracking.pose_inertial": (40, 3.2),
      "pose_inertial.prior_sqrt": (40, 0.04),
      "pose_inertial.marginal": (40, 0.08)}, 3.0),
    # the eager path's calls time the same spans
    ({"tracking.pose_inertial": (4, 0.4),
      "pose_inertial.prior_sqrt": (4, 0.002),
      "pose_inertial.marginal": (4, 0.006)}, 2.0),
    # a program without the timers (the parent of this metric), or no call
    ({"tracking.pose_inertial": (40, 3.2)}, None),
    ({"tracking.pose_inertial": (40, 3.2),
      "pose_inertial.prior_sqrt": (40, 0.04)}, None),
    ({"tracking.pose_inertial": (0, 0.0),
      "pose_inertial.prior_sqrt": (0, 0.0),
      "pose_inertial.marginal": (0, 0.0)}, None),
])
def test_pose_inertial_eager_ms_reads_the_timers_a_call(stats, ms):
    read = registry.reader("pose_inertial_eager_ms")
    got = read(types.SimpleNamespace(stats=stats))
    assert got == ms if ms is None else got == pytest.approx(ms, rel=1e-12)
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[
        "pose_inertial_eager_ms"]
    assert CELL in entry["workloads"] and entry["moves"] == "frame_ms"
