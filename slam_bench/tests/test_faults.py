"""A run whose timed path is broken underneath comes out not correct, once
for each fault the cells can have; a sound run comes out correct. The runs
skip the look for a card and drive the rest of a run on the CPU (the
program's plain PyTorch paths), with fewer frames rendered than on the card
(each takes a few minutes here).

The faults, planted once the set-up is done:
* unchanged: the tracking step returns its state unchanged (each frame
  keeps the previous frame's pose);
* half: half of each prefetched batch left out, its frames given the
  features of the other half;
* descriptors: every frame's descriptors altered where they are produced
  (rolled by one keypoint);
* pose: the pose an answer carries altered where it is produced (every
  other frame 0.5 m off).
The exchange between chips does not exist in a one-chip cell.

On the card, at the cell's own size and window, the pose number's readings
on three seeds: the estimator's control (the program's float32, configured
with TF32 off, run with TF32 on, the whole run) and the state left
unchanged. Each seed's readings are printed."""

import contextlib

import numpy as np
import pytest
import torch

import ppg_slam_tpu_torch  # noqa: F401  (sets TF32 off on import)
from slam_bench import registry
from slam_bench import run as harness

SEED = 2 ** 31 + 77
SECONDS = 25.0
CARD_SEEDS = (2 ** 31 + 404, 2 ** 31 + 505, 2 ** 31 + 606)


def plant_unchanged(system):
    tr = system.tracking

    def frozen():
        f, last = tr.current, tr.last_frame
        f.Rcw, f.tcw, f.has_pose = last.Rcw.copy(), last.tcw.copy(), True
        tr.last_frame = f

    tr._track_impl = frozen


def _wrap_batches(system, change):
    ex = system.extractor
    orig = ex.extract_batch_async

    def wrapped(images, mesh=None):
        return change(orig, list(images))

    ex.extract_batch_async = wrapped


def plant_half(system):
    def change(orig, images):
        half = images[:max(1, len(images) // 2)]
        return orig((half * 2)[:len(images)])

    _wrap_batches(system, change)


class _Altered:
    def __init__(self, handle):
        self.handle = handle

    def result(self):
        feats = self.handle.result()
        for f in feats:
            f.desc_dev = torch.roll(f.desc_dev, 1, 0)
        return feats


def plant_descriptors(system):
    _wrap_batches(system, lambda orig, images: _Altered(orig(images)))


def plant_pose(system):
    track = system.track_monocular
    count = [0]

    def altered(image, timestamp, imu=None):
        frame = track(image, timestamp, imu)
        count[0] += 1
        if count[0] % 2:
            frame.tcw = frame.tcw + np.float32([0.5, 0.0, 0.0])
        return frame

    system.track_monocular = altered


def cpu_run(plant):
    bench = registry.benchmark()
    cell = registry.workload(bench, "tumvi-cruise")
    traffic = registry.traffic(cell["traffic"])
    traffic["frames"].update(setup_max=120, window_fps_cap=3)
    run = harness.Run(cell, registry.config(cell["config"]), traffic, SEED,
                      SECONDS, False, device="cpu", plant=plant)
    return harness.execute(run, bench)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_a_sound_run_is_correct():
    line = cpu_run(None)
    print("sound", {k: round(c["value"], 4) for k, c in line["checks"].items()})
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 5
    assert {"frame_ms", "frame_ms_p90", "setup_s"} <= set(
        line["metrics"])


@pytest.mark.parametrize("plant", [plant_unchanged, plant_half,
                                   plant_descriptors, plant_pose],
                         ids=["unchanged", "half", "descriptors", "pose"])
def test_a_broken_run_is_not_correct(plant):
    line = cpu_run(plant)
    print(plant.__name__, {k: round(c["value"], 4)
                           for k, c in line["checks"].items()})
    assert not line["correct"], line["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@contextlib.contextmanager
def tf32():
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = True
    try:
        yield
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def card_run(seed, plant=None):
    bench = registry.benchmark()
    cell = registry.workload(bench, "tumvi-cruise")
    run = harness.Run(cell, registry.config(cell["config"]),
                      registry.traffic(cell["traffic"]), seed,
                      bench["run_seconds"], False, plant=plant)
    line = harness.execute(run, bench)
    return line["checks"]["track_ate_cm"]["value"], line


@pytest.mark.cuda
def test_the_pose_number_readings_on_the_card(card):
    limits = registry.config("tumvi-512")["limits"]
    for seed in CARD_SEEDS:
        with tf32():
            control, line = card_run(seed)
        print(f"tf32 seed {seed}: {control} correct {line['correct']} "
              f"frames {line['attempted']}", flush=True)
        frozen, line = card_run(seed, plant_unchanged)
        print(f"unchanged seed {seed}: {frozen} correct {line['correct']} "
              f"frames {line['attempted']}", flush=True)
        assert frozen is None or frozen > limits["track_ate_cm"]
