"""The control of the front-end's numbers: the plain nets computed in int8
(the precision below the bf16 the configuration serves them in), put in the
program's place on twelve frames of the stretch a window tracks, drawn from
the seed, fail the front-end's limits. On the card at the cell's own size,
on three seeds, each seed's readings printed; on the CPU on two frames of
one seed. The pose numbers' readings are in test_faults.py."""

import numpy as np
import pytest
import torch

from slam_bench import registry, render
from slam_bench.reference import frontend as ref

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
FIRST = 64  # about where a window starts (after the set-up's frames)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def readings(config: str, seed: int, device: str, n_frames: int) -> dict:
    """The control's front-end numbers over n_frames window frames drawn
    from the seed (pooled), and the limits of the configuration."""
    cfg = registry.config(config)
    s = cfg["settings"]
    cam = render.camera(s)
    scene = render.Scene(registry.traffic("cruise")["scene_seed"],
                         FIRST + 40, 0.1,
                         float(cfg["render"]["reach_m"]), device)
    canvas = render.fisheye_canvas(cam) if cam.kind == "kb8" else None
    r = render.Renderer(scene, cam, seed, canvas)
    m = render.Motion(seed, registry.traffic("cruise")["motion"],
                      np.asarray(s["IMU.T_b_c1"], np.float32), cam.fps,
                      s["IMU.Frequency"], s["IMU.NoiseGyro"],
                      s["IMU.NoiseAcc"])
    ks = np.sort(np.random.RandomState(seed % 2 ** 32).choice(
        np.arange(FIRST, FIRST + 40), n_frames, replace=False))
    m.advance(int(ks[-1]) + 1)
    frames = r.render([(int(k), *m.camera_pose(int(k))) for k in ks])
    w = ref.load_weights(registry.ROOT + "/" + cfg["assets"]["weights"],
                         device)
    f32, i8 = ref.Nets(w), ref.Nets(w, int8=True)
    if cam.kind == "pinhole":
        def undistort(xy):
            return render.radtan_undistort(xy.astype(np.float32), cam)
    else:
        def undistort(xy):
            return xy.astype(np.float32)
    got, same = [], []
    for img in frames:
        a, b = f32.forward(img), i8.forward(img)
        xy = ref.greedy_nms(a["junc"].cpu().numpy())
        got.append(ref.compare(a, xy, undistort(xy),
                               *ref.control_side(b, undistort)))
        same.append(ref.compare(a, xy, undistort(xy),
                                *ref.control_side(a, undistort)))
    assert ref.pooled(same) == dict(kp_miss=0.0, score_gap=0.0, desc_gap=0.0)
    control = ref.pooled(got)
    return dict(control=control, limits={k: cfg["limits"][k] for k in control})


def fails(r: dict) -> bool:
    return any(v > r["limits"][k] for k, v in r["control"].items())


def test_the_control_fails_on_the_cpu():
    r = readings("tumvi-512", SEEDS[0], "cpu", 2)
    assert fails(r), r


@pytest.mark.cuda
def test_the_control_fails_on_the_card(card):
    for seed in SEEDS:
        r = readings("tumvi-512", seed, card, 12)
        print(f"control tumvi-512 seed {seed}: {r['control']} limits "
              f"{r['limits']}")
        assert fails(r), r
