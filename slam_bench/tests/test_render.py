"""The benchmark's renderer against the program's own fixture renderer
(ppg_slam_tpu_torch/testing.py render_corridor, distort_frames,
fisheye_canvas) at a small size on the CPU: the same truth and IMU rows, and
images within a grey level."""

import numpy as np
import pytest
import torch

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.geometry.cameras import (CAM_FISHEYE, CAM_PINHOLE,
                                                 CameraModel)
from slam_bench import registry, render

N_FRAMES = 6
SEED = 2 ** 31 + 9  # seeds past 32 signed bits must work
TBC = np.asarray(registry.config("tumvi-512")["settings"]["IMU.T_b_c1"],
                 np.float32)
MOTION = registry.traffic("cruise")["motion"]
PINHOLE = dict(fx=120.0, fy=118.0, cx=80.5, cy=60.2, width=160, height=120)
RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
KB8 = dict(fx=48.0, fy=47.9, cx=63.7, cy=64.2, width=128, height=128)
KB8_DIST = (0.003482389402, 0.000715034845, -0.002053236141, 0.000202936736)


def settings(kind, dims, dist):
    s = {"Camera.type": "KannalaBrandt8" if kind == "kb8" else "PinHole",
         "Camera.fps": 20.0}
    s.update({"Camera." + k: v for k, v in dims.items()})
    keys = ("k1", "k2", "k3", "k4") if kind == "kb8" else ("k1", "k2", "p1",
                                                           "p2")
    s.update({"Camera." + k: v for k, v in zip(keys, dist)})
    return s


def reference_noise(shape):
    rng = np.random.RandomState(SEED % 2 ** 32 + 100)
    return [rng.randint(-8, 8, shape) for _ in range(N_FRAMES)]


class WithNoise(render.Renderer):
    """The renderer with the fixture's image noise in place of its own."""

    def __init__(self, *a, noise, **kw):
        super().__init__(*a, **kw)
        self.ref_noise = noise

    def _noise(self, k, shape):
        return torch.from_numpy(self.ref_noise[k]).double()


def motion(n=N_FRAMES, seed=SEED):
    m = render.Motion(seed, MOTION, TBC, 20.0, 200.0,
                      testing.CORRIDOR_NOISE_GYRO, testing.CORRIDOR_NOISE_ACC)
    m.advance(n)
    return m


def assert_images_close(mine, ref):
    d = np.abs(np.asarray(mine, np.int64) - np.asarray(ref, np.int64))
    # rounding ties of the anti-aliased edges may land one grey level apart
    assert d.max() <= 1
    assert (d > 0).mean() < 1e-3


def test_truth_and_imu_rows_match_the_fixture():
    ref = testing.render_corridor(n_frames=N_FRAMES, seed=SEED % 2 ** 32,
                                  cam=testing.CAM, Tbc=TBC)
    m = motion()
    np.testing.assert_allclose(m.imu_rows(), ref.imu, rtol=0, atol=1e-5)
    for k in range(N_FRAMES):
        R, t = m.camera_pose(k)
        np.testing.assert_allclose(R, ref.cam_poses[k][0], atol=1e-6)
        np.testing.assert_allclose(t, ref.cam_poses[k][1], atol=1e-6)
        np.testing.assert_allclose(m.body[k][2], ref.body_vels[k], atol=1e-6)


@pytest.mark.parametrize("distorted", [False, True])
def test_pinhole_and_radtan_frames_match_the_fixture(distorted):
    cam = CameraModel(kind=CAM_PINHOLE, dist=RADTAN if distorted else
                      (0.0,) * 4, **PINHOLE)
    ref = testing.render_corridor(n_frames=N_FRAMES, seed=SEED % 2 ** 32,
                                  cam=cam, Tbc=TBC)
    frames = (testing.distort_frames(ref.frames, cam) if distorted
              else ref.frames)
    mine_cam = render.camera(settings("pinhole", PINHOLE,
                                      RADTAN if distorted else (0.0,) * 4))
    scene = render.Scene(SEED, N_FRAMES, MOTION["speed_m_per_frame"], 0.0,
                         "cpu")
    r = WithNoise(scene, mine_cam, SEED, noise=reference_noise(
        (cam.height, cam.width)))
    m = motion()
    out = r.render([(k, *m.camera_pose(k)) for k in range(N_FRAMES)])
    assert out.dtype == torch.uint8
    for k in range(N_FRAMES):
        assert_images_close(out[k].numpy(), frames[k])


def test_kannala_brandt_frames_match_the_fixture():
    cam = CameraModel(kind=CAM_FISHEYE, dist=KB8_DIST, **KB8)
    canvas = testing.fisheye_canvas(cam)
    mine_cam = render.camera(settings("kb8", KB8, KB8_DIST))
    mine_canvas = render.fisheye_canvas(mine_cam)
    assert (mine_canvas.width, mine_canvas.height) == (canvas.width,
                                                       canvas.height)
    assert mine_canvas.fx == pytest.approx(canvas.fx)
    ref = testing.render_corridor(n_frames=N_FRAMES, seed=SEED % 2 ** 32,
                                  cam=canvas, Tbc=TBC, reach=3.0)
    frames = testing.distort_frames(ref.frames, cam, canvas=canvas)
    scene = render.Scene(SEED, N_FRAMES, MOTION["speed_m_per_frame"], 3.0,
                         "cpu")
    r = WithNoise(scene, mine_cam, SEED, canvas=mine_canvas,
                  noise=reference_noise((canvas.height, canvas.width)))
    m = motion()
    out = r.render([(k, *m.camera_pose(k)) for k in range(N_FRAMES)])
    for k in range(N_FRAMES):
        assert_images_close(out[k].numpy(), frames[k])


def test_noise_is_the_same_however_frames_are_batched():
    cam = render.camera(settings("pinhole", PINHOLE, (0.0,) * 4))
    scene = render.Scene(SEED, 4, 0.1, 0.0, "cpu")
    r = render.Renderer(scene, cam, SEED)
    m = motion(4)
    poses = [(k, *m.camera_pose(k)) for k in range(4)]
    together = r.render(poses)
    apart = torch.cat([r.render(poses[:1]), r.render(poses[1:])])
    assert torch.equal(together, apart)
    other = render.Renderer(scene, cam, SEED + 1).render(poses)
    assert not torch.equal(together, other)


def test_frames_differ_by_seed_and_scene_covers_the_run():
    a = render.Scene(1, 100, 0.1, 0.0, "cpu")
    b = render.Scene(2, 100, 0.1, 0.0, "cpu")
    assert not torch.equal(a.seg_p[:10], b.seg_p[:10])
    assert float(a.seg_q[:, 0].max()) > 0.1 * 100
