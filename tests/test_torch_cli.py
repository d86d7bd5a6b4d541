"""The port's mono_inertial CLI end to end on the CPU, against the JAX CLI.

tests/test_cli_e2e.py's 12-frame synthetic EuRoC folder (640x480 wireframe
renders, a gravity-only 200 Hz IMU, visual-only settings) goes through
`ppg_slam_tpu_torch.cli.mono_inertial.run(..., device="cpu")` with the
EuRoC vocabulary and offline renders. Held:
- test_cli_e2e's four checks (frames, keyframes, map points; TUM files;
  renders; profiler stages);
- the JAX CLI on the same folder: the same per-frame states and keyframe
  count, the camera trajectories within TRAJ_TOL_M of each other;
- --async-frontend on and off: identical trajectory files;
- --save-map, then --load-map on a rendered corridor's tail from one of
  its keyframes on: tracking starts LOST and relocalizes, near the truth.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_cli_e2e import YAML, dataset_dir  # noqa: F401  (12-frame folder)

import ppg_slam_tpu.pipeline.system as jsystem
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch.datasets import read_gray
from ppg_slam_tpu_torch.pipeline.tracking import LOST, OK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(ROOT, "assets", "voc_euroc_9x3.npz")
N_FRAMES = 12
# camera-trajectory rows, port against JAX: the extractors agree to 1e-4 px
# and 1e-5 in descriptors (tests/test_torch_extractor.py); measured 2.9e-5 m
TRAJ_TOL_M = 1e-4


@pytest.fixture(scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_run(folder, out, **kw):
    from ppg_slam_tpu_torch.cli.mono_inertial import run

    pwm.reset_ids()
    os.makedirs(out, exist_ok=True)
    return run("euroc", VOC, os.path.join(folder, "settings.yaml"), "",
               folder, out_dir=out, progress_every=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_run(dataset_dir, tmp_path_factory, two_threads):  # noqa: F811
    out = tmp_path_factory.mktemp("port")
    stats = _port_run(str(dataset_dir), str(out),
                      render_dir=str(out / "renders"), render_every=6)
    return stats, out


@pytest.fixture(scope="module")
def jax_run(dataset_dir, tmp_path_factory):  # noqa: F811
    from ppg_slam_tpu.cli.mono_inertial import run

    out = tmp_path_factory.mktemp("jax")
    states = []
    track = jsystem.System.track_monocular

    def tracked(self, *a, **kw):
        res = track(self, *a, **kw)
        states.append(self.state)
        return res

    jsystem.System.track_monocular = tracked
    try:
        stats = run("euroc", VOC, str(dataset_dir / "settings.yaml"), "",
                    str(dataset_dir), out_dir=str(out), progress_every=0)
    finally:
        jsystem.System.track_monocular = track
    return stats, states, out


def test_all_frames_tracked(port_run):
    stats, _ = port_run
    assert stats["frames"] == N_FRAMES
    assert stats["keyframes"] >= 2
    assert stats["map_points"] > 40
    assert stats["device"] == "cpu" and stats["states"][-1] == OK


def test_trajectories_written(port_run):
    _, out = port_run
    cam_tr = (out / "CameraTrajectory.txt").read_text().strip()
    kf_tr = (out / "KeyFrameTrajectory.txt").read_text().strip()
    assert len(cam_tr.splitlines()) >= 10
    assert len(kf_tr.splitlines()) >= 2
    assert len(cam_tr.splitlines()[0].split()) == 8  # t x y z qx qy qz qw


def test_renders_written(port_run):
    _, out = port_run
    pngs = sorted(p for p in os.listdir(out / "renders")
                  if p.endswith(".png"))
    assert pngs == ["frame_000006.png", "frame_000012.png",
                    "map_000006.png", "map_000012.png"]
    assert read_gray(str(out / "renders" / "map_000012.png")).shape == (
        768, 1024)


def test_profiler_stages_reported(port_run):
    stats, _ = port_run
    assert stats["stages"]["tracking.extract"]["count"] == N_FRAMES


def test_cli_equals_reference(port_run, jax_run):
    stats, out = port_run
    jstats, jstates, jout = jax_run
    assert stats["states"] == jstates
    assert stats["keyframes"] == jstats["keyframes"]
    got, ref = (np.loadtxt(str(d / "CameraTrajectory.txt"))
                for d in (out, jout))
    assert got.shape == ref.shape and len(got) >= 10
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    err = np.linalg.norm(got[:, 1:4] - ref[:, 1:4], axis=1)
    assert err.max() < TRAJ_TOL_M, err.max()


def test_async_frontend_tracks_identically(port_run, dataset_dir,  # noqa: F811
                                           tmp_path):
    _, out = port_run
    stats = _port_run(str(dataset_dir), str(tmp_path), async_frontend=True)
    assert stats["frames"] == N_FRAMES
    assert "tracking.extract" not in stats["stages"]  # prefetched instead
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        assert (tmp_path / name).read_text() == (out / name).read_text()


RELOC_FRAMES, RELOC_TAIL = 36, 8


def test_load_map_relocalizes(tmp_path, two_threads):
    """A 240x160 render of the corridor (testing.render_corridor, 36
    frames, visual-only settings: 15 keyframes, where relocalization needs
    more than 10) through the CLI with --save-map, then --load-map on
    RELOC_TAIL frames from its fourth keyframe on: the resumed run starts
    LOST and relocalizes on its first frame, at a centre that lies nearer
    the truth (after the first run's Sim3 alignment) than the first run's
    ATE RMSE (measured 0.022 m against 0.045 m)."""
    from ppg_slam_tpu_torch import testing
    from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel
    from ppg_slam_tpu_torch.utils.evaluation import (associate, load_tum,
                                                     umeyama)

    cam = CameraModel(kind=CAM_PINHOLE, fx=155.94, fy=155.48, cx=124.85,
                      cy=84.45, dist=(0.0, 0.0, 0.0, 0.0), width=240,
                      height=160)
    corridor = testing.render_corridor(n_frames=RELOC_FRAMES, seed=7,
                                       cam=cam)
    folder = str(tmp_path / "corridor")
    gt = testing.write_asl_folder(corridor, folder)
    with open(os.path.join(folder, "settings.yaml"), "w") as f:
        f.write(YAML.format(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                            w=cam.width, h=cam.height))
    first = _port_run(folder, str(tmp_path / "out"), eval_gt=gt,
                      save_map=str(tmp_path / "run.ppgmap"))
    assert first["states"][-1] == OK and first["keyframes"] > 10
    kf_t = np.loadtxt(str(tmp_path / "out" / "KeyFrameTrajectory.txt"))[:, 0]
    k0 = int(round((kf_t[3] - 1.0) * corridor.fps))
    tail = str(tmp_path / "tail")
    testing.write_asl_folder(corridor, tail,
                             frames=range(k0, k0 + RELOC_TAIL))
    shutil.copy(os.path.join(folder, "settings.yaml"), tail)
    stats = _port_run(tail, str(tmp_path / "out2"),
                      load_map=str(tmp_path / "run.ppgmap"))
    assert stats["state_events"][0]["to_state"] == LOST
    assert stats["states"] == [OK] * RELOC_TAIL, stats["states"]
    te, pe = load_tum(str(tmp_path / "out" / "CameraTrajectory.txt"))
    tg, pg = load_tum(gt)
    ie, ig = associate(te, tg)
    s, R, t = umeyama(pe[ie], pg[ig])
    tr, pr = load_tum(str(tmp_path / "out2" / "CameraTrajectory.txt"))
    j = int(np.argmin(np.abs(tg - tr[0])))
    assert abs(tg[j] - tr[0]) < 1e-6
    err = np.linalg.norm(s * R @ pr[0] + t - pg[j])
    assert err < first["ate_rmse"], (err, first["ate_rmse"])
