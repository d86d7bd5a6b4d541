"""The port's map checkpoints (worldmap/serialize.py), after
tests/test_serialize.py.

The map is tracked by the port on the CPU over a synthetic sequence in the
serving configuration (device-resident descriptors, here CPU tensors; the
keyframes keep host copies): the file holds host data only, and a map
saved on one device loads on another. A map file written by the JAX
package carries the same header and is refused with ValueError by the
port's restricted unpickler, in an interpreter where jax and ppg_slam_tpu
cannot be imported.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import ppg_slam_tpu.worldmap as jwm
from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
from ppg_slam_tpu.geometry import cameras as jcams

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.bow import Vocabulary
from ppg_slam_tpu_torch.pipeline import LocalMapping, Tracking
from ppg_slam_tpu_torch.pipeline.tracking import LOST, OK
from ppg_slam_tpu_torch.worldmap import load_map, save_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_PATH = os.path.join(ROOT, "assets", "voc_euroc_9x3.npz")
N_FRAMES = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _track(wmap, extractor, seq, frames, tracking=None):
    if tracking is None:
        tracking = Tracking(wmap, extractor, device="cpu")
        tracking.local_mapper = LocalMapping(wmap, tracking=tracking,
                                             device="cpu")
    last_t = seq.frame_times[frames[0] - 1] if frames[0] else -1.0
    states = []
    for i in frames:
        t = seq.frame_times[i]
        tracking.grab_imu(seq.imu_between(last_t, t))
        last_t = t
        tracking.grab_image(np.zeros((2, 2), np.uint8), t)
        states.append(tracking.state)
    return tracking, states


@pytest.fixture(scope="module")
def tracked():
    """(map, sequence): the port's tracked map of N_FRAMES frames."""
    pwm.reset_ids()
    saved = pwm.Map.imu_ini_time
    pwm.Map.imu_ini_time = 2.0
    try:
        seq = testing.SyntheticSequence(n_frames=N_FRAMES)
        wmap = pwm.Map(pwm.Rig(testing.CAM, freq=200.0))
        _track(wmap, testing.SyntheticExtractor(seq, desc_device="cpu"),
               seq, range(N_FRAMES))
    finally:
        pwm.Map.imu_ini_time = saved
    assert wmap.n_keyframes() >= 10 and wmap.imu_initialized
    return wmap, seq


def test_save_load_round_trip(tracked, tmp_path):
    src, _ = tracked
    path = str(tmp_path / "m.ppgmap")
    save_map(src, path)
    loaded = load_map(path, device="cpu")

    assert len(loaded.keyframes) == len(src.keyframes)
    assert len(loaded.map_points) == len(src.map_points)
    assert len(loaded.map_edges) == len(src.map_edges)
    assert len(loaded.map_colines) == len(src.map_colines)
    assert [k.mnId for k in loaded.keyframes] == \
        [k.mnId for k in src.keyframes]
    assert [m.mnId for m in loaded.map_points] == \
        [m.mnId for m in src.map_points]
    by_id = {kf.mnId: kf for kf in src.keyframes}
    for kf in loaded.keyframes:
        ref = by_id[kf.mnId]
        np.testing.assert_array_equal(kf.Rcw, ref.Rcw)
        np.testing.assert_array_equal(kf.tcw, ref.tcw)
        np.testing.assert_array_equal(kf.descriptors, ref.descriptors)
        if kf.preintegrated is not None:
            assert kf.preintegrated.device == torch.device("cpu")
        for mp in kf.get_map_point_matches():
            if mp is not None and not mp.bad:
                assert mp in loaded.map_points
    for mp, ref in zip(loaded.map_points, src.map_points):
        np.testing.assert_array_equal(mp.pos, ref.pos)
    kf0 = max(loaded.keyframes,
              key=lambda k: len(k.get_map_point_matches()))
    assert (len(kf0.get_connected_keyframes())
            == len(by_id[kf0.mnId].get_connected_keyframes()))
    ids = {mp.mnId for mp in loaded.map_points}
    new_mp = pwm.MapPoint(np.zeros(3, np.float32),
                          next(iter(loaded.keyframes)))
    assert new_mp.mnId not in ids
    # the loaded copy is independent of the original
    n0 = len(src.map_points)
    loaded.erase_map_point(next(iter(loaded.map_points)))
    assert len(src.map_points) == n0


def test_file_holds_host_data_only(tracked, tmp_path):
    """No torch class in the pickle (the preintegration's device goes as a
    placeholder), and a map that reaches a tensor is not saved."""
    import pickletools

    path = tmp_path / "m.ppgmap"
    save_map(tracked[0], str(path))
    payload = path.read_bytes()[len(b"PPGTPUMAP") + 2:]
    names = []
    for op, arg, _ in pickletools.genops(payload):
        if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "UNICODE"):
            names.append(arg)
    assert not any(n == "torch" or n.startswith("torch.") for n in names)
    kf = next(iter(tracked[0].keyframes))
    saved, kf.gba_tcw = kf.gba_tcw, torch.zeros(3)
    try:
        with pytest.raises(TypeError, match="host data only"):
            save_map(tracked[0], str(path))
    finally:
        kf.gba_tcw = saved


def test_load_rejects_garbage(tracked, tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"NOTAMAP00")
    with pytest.raises(ValueError):
        load_map(str(junk), device="cpu")
    good = tmp_path / "m.ppgmap"
    save_map(tracked[0], str(good))
    cut = tmp_path / "cut.ppgmap"
    cut.write_bytes(good.read_bytes()[:4000])
    with pytest.raises(ValueError):
        load_map(str(cut), device="cpu")
    evil = tmp_path / "evil.ppgmap"
    evil.write_bytes(b"PPGTPUMAP" + (1).to_bytes(2, "little")
                     + pickle.dumps(os.system))
    with pytest.raises(ValueError, match="not part of"):
        load_map(str(evil), device="cpu")


def test_jax_written_map_is_refused_without_importing_jax(tmp_path):
    cam_kw = {k: getattr(testing.CAM, k) for k in
              ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")}
    jax_ns = types.SimpleNamespace(wm=jwm, Features=JFeatures,
                                   cam=jcams.CameraModel(**cam_kw),
                                   Preintegrated=None)
    scene = testing.SyntheticScene(seed=13)
    poses = [scene.pose(k * 4) for k in range(3)]
    pert = testing.perturbation(3, scene.n)
    wmap, _, _ = testing.build_map(jax_ns, poses,
                                   testing.render_views(scene, poses),
                                   scene.points, pert, [0.0, 0.2, 0.4])
    path = str(tmp_path / "jax.ppgmap")
    jwm.save_map(wmap, path)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["ppg_slam_tpu"] = None
        from ppg_slam_tpu_torch.worldmap import load_map
        try:
            load_map({path!r}, device="cpu")
        except ValueError as e:
            assert "ppg_slam_tpu.worldmap" in str(e), e
            assert not any(m.split(".")[0] in ("jax", "ppg_slam_tpu")
                           for m, v in sys.modules.items() if v is not None)
            print("refused")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "refused", proc.stdout


def test_resume_from_map_relocalizes(tracked, tmp_path):
    """Checkpoint/resume (tests/test_serialize.py's): load a saved map with
    a vocabulary (the BoW inverted file is re-indexed on load although the
    map was built without one), start LOST, relocalize into the loaded map
    and keep tracking without a reset."""
    if not os.path.exists(VOC_PATH):
        pytest.skip("vocabulary asset not available")
    src, seq = tracked
    path = str(tmp_path / "resume.ppgmap")
    save_map(src, path)
    wmap = load_map(path, vocabulary=Vocabulary.load(VOC_PATH),
                    rig=pwm.Rig(testing.CAM, freq=200.0), device="cpu")
    assert wmap.inverted_file, "BoW re-index on load must populate it"
    start = seq.n_frames - 20
    ex = testing.SyntheticExtractor(seq)
    ex.frame_idx = start
    tracking = Tracking(wmap, ex, device="cpu")
    tracking.local_mapper = LocalMapping(wmap, tracking=tracking,
                                         device="cpu")
    tracking.resume_from_map()
    assert tracking.state == LOST
    n_kf0 = wmap.n_keyframes()
    _, states = _track(wmap, ex, seq, range(start, seq.n_frames), tracking)
    assert tracking.n_resets == 0, "resume must never reset the loaded map"
    assert states[-1] == OK, states
    assert wmap.n_keyframes() >= n_kf0
