"""The slice as a whole: the port's Tracking + LocalMapping (and System)
against ppg_slam_tpu's on the synthetic mono-inertial sequence.

One module fixture runs both pipelines, with the synchronous local mapper,
over N_FRAMES frames of the same SyntheticSequence (seed 3,
Map.imu_ini_time = 2.0): monocular init lands at frame 8, the first IMU
init (with its full_inertial_ba) at frame 41 (t = 2.0 s), and the rest are
pose-inertial frames. Held exactly up to IMU init: the frame of monocular
init, the map-point count after it, the per-frame states and map sizes,
the keyframe timestamps. Within tolerance: the two-view R, t (1e-4), the
IMU-init event's kind and applied flag (equal) and scale (1e-3 relative).
After it: the final keyframe count within 1, each package's KF-trajectory
ATE below 2 x 0.18 m (tests/test_pipeline_e2e.py's pinned ATE), and the two
KF trajectories within KF_RMS_TOL of each other.

Measured (CPU): every per-frame state and map size equal over all 52
frames, 19 keyframes each; two-view R within 2.4e-6 and t within 4.9e-5;
the IMU-init scale 1.95224 against 1.95228 (2.3e-5 relative; outside the
trim band, so both apply the rotation alone); KF trajectories 2.9e-6 m RMS
apart; KF ATE 3.7e-4 m in both.
"""

import os

import numpy as np
import pytest
import torch

import ppg_slam_tpu.pipeline.tracking as jtr
from ppg_slam_tpu.pipeline.local_mapping import LocalMapping as JLocalMapping
from ppg_slam_tpu.worldmap import Map as JMap
from ppg_slam_tpu.worldmap import Rig as JRig

import ppg_slam_tpu_torch.pipeline.tracking as ptr
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.pipeline import LocalMapping as PLocalMapping
from ppg_slam_tpu_torch.utils.evaluation import align_and_ate

from synthetic_sequence import SyntheticExtractor as JExtractor
from synthetic_sequence import SyntheticSequence as JSequence
from synthetic_world import CAM as JCAM

N_FRAMES = 52
IMU_INI_TIME = 2.0
PINNED_ATE_M = 0.180
POSE_TOL = 1e-4
SCALE_RTOL = 1e-3
KF_RMS_TOL = 1e-4  # m
DEVICE_FRAMES = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's solves are many small ops: under a parallel test run,
    torch's intra-op thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_two_view(module, out):
    """Wrap `module.two_view_reconstruct` to record (ok, R21, t21)."""
    fn = module.two_view_reconstruct

    def wrapped(*a):
        res = fn(*a)
        out.append((bool(res.ok), np.asarray(res.R21).astype(np.float64),
                    np.asarray(res.t21).astype(np.float64)))
        return res

    return wrapped


def _run(side, mp, n_frames=N_FRAMES, desc_device=None, threaded=False):
    """Run one package's pipeline; return its per-frame log and objects.
    desc_device: the port's synthetic extractor hands descriptors over on
    that device (desc_transfer="device"), so tracking matches through its
    DeviceMatcher. threaded: local mapping on its consumer thread, paced
    by wait_idle after each frame (tests/test_pipeline_e2e.py's way)."""
    two_view = []
    if side == "jax":
        seq = JSequence(n_frames=n_frames)
        wmap = JMap(JRig(JCAM, freq=200.0))
        mp.setattr(jtr, "two_view_reconstruct",
                   _record_two_view(jtr, two_view))
        tr = jtr.Tracking(wmap, JExtractor(seq))
        lm = JLocalMapping(wmap, tracking=tr)
    else:
        pwm.reset_ids()
        seq = testing.SyntheticSequence(n_frames=n_frames)
        wmap = pwm.Map(pwm.Rig(testing.CAM, freq=200.0))
        mp.setattr(ptr, "two_view_reconstruct",
                   _record_two_view(ptr, two_view))
        tr = ptr.Tracking(wmap, testing.SyntheticExtractor(
            seq, desc_device=desc_device), device="cpu")
        lm = PLocalMapping(wmap, tracking=tr, device="cpu")
    tr.local_mapper = lm
    if threaded:
        lm.start()
    log = []
    last_t = -1.0
    for i in range(n_frames):
        t = seq.frame_times[i]
        tr.grab_imu(seq.imu_between(last_t, t))
        last_t = t
        tr.grab_image(np.zeros((2, 2), np.uint8), t)
        if threaded:
            assert lm.wait_idle(timeout=120.0)
        log.append((tr.state, wmap.n_keyframes(), wmap.n_map_points(),
                    wmap.imu_initialized))
    if threaded:
        lm.stop()
    kfs = sorted(wmap.all_keyframes(), key=lambda k: k.mnId)
    return dict(log=log, tracking=tr, map=wmap, seq=seq, two_view=two_view,
                kf_t=np.array([kf.timestamp for kf in kfs]),
                kf_c=np.stack([kf.camera_center() for kf in kfs]))


@pytest.fixture(scope="module")
def runs():
    saved = (JMap.imu_ini_time, pwm.Map.imu_ini_time)
    JMap.imu_ini_time = pwm.Map.imu_ini_time = IMU_INI_TIME
    try:
        with pytest.MonkeyPatch.context() as mp:
            yield {side: _run(side, mp) for side in ("jax", "port")}
    finally:
        JMap.imu_ini_time, pwm.Map.imu_ini_time = saved


def _imu_init_frame(run):
    return next(i for i, row in enumerate(run["log"]) if row[3])


def test_identical_up_to_imu_init(runs):
    ref, got = runs["jax"], runs["port"]
    k_imu = _imu_init_frame(ref)
    assert _imu_init_frame(got) == k_imu
    assert 30 < k_imu < N_FRAMES - 10  # >= 10 pose-inertial frames after
    # the frame of monocular init, the map after it, every state and map
    # size up to the IMU init
    k_init = next(i for i, row in enumerate(ref["log"]) if row[0] == jtr.OK)
    assert next(i for i, row in enumerate(got["log"])
                if row[0] == ptr.OK) == k_init
    assert got["log"][k_init][2] == ref["log"][k_init][2] > 100
    assert got["log"][:k_imu + 1] == ref["log"][:k_imu + 1]
    t_imu = ref["seq"].frame_times[k_imu]
    np.testing.assert_array_equal(got["kf_t"][got["kf_t"] <= t_imu],
                                  ref["kf_t"][ref["kf_t"] <= t_imu])


def test_two_view_and_imu_init_agree(runs):
    ref, got = runs["jax"], runs["port"]
    assert [ok for ok, _, _ in got["two_view"]] == \
        [ok for ok, _, _ in ref["two_view"]]
    (_, R_r, t_r), (_, R_g, t_g) = ref["two_view"][-1], got["two_view"][-1]
    np.testing.assert_allclose(R_g, R_r, atol=POSE_TOL)
    np.testing.assert_allclose(t_g, t_r, atol=POSE_TOL)
    ev_r = ref["tracking"].init_events
    ev_g = got["tracking"].init_events
    assert [(e["kind"], e["applied"]) for e in ev_g] == \
        [(e["kind"], e["applied"]) for e in ev_r]
    assert ev_g[0]["kind"] == "init"
    for e_g, e_r in zip(ev_g, ev_r):
        assert abs(e_g["scale"] - e_r["scale"]) <= SCALE_RTOL * e_r["scale"]


def _kf_ate(run):
    seq = run["seq"]
    gt = np.stack([seq.frame_poses[int(round(t * seq.fps))][1]
                   for t in run["kf_t"]])
    return align_and_ate(run["kf_c"], gt, with_scale=True).rmse


def test_after_imu_init_within_bounds(runs):
    ref, got = runs["jax"], runs["port"]
    assert got["log"][-1][0] == ptr.OK and ref["log"][-1][0] == jtr.OK
    assert abs(len(got["kf_t"]) - len(ref["kf_t"])) <= 1
    for run in (ref, got):
        assert _kf_ate(run) < 2 * PINNED_ATE_M
    common, i_r, i_g = np.intersect1d(ref["kf_t"], got["kf_t"],
                                      return_indices=True)
    assert len(common) >= len(ref["kf_t"]) - 1
    d = np.linalg.norm(ref["kf_c"][i_r] - got["kf_c"][i_g], axis=1)
    assert np.sqrt(np.mean(d ** 2)) < KF_RMS_TOL, d


@pytest.fixture(scope="module")
def serving_run():
    """The port over the first DEVICE_FRAMES frames with device-resident
    descriptors (tracking's gated matches through DeviceMatcher) and its
    local mapping on the consumer thread (per-phase map locking, paced)."""
    with pytest.MonkeyPatch.context() as mp:
        return _run("port", mp, n_frames=DEVICE_FRAMES, desc_device="cpu",
                    threaded=True)


def test_device_matching_tracks_as_host_matching(runs, serving_run):
    """Device descriptors: the same states and map sizes as the
    host-descriptor run, and gated matches were made."""
    dm = serving_run["tracking"]._dev_matcher
    assert dm is not None and dm.n_dispatches > 10
    assert serving_run["log"] == runs["port"]["log"][:DEVICE_FRAMES]


def test_threaded_mapper_tracks_as_synchronous(runs, serving_run):
    """The threaded mapper: the same states and map sizes as the
    synchronous run, and the worker stopped clean."""
    lm = serving_run["tracking"].local_mapper
    assert lm.worker_error is None and lm._thread is None and lm.idle()
    assert serving_run["log"] == runs["port"]["log"][:DEVICE_FRAMES]


# ---------------------------------------------------------------------------
# System, a few frames, the synthetic extractor swapped in
# ---------------------------------------------------------------------------

SYSTEM_FRAMES = 12
SETTINGS = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 640
Camera.height: 480
Camera.fps: 20
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
IMU.Frequency: 200.0
IMU.IniTime: 2.0
"""


def _system_files(side, out_dir):
    if side == "jax":
        from ppg_slam_tpu.pipeline.system import System

        seq = JSequence(n_frames=SYSTEM_FRAMES)
        kw = {}
    else:
        from ppg_slam_tpu_torch.pipeline import System

        pwm.reset_ids()
        seq = testing.SyntheticSequence(n_frames=SYSTEM_FRAMES)
        kw = {"device": "cpu"}
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    system = System(None, settings, active_loop_closing=False, **kw)
    system.tracking.extractor = (JExtractor(seq) if side == "jax"
                                 else testing.SyntheticExtractor(seq))
    last_t = -1.0
    for i in range(SYSTEM_FRAMES):
        t = seq.frame_times[i]
        system.feed_frame(np.zeros((2, 2), np.uint8))
        system.track_monocular(np.zeros((2, 2), np.uint8), t,
                               seq.imu_between(last_t, t))
        system.poll_background()
        last_t = t
    assert system.state == 1  # OK
    system.shutdown(out_dir)
    return [np.loadtxt(os.path.join(out_dir, name)) for name in
            ("CameraTrajectory.txt", "KeyFrameTrajectory.txt")]


def test_system_writes_the_reference_trajectories(tmp_path):
    saved = (JMap.imu_ini_time, pwm.Map.imu_ini_time)
    try:
        out = {}
        for side in ("jax", "port"):
            (tmp_path / side).mkdir()
            out[side] = _system_files(side, str(tmp_path / side))
    finally:
        JMap.imu_ini_time, pwm.Map.imu_ini_time = saved
    for got, ref in zip(out["port"], out["jax"]):
        assert got.shape == ref.shape and len(got) >= 2
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_system_refuses_what_is_not_ported(tmp_path):
    """System refuses no option: with async_frontend=True and
    use_viewer=True it builds a FramePrefetcher and a Viewer, tracks on
    features that come through the prefetcher in feed order, and the viewer
    writes its PNGs (read back through datasets/png.py)."""
    from ppg_slam_tpu_torch.datasets import read_gray
    from ppg_slam_tpu_torch.frontend.prefetch import FramePrefetcher
    from ppg_slam_tpu_torch.pipeline import System
    from ppg_slam_tpu_torch.viz import Viewer

    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    renders = tmp_path / "renders"
    saved = pwm.Map.imu_ini_time
    try:
        pwm.reset_ids()
        system = System(None, settings, async_frontend=True,
                        use_viewer=True, viewer_out_dir=str(renders),
                        viewer_every=6, active_loop_closing=False,
                        device="cpu")
        assert isinstance(system.prefetcher, FramePrefetcher)
        assert isinstance(system.viewer, Viewer)
        assert system.tracking.viewer is system.viewer
        seq = testing.SyntheticSequence(n_frames=SYSTEM_FRAMES)
        ex = testing.SyntheticExtractor(seq)
        system.prefetcher.ex = ex
        states, last_t, fed = [], -1.0, 0
        for i in range(SYSTEM_FRAMES):
            t = seq.frame_times[i]
            # the CLI's look-ahead: batch x depth frames fed ahead
            while fed < min(i + 1 + 8, SYSTEM_FRAMES):
                system.feed_frame(np.zeros((2, 2), np.uint8))
                fed += 1
            system.track_monocular(np.zeros((2, 2), np.uint8), t,
                                   seq.imu_between(last_t, t))
            last_t = t
            states.append(system.state)
        system.shutdown(str(tmp_path))
    finally:
        pwm.Map.imu_ini_time = saved
    assert states[-1] == ptr.OK, states
    # every frame came through the prefetcher, in batches of 4
    assert system.prefetcher.n_dispatches == SYSTEM_FRAMES // 4
    assert ex.frame_idx == SYSTEM_FRAMES
    pngs = sorted(os.listdir(renders))
    n = SYSTEM_FRAMES // 6
    assert len(pngs) == 2 * n, pngs
    imgs = {name: read_gray(str(renders / name)) for name in pngs}
    assert all(im.dtype == np.uint8 for im in imgs.values())
    last_map = imgs[f"map_{n * 6:06d}.png"]
    assert last_map.shape == (768, 1024) and (last_map != 255).any()


def test_system_defaults_build_active_loop_closing(tmp_path):
    """System's defaults (the reference's: active_loop_closing=True) build
    an active LoopClosing on the System's device."""
    from ppg_slam_tpu_torch.pipeline import LoopClosing, System

    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    saved = pwm.Map.imu_ini_time
    try:
        system = System(None, settings, device="cpu")
    finally:
        pwm.Map.imu_ini_time = saved
    lc = system.loop_closing
    assert isinstance(lc, LoopClosing) and lc.active
    assert lc.device == torch.device("cpu") and not lc.threaded_gba
    assert system.local_mapping.loop_closer is lc


def _track_system(system, seq, frames):
    last_t = seq.frame_times[frames[0] - 1] if frames[0] else -1.0
    states = []
    for i in frames:
        t = seq.frame_times[i]
        system.track_monocular(np.zeros((2, 2), np.uint8), t,
                               seq.imu_between(last_t, t))
        last_t = t
        states.append(system.state)
    return states


def test_system_threaded_gba_tracks(tmp_path):
    """threaded_gba=True: the closer's GBA goes to its thread, local
    mapping polls for aborts, and the System tracks."""
    from ppg_slam_tpu_torch.pipeline import System

    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    saved = pwm.Map.imu_ini_time
    try:
        pwm.reset_ids()
        system = System(None, settings, threaded_gba=True, device="cpu")
        assert system.loop_closing.threaded_gba
        assert system.local_mapping.threaded
        seq = testing.SyntheticSequence(n_frames=SYSTEM_FRAMES)
        system.tracking.extractor = testing.SyntheticExtractor(seq)
        states = _track_system(system, seq, range(SYSTEM_FRAMES))
        system.shutdown(str(tmp_path))
    finally:
        pwm.Map.imu_ini_time = saved
    assert states[-1] == ptr.OK


RESUME_FRAMES, RESUME_TAIL = 48, 16


def test_system_saves_and_resumes_a_map(tmp_path):
    """shutdown(save_map_path=) writes the map; System(load_map_path=)
    loads it, starts LOST and relocalizes into it on the tail of the same
    sequence (the vocabulary re-indexes the loaded keyframes)."""
    from ppg_slam_tpu_torch.pipeline import System

    voc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "voc_euroc_9x3.npz")
    if not os.path.exists(voc):
        pytest.skip("vocabulary asset not available")
    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    path = str(tmp_path / "run.ppgmap")
    saved = pwm.Map.imu_ini_time
    try:
        pwm.reset_ids()
        seq = testing.SyntheticSequence(n_frames=RESUME_FRAMES)
        first = System(voc, settings, device="cpu")
        first.tracking.extractor = testing.SyntheticExtractor(seq)
        _track_system(first, seq, range(RESUME_FRAMES))
        first.shutdown(str(tmp_path), save_map_path=path)
        n_kf = first.map.n_keyframes()
        assert n_kf > 10

        second = System(voc, settings, load_map_path=path, device="cpu")
        assert second.state == ptr.LOST
        assert second.map.n_keyframes() == n_kf
        start = RESUME_FRAMES - RESUME_TAIL
        ex = testing.SyntheticExtractor(seq)
        ex.frame_idx = start
        second.tracking.extractor = ex
        states = _track_system(second, seq, range(start, RESUME_FRAMES))
    finally:
        pwm.Map.imu_ini_time = saved
    assert second.tracking.n_resets == 0
    assert states[-1] == ptr.OK, states


def test_pipeline_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from ppg_slam_tpu_torch.pipeline import System

    settings = str(tmp_path / "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS)
    wmap = pwm.Map(pwm.Rig(testing.CAM))
    from ppg_slam_tpu_torch.pipeline import LoopClosing

    for call in (lambda: ptr.Tracking(wmap, None),
                 lambda: PLocalMapping(wmap),
                 lambda: LoopClosing(wmap),
                 lambda: System(None, settings)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
