"""The port's loop closing against ppg_slam_tpu's, and the port alone on the
synthetic loop.

* testing.make_loop_sequence against tests/synthetic_sequence.py's.
* A frozen map built in both packages with testing.build_map from the same
  numpy: keyframes every 4 frames around the 168-frame loop, the last ones
  (frames >= 128) displaced by a world yaw of 0.12 rad and a translation,
  and observing their own duplicate map points, as a drifted revisit
  does; 0.5 px of pixel noise keeps the RANSAC and LM decisions away from
  ties. On the last keyframe each package's `_detect_from_bow` must
  pick the same candidates and matched keyframe with the same matched map
  points (n_final), and `_validate_and_correct` (yaw-only gate,
  CorrectLoop, 4-DoF essential graph; the global BA after it is stubbed in
  both, it is held elsewhere) must leave keyframe poses within POSE_TOL and
  points within POINT_TOL of the reference's.
* The port alone tracks the 168-frame loop sequence with an active
  LoopClosing and is held to tests/test_loop_closing.py's four assertions
  and pins.
* tests/test_async.py's TestBackgroundGBA cases on the port.

Measured (CPU): the same candidates, matched KF and 276 matched points;
Rcw within 1e-7, tcw within 1.5e-6 m and points within 2.4e-6 m of the
reference; on the loop run 1 loop, fired on KF 58 of 65, pre/post-loop ATE
0.0238 / 0.0118 m.
"""

import os
import types

import numpy as np
import pytest
import torch

import ppg_slam_tpu.worldmap as jwm
from ppg_slam_tpu.bow import Vocabulary as JVocabulary
from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
from ppg_slam_tpu.geometry import cameras as jcams
from ppg_slam_tpu.pipeline import loop_closing as jlc

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.bow import Vocabulary as PVocabulary
from ppg_slam_tpu_torch.geometry import so3
from ppg_slam_tpu_torch.pipeline import LocalMapping, LoopClosing, Tracking
from ppg_slam_tpu_torch.pipeline import loop_closing as plc
from ppg_slam_tpu_torch.utils.evaluation import ate_rmse

import synthetic_sequence as SS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_PATH = os.path.join(ROOT, "assets", "voc_euroc_9x3.npz")
N_FRAMES = 168
KF_EVERY, REVISIT = 4, 128
DRIFT_YAW, DRIFT_T = 0.12, np.float32([0.15, -0.05, 0.1])
POSE_TOL = 1e-4   # Rcw entries and tcw (m)
POINT_TOL = 1e-4  # m
PINNED_POST_LOOP_ATE_M = 0.012  # tests/test_loop_closing.py's pin

pytestmark = pytest.mark.skipif(not os.path.exists(VOC_PATH),
                                reason="reference vocabulary not available")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's solves are many small ops: under a parallel test run,
    torch's intra-op thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loop_sequence_matches_harness():
    """The same ring scene; poses, velocities and IMU samples within 1e-4
    after 168 frames (so3.exp in f32 on either side)."""
    ref = SS.make_loop_sequence(n_frames=N_FRAMES)
    got = testing.make_loop_sequence(n_frames=N_FRAMES)
    np.testing.assert_array_equal(got.scene.points, ref.scene.points)
    np.testing.assert_array_equal(got.scene.descs, ref.scene.descs)
    assert got.scene.triplets == ref.scene.triplets
    assert got.scene.segments == ref.scene.segments
    np.testing.assert_array_equal(got.frame_times, ref.frame_times)
    np.testing.assert_allclose(got.imu, ref.imu, atol=1e-4)
    for (Rg, tg), (Rr, tr) in zip(got.frame_poses, ref.frame_poses):
        np.testing.assert_allclose(Rg, Rr, atol=1e-4)
        np.testing.assert_allclose(tg, tr, atol=1e-4)
    np.testing.assert_allclose(np.stack(got.frame_vels),
                               np.stack(ref.frame_vels), atol=1e-4)


# ---------------------------------------------------------------------------
# the frozen map, in both packages
# ---------------------------------------------------------------------------

def _frozen_inputs():
    """Keyframe poses, rendered views and points of the frozen loop map."""
    seq = testing.make_loop_sequence(n_frames=N_FRAMES)
    scene = seq.scene
    frames = list(range(0, N_FRAMES, KF_EVERY))
    Rd = so3.exp(np.float32([0.0, 0.0, DRIFT_YAW]))
    points = np.concatenate(
        [scene.points, (scene.points @ Rd.T + DRIFT_T).astype(np.float32)])
    poses, views = [], []
    for f in frames:
        Rcw, tcw = seq.frame_tcw(f)
        feats, ids = scene.render(Rcw, tcw, noise=0.5)
        if f >= REVISIT:  # Twc' = Td Twc, seeing the displaced duplicates
            Rcw, tcw = ((Rcw @ Rd.T).astype(np.float32),
                        (tcw - Rcw @ Rd.T @ DRIFT_T).astype(np.float32))
            ids = ids + scene.n
        poses.append((Rcw, tcw))
        views.append((testing.feature_kwargs(feats), ids))
    n = len(frames)
    no_pert = ([np.eye(3, dtype=np.float32)] * (n - 2),
               [np.zeros(3, np.float32)] * (n - 2),
               np.zeros_like(points))
    times = [seq.frame_times[f] for f in frames]
    return seq, frames, poses, views, points, no_pert, times


def _build_frozen(pkg, voc, inputs):
    seq, frames, poses, views, points, pert, times = inputs
    wm, kfs, mps = testing.build_map(pkg, poses, views, points, pert, times)
    for mp in mps.values():
        mp.compute_distinctive_descriptor()
    wm.vocabulary = voc
    wm.inverted_file = {}
    for kf, f in zip(kfs, frames):
        kf.frame_id = f
        kf.bow_vec, kf.feat_vec = voc.transform(kf.descriptors)
        for word in kf.bow_vec:
            wm.inverted_file.setdefault(word, []).append(kf)
    wm.imu_initialized = wm.inertial_ba1 = True
    return wm, kfs


def _detect_and_correct(lc_module, wm, kfs, **kw):
    lc = lc_module.LoopClosing(wm, active=True, **kw)
    lc.run_global_ba = lambda loop_kf_id: None
    kf = lc.current_kf = kfs[-1]
    candidates = wm.detect_n_best_candidates(kf, 3)
    lc._detect_from_bow(kf, candidates)
    out = dict(candidates=[c.mnId for c in candidates],
               matched=lc.matched_kf.mnId if lc.matched_kf else None,
               matched_mps=[None if m is None else m.mnId
                            for m in lc.loop_matched_mps],
               coincidences=lc.num_coincidences)
    if lc.matched_kf is not None:
        lc._validate_and_correct()
    out["loops"] = lc.n_loops_closed
    live = sorted(wm.all_keyframes(), key=lambda k: k.mnId)
    out["Rcw"] = np.stack([k.Rcw for k in live])
    out["tcw"] = np.stack([k.tcw for k in live])
    mps = sorted(wm.all_map_points(), key=lambda m: m.mnId)
    out["mp_ids"] = [m.mnId for m in mps]
    out["points"] = np.stack([m.pos for m in mps])
    return out


@pytest.fixture(scope="module")
def frozen():
    inputs = _frozen_inputs()
    cam = inputs[0].scene.cam
    cam_kw = {k: getattr(cam, k) for k in
              ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")}
    jax_ns = types.SimpleNamespace(wm=jwm, Features=JFeatures,
                                   cam=jcams.CameraModel(**cam_kw),
                                   Preintegrated=None)
    port_ns = testing.port_namespace("cpu", cam=cam)
    jwm.reset_ids()
    ref = _detect_and_correct(jlc, *_build_frozen(
        jax_ns, JVocabulary.load(VOC_PATH), inputs))
    pwm.reset_ids()
    got = _detect_and_correct(plc, *_build_frozen(
        port_ns, PVocabulary.load(VOC_PATH), inputs), device="cpu")
    return ref, got, inputs


def test_frozen_map_detection_matches_reference(frozen):
    ref, got, _ = frozen
    assert ref["matched"] is not None and ref["coincidences"] == 1
    for key in ("candidates", "matched", "matched_mps", "coincidences"):
        assert got[key] == ref[key], key
    n_final = sum(m is not None for m in got["matched_mps"])
    assert n_final >= 80


def test_frozen_map_correction_matches_reference(frozen):
    ref, got, inputs = frozen
    assert got["loops"] == ref["loops"] == 1
    np.testing.assert_allclose(got["Rcw"], ref["Rcw"], atol=POSE_TOL)
    np.testing.assert_allclose(got["tcw"], ref["tcw"], atol=POSE_TOL)
    assert got["mp_ids"] == ref["mp_ids"]
    np.testing.assert_allclose(got["points"], ref["points"], atol=POINT_TOL)
    # the correction took the revisit back onto the start (yaw-only)
    seq, frames = inputs[0], inputs[1]
    centres = -np.einsum("nji,nj->ni", got["Rcw"], got["tcw"])
    gt = np.stack([seq.frame_poses[f][1] for f in frames])
    assert np.abs(centres - gt)[-4:].max() < 0.02


def test_yaw_gate_thresholds():
    """The gate reads the port's numpy so3.log: rotations just inside and
    just outside each threshold (0.008, 0.008, 0.349 rad) are told apart,
    as the reference's so3.log tells them."""
    from ppg_slam_tpu.geometry import so3 as jso3

    for axis, th in ((0, 0.008), (1, 0.008), (2, 0.349)):
        for angle, inside in ((th * 0.98, True), (th * 1.02, False)):
            w = np.zeros(3, np.float32)
            w[axis] = angle
            R = jso3.exp(w).astype(np.float32)
            phi, phi_ref = so3.log(R), jso3.log(R)
            np.testing.assert_allclose(phi, phi_ref, atol=1e-6)
            ok = (abs(phi[0]) < 0.008 and abs(phi[1]) < 0.008
                  and abs(phi[2]) < 0.349)
            assert ok == inside, (axis, angle, phi)


# ---------------------------------------------------------------------------
# the port alone on the 168-frame loop (tests/test_loop_closing.py)
# ---------------------------------------------------------------------------

def _ate(kf_list, seq):
    est, gt = [], []
    for kf in kf_list:
        if kf.is_bad():
            continue
        est.append(kf.camera_center())
        gt.append(seq.frame_poses[kf.frame_id][1])
    return ate_rmse(np.stack(est), np.stack(gt), with_scale=True)


@pytest.fixture(scope="module")
def loop_run():
    pwm.reset_ids()
    seq = testing.make_loop_sequence(n_frames=N_FRAMES)
    saved = pwm.Map.imu_ini_time
    pwm.Map.imu_ini_time = 2.0
    try:
        wmap = pwm.Map(pwm.Rig(seq.scene.cam, freq=200.0),
                       vocabulary=PVocabulary.load(VOC_PATH))
        tracking = Tracking(wmap, testing.SyntheticExtractor(seq),
                            device="cpu")
        lc = LoopClosing(wmap, active=True, device="cpu")
        lm = LocalMapping(wmap, tracking=tracking, loop_closer=lc,
                          device="cpu")
        tracking.local_mapper = lm
        lc.local_mapper = lm
        pre = {}
        orig_correct = lc.correct_loop

        def hooked():
            pre["ate"] = _ate(list(wmap.keyframes), seq)
            pre["kf_id"] = lc.current_kf.mnId
            orig_correct()

        lc.correct_loop = hooked
        last_t = -1.0
        for i in range(seq.n_frames):
            t = seq.frame_times[i]
            tracking.grab_imu(seq.imu_between(last_t, t))
            last_t = t
            tracking.grab_image(np.zeros((2, 2), np.uint8), t)
    finally:
        pwm.Map.imu_ini_time = saved
    return seq, wmap, tracking, lc, pre


class TestLoopClosing:
    def test_tracks_the_full_circle(self, loop_run):
        seq, wmap, tracking, lc, pre = loop_run
        assert tracking.state == 1, "must be tracking at the end"
        assert wmap.n_keyframes() >= 30
        assert wmap.imu_initialized and wmap.inertial_ba1

    def test_loop_detected_and_closed(self, loop_run):
        seq, wmap, tracking, lc, pre = loop_run
        assert lc.n_loops_closed >= 1, "no loop was closed"
        assert pre["kf_id"] > wmap.max_kf_id * 0.6

    def test_yaw_only_correction_post_imu(self, loop_run):
        seq, wmap, tracking, lc, pre = loop_run
        errs = []
        for kf in wmap.keyframes:
            if kf.is_bad():
                continue
            Rgt = seq.frame_poses[kf.frame_id][0]
            Rd = kf.Rcw @ Rgt
            errs.append(np.degrees(np.arccos(np.clip(Rd[1, 1], -1.0, 1.0))))
        assert np.median(errs) < 2.0, np.median(errs)

    def test_ate_improves_after_loop(self, loop_run):
        seq, wmap, tracking, lc, pre = loop_run
        post = _ate(list(wmap.keyframes), seq)
        assert "ate" in pre, "correct_loop never ran"
        assert post < pre["ate"], (pre["ate"], post)
        assert post < 2.0 * PINNED_POST_LOOP_ATE_M, post


# ---------------------------------------------------------------------------
# the background GBA (tests/test_async.py's TestBackgroundGBA, on the port)
# ---------------------------------------------------------------------------

class TestBackgroundGBA:
    def test_threaded_gba_completes_and_propagates(self):
        wmap, kfs, _ = testing.small_gba_map(seed=21)
        lc = LoopClosing(wmap, active=False, device="cpu")
        lc.threaded_gba = True
        true_pose = (kfs[2].Rcw.copy(), kfs[2].tcw.copy())
        kfs[2].set_pose(kfs[2].Rcw,
                        kfs[2].tcw + np.float32([0.05, 0.0, 0.0]))
        lc.start_gba_thread(loop_kf_id=kfs[-1].mnId)
        applied = lc.poll_gba(wait=True)
        assert applied, "background GBA must finish and apply"
        assert not lc.gba_running and lc.gba_error is None
        err = np.linalg.norm(kfs[2].tcw - true_pose[1])
        assert err < 0.04, f"GBA did not reduce the perturbation: {err}"

    def test_threaded_gba_killed_by_stop(self):
        wmap, kfs, _ = testing.small_gba_map(seed=22)
        lc = LoopClosing(wmap, active=False, device="cpu")
        lc.threaded_gba = True
        poses_before = [k.tcw.copy() for k in kfs]
        lc.start_gba_thread(loop_kf_id=kfs[-1].mnId)
        lc.stop_gba = True  # what a newer CorrectLoop does
        lc._gba_thread.join()
        applied = lc.poll_gba(wait=True)
        assert not applied, "stopped GBA must discard results"
        for k, p in zip(kfs, poses_before):
            np.testing.assert_array_equal(k.tcw, p)

    def test_mid_gba_keyframe_chain_corrected(self):
        """A KF added after GBA started gets corrected through its temporal
        predecessor (reference spanning-tree propagation :1189-1230)."""
        wmap, kfs, scene = testing.small_gba_map(seed=23)
        lc = LoopClosing(wmap, active=False, device="cpu")
        lc._solve_gba(loop_kf_id=kfs[-1].mnId, abort_check=None)
        Rcw, tcw = scene.pose(len(kfs) * 4)
        feats, ids = scene.render(Rcw, tcw)
        frame = pwm.Frame(feats, 0.2 * len(kfs), wmap.rig)
        frame.set_pose(Rcw, tcw)
        new_kf = pwm.KeyFrame(frame, wmap)
        new_kf.prev_kf = kfs[-1]
        kfs[-1].next_kf = new_kf
        wmap.add_keyframe(new_kf)
        R_rel = new_kf.Rcw @ kfs[-1].Rcw.T
        t_rel = new_kf.tcw - R_rel @ kfs[-1].tcw
        lc._apply_gba(loop_kf_id=kfs[-1].mnId)
        R_rel2 = new_kf.Rcw @ kfs[-1].Rcw.T
        t_rel2 = new_kf.tcw - R_rel2 @ kfs[-1].tcw
        np.testing.assert_allclose(R_rel2, R_rel, atol=1e-5)
        np.testing.assert_allclose(t_rel2, t_rel, atol=1e-4)

    def test_failed_gba_thread_is_reported_not_rerun(self, monkeypatch):
        """A GBA thread that raises prints, records the error and sets
        stop_gba: its run is discarded and nothing reruns it."""
        wmap, kfs, _ = testing.small_gba_map(seed=24)
        lc = LoopClosing(wmap, active=False, device="cpu")
        lc.threaded_gba = True
        calls = []

        def boom(*a, **kw):
            calls.append(1)
            raise RuntimeError("solver failed")

        monkeypatch.setattr(plc, "global_bundle_adjustment", boom)
        poses_before = [k.tcw.copy() for k in kfs]
        lc.start_gba_thread(loop_kf_id=kfs[-1].mnId)
        assert not lc.poll_gba(wait=True)
        assert isinstance(lc.gba_error, RuntimeError) and lc.stop_gba
        assert calls == [1]
        for k, p in zip(kfs, poses_before):
            np.testing.assert_array_equal(k.tcw, p)
