"""Loop closing through a Kannala-Brandt camera: the port against
ppg_slam_tpu's on the CPU.

The reference builds the Sim3 RANSAC's and OptimizeSim3's observations
from kp_un, while CameraModel.project of a fisheye applies the KB8
distortion: a distorted projection is compared with an undistorted pixel,
and only points near the axis can pass the 9.21 px^2 test. The port takes
kf.kp (the pixels project() returns; equal to kp_un on a pinhole), as its
tracking has since its pose solves were repaired.

* (a) tests/test_torch_loop_closing.py's frozen map, built through
  configs/tumvi.yaml's KB8 camera (512x512) in both packages: a shim sets
  each reference keyframe's kp_un to its kp before detection, the port's
  repair applied to the reference's inputs. Held exactly: the candidates,
  the matched keyframe and the matched map points; within POSE_TOL and
  POINT_TOL: keyframe poses and points after _validate_and_correct.
* (b) the same map without the shim: the reference keeps under a third
  of the port's Sim3 inliers and corrects the revisit several times worse.
* The 4-DoF essential graph with tumvi.yaml's T_b_c1: the graph's
  vertices are body poses and the reference gives them the cameras'
  relative poses as measurements; with the camera off the body's axes no
  edge holds at the current poses and the reference turns the whole map
  in yaw, where the port (body measurements Tbc Tij Tcb) keeps the start
  in place and takes the revisit back onto it.
* (c) Sim3Solver and optimize_sim3 on a KB8 testing.sim3_pair with the
  same distorted observations in both packages: the same hypotheses and
  inlier sets, R, t, s within SIM3_TOL.
* (d) the fisheye fixture: testing.make_loop_sequence(cam=KB8) fills
  kp_pos_un within the KB8 undistortion bound of each package's
  undistort_points, and the pinhole default renders as
  tests/synthetic_sequence.py's harness does, bit for bit.

Measured (CPU): see the constants and each test's docstring.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ppg_slam_tpu.worldmap as jwm
from ppg_slam_tpu.bow import Vocabulary as JVocabulary
from ppg_slam_tpu.estimator import pose_graph as jpg
from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
from ppg_slam_tpu.geometry import cameras as jcams
from ppg_slam_tpu.matching import Sim3Solver as JSolver
from ppg_slam_tpu.pipeline import loop_closing as jlc

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.bow import Vocabulary as PVocabulary
from ppg_slam_tpu_torch.estimator import pose_graph as ppg
from ppg_slam_tpu_torch.geometry import so3
from ppg_slam_tpu_torch.matching import Sim3Solver
from ppg_slam_tpu_torch.pipeline import loop_closing as plc
from ppg_slam_tpu_torch.pipeline.system import (camera_from_settings,
                                                load_settings)

import synthetic_sequence as SS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_PATH = os.path.join(ROOT, "assets", "voc_tum_9x3.npz")
SETTINGS = load_settings(os.path.join(ROOT, "configs", "tumvi.yaml"))
CAM = camera_from_settings(SETTINGS)   # KB8, 512x512, as shipped
TBC = np.asarray(SETTINGS["Tbc"], np.float32)
N_FRAMES = 168
KF_EVERY, REVISIT = 4, 128
DRIFT_YAW, DRIFT_T = 0.12, np.float32([0.15, -0.05, 0.1])
POSE_TOL = 1e-4   # Rcw entries and tcw (m)
POINT_TOL = 1e-4  # m
SIM3_TOL = 1e-5   # optimize_sim3's R, t, s
UNDISTORT_ATOL_PX = 2e-2  # the KB8 bound of tests/test_torch_distorted.py

pytestmark = pytest.mark.skipif(not os.path.exists(VOC_PATH),
                                reason="TUM vocabulary not available")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: under a parallel test run torch's intra-op thread
    pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam_kw(cam):
    return {k: getattr(cam, k) for k in
            ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")}


JCAM = jcams.CameraModel(**_cam_kw(CAM))


# ---------------------------------------------------------------------------
# the frozen fisheye loop map, in both packages
# ---------------------------------------------------------------------------

def _frozen_inputs():
    """Keyframe poses, views and points of tests/test_torch_loop_closing.py's
    frozen map, rendered through the KB8 camera."""
    seq = testing.make_loop_sequence(n_frames=N_FRAMES, cam=CAM)
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
               [np.zeros(3, np.float32)] * (n - 2), np.zeros_like(points))
    return seq, frames, poses, views, points, no_pert


def _build(pkg, voc, inputs, Tbc=None, kp_shim=False):
    seq, frames, poses, views, points, pert = inputs
    times = [seq.frame_times[f] for f in frames]
    wm, kfs, mps = testing.build_map(pkg, poses, views, points, pert, times,
                                     Tbc=Tbc)
    for mp in mps.values():
        mp.compute_distinctive_descriptor()
    wm.vocabulary = voc
    wm.inverted_file = {}
    for kf, f in zip(kfs, frames):
        kf.frame_id = f
        kf.bow_vec, kf.feat_vec = voc.transform(kf.descriptors)
        for word in kf.bow_vec:
            wm.inverted_file.setdefault(word, []).append(kf)
        if kp_shim:  # the port's repair, applied to the reference's inputs
            kf.kp_un = kf.kp
    wm.imu_initialized = wm.inertial_ba1 = True
    return wm, kfs


def _detect_and_correct(lc_module, wm, kfs, **kw):
    """The last keyframe through _detect_from_bow, then (where a keyframe
    matched) _validate_and_correct with the global BA after it stubbed;
    the Sim3 RANSAC's best inlier count of each candidate is recorded."""
    lc = lc_module.LoopClosing(wm, active=True, **kw)
    lc.run_global_ba = lambda loop_kf_id: None
    ransac = []
    solver_cls = lc_module.Sim3Solver

    class Recording(solver_cls):
        def iterate(self, n):
            out = super().iterate(n)
            ransac.append(int(self.best_n))
            return out

    lc_module.Sim3Solver = Recording
    try:
        kf = lc.current_kf = kfs[-1]
        candidates = wm.detect_n_best_candidates(kf, 3)
        lc._detect_from_bow(kf, candidates)
    finally:
        lc_module.Sim3Solver = solver_cls
    out = dict(candidates=[c.mnId for c in candidates],
               matched=lc.matched_kf.mnId if lc.matched_kf else None,
               matched_mps=[None if m is None else m.mnId
                            for m in lc.loop_matched_mps],
               coincidences=lc.num_coincidences, ransac=ransac)
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


def _run(side, inputs, Tbc=None, kp_shim=False):
    if side == "jax":
        ns = types.SimpleNamespace(wm=jwm, Features=JFeatures, cam=JCAM,
                                   Preintegrated=None)
        jwm.reset_ids()
        return _detect_and_correct(jlc, *_build(
            ns, JVocabulary.load(VOC_PATH), inputs, Tbc, kp_shim))
    pwm.reset_ids()
    return _detect_and_correct(plc, *_build(
        testing.port_namespace("cpu", cam=CAM), PVocabulary.load(VOC_PATH),
        inputs, Tbc), device="cpu")


@pytest.fixture(scope="module")
def frozen():
    inputs = _frozen_inputs()
    return inputs, {key: _run(*key[:1], inputs, kp_shim=key[1])
                    for key in (("jax", True), ("jax", False),
                                ("port", False))}


def _centres(out):
    return -np.einsum("nji,nj->ni", out["Rcw"], out["tcw"])


def test_kb8_frozen_map_detection_matches_reference(frozen):
    _, runs = frozen
    ref, got = runs[("jax", True)], runs[("port", False)]
    assert ref["matched"] is not None and ref["coincidences"] == 1
    for key in ("candidates", "matched", "matched_mps", "coincidences",
                "ransac"):
        assert got[key] == ref[key], key
    assert sum(m is not None for m in got["matched_mps"]) >= 80


def test_kb8_frozen_map_correction_matches_reference(frozen):
    inputs, runs = frozen
    ref, got = runs[("jax", True)], runs[("port", False)]
    assert got["loops"] == ref["loops"] == 1
    np.testing.assert_allclose(got["Rcw"], ref["Rcw"], atol=POSE_TOL)
    np.testing.assert_allclose(got["tcw"], ref["tcw"], atol=POSE_TOL)
    assert got["mp_ids"] == ref["mp_ids"]
    np.testing.assert_allclose(got["points"], ref["points"], atol=POINT_TOL)
    # the correction took the revisit back onto the start (yaw-only)
    seq, frames = inputs[0], inputs[1]
    gt = np.stack([seq.frame_twc(f)[1] for f in frames])
    assert np.abs(_centres(got) - gt)[-4:].max() < 0.02


def test_kb8_loop_sim3_repairs_the_reference(frozen):
    """Without the shim the reference's RANSAC compares the KB8 projections
    with kp_un: on this map, where every landmark sits at its true place,
    it keeps 136 of the 468 inliers the port keeps (the near-axis ones),
    still closes, and leaves the revisit 0.027 m from the truth against
    the port's 0.0035 m (CPU). On the tracked loop of chip_smoke.py phase
    10 (e), run on the CPU with the reference's observations, no loop
    closes (KF-ATE 0.070 m at the end; 0.021 m with the port's)."""
    inputs, runs = frozen
    ref, got = runs[("jax", False)], runs[("port", False)]
    assert got["matched"] is not None and got["loops"] == 1
    assert max(ref["ransac"], default=0) < 0.35 * max(got["ransac"])
    seq, frames = inputs[0], inputs[1]
    gt = np.stack([seq.frame_twc(f)[1] for f in frames])
    err = {k: np.abs(_centres(o) - gt)[-4:].max()
           for k, o in (("ref", ref), ("port", got))}
    assert err["port"] < 0.005 and err["ref"] > 5 * err["port"]


def test_kb8_loop_4dof_graph_repairs_the_reference():
    """The frozen map on a rig with tumvi.yaml's T_b_c1 (the reference
    given the kp shim, so both detect the same loop). The port's 4-DoF
    graph keeps every keyframe within 3.5 mm and 0.004 deg of yaw of the
    truth; the reference's, whose edges hold the cameras' relative poses
    between body vertices, throws the keyframes up to 12.2 m and 85 deg of
    yaw off (CPU)."""
    inputs = _frozen_inputs()
    ref = _run("jax", inputs, Tbc=TBC, kp_shim=True)
    got = _run("port", inputs, Tbc=TBC)
    assert ref["loops"] == got["loops"] == 1
    assert ref["matched"] == got["matched"]
    seq, frames = inputs[0], inputs[1]
    gt = np.stack([seq.frame_twc(f)[1] for f in frames])

    def errors(out):
        yaw = []
        for k, f in enumerate(frames):
            E = out["Rcw"][k].T @ seq.frame_twc(f)[0].T
            yaw.append(np.degrees(np.arctan2(E[1, 0], E[0, 0])))
        return (np.linalg.norm(_centres(out) - gt, axis=1).max(),
                np.abs(yaw).max())

    (c_port, y_port), (c_ref, y_ref) = errors(got), errors(ref)
    assert c_port < 0.005 and y_port < 0.01, (c_port, y_port)
    assert c_ref > 1.0 and y_ref > 10.0, (c_ref, y_ref)


# ---------------------------------------------------------------------------
# (c) the two Sim3 calls on KB8 observations, port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fix_scale", [False, True])
def test_kb8_sim3_solver_matches_reference(fix_scale):
    _, X1, X2, uv1, uv2, _, bad = testing.sim3_pair(cam=CAM)
    ref = JSolver(X1, X2, uv1, uv2, JCAM, fix_scale=fix_scale,
                  min_inliers=15)
    got = Sim3Solver(X1, X2, uv1, uv2, CAM, fix_scale=fix_scale,
                     min_inliers=15, device="cpu")
    res_r, res_g = ref.iterate(300), got.iterate(300)
    for a, b in zip(got._hyp, ref._hyp):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_g[1], res_r[1])
    assert res_g[2:] == res_r[2:]
    assert got.iterations_done == ref.iterations_done
    for a, b in zip(got.get_estimates(), ref.get_estimates()):
        np.testing.assert_allclose(a, b, atol=SIM3_TOL)
    if not fix_scale:
        assert res_g[0] is not None and not res_g[1][bad].any()
        assert res_g[2] == len(X1) - len(bad)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_kb8_optimize_sim3_matches_reference(fix_scale):
    S0, X1, X2, uv1, uv2, (R, t, s), bad = testing.sim3_pair(cam=CAM)
    m = len(X1)
    args = (*S0, X1, X2, uv1, uv2)
    ref = jpg.optimize_sim3(*(jnp.asarray(np.asarray(a, np.float32))
                              for a in args), jnp.ones(m, bool),
                            JCAM, JCAM, fix_scale=fix_scale)
    got = ppg.optimize_sim3(*(torch.from_numpy(np.asarray(a, np.float32))
                              for a in args), CAM, CAM, fix_scale=fix_scale)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=SIM3_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4])
    assert not got[3].numpy()[bad].any()
    if not fix_scale:
        assert int(got[4]) == m - len(bad)
        np.testing.assert_allclose(got[0].numpy(), R, atol=2e-3)
        assert abs(float(got[2]) - s) < 0.01


# ---------------------------------------------------------------------------
# (d) the fisheye fixture
# ---------------------------------------------------------------------------

def test_kb8_loop_sequence_undistorts_as_each_package_does():
    """kp_pos is the KB8 projection, kp_pos_un its f64 undistortion: each
    package's f32 undistort_points within UNDISTORT_ATOL_PX of it, kp_out
    where it leaves the image. The start and far-side views share no
    landmark through the fisheye."""
    seq = testing.make_loop_sequence(n_frames=N_FRAMES, cam=CAM, Tbc=TBC)
    n_out = 0
    for i in range(0, N_FRAMES, 24):
        feats, ids = seq.scene.render(*seq.frame_tcw(i), noise=0.5)
        d, un = feats.kp_pos, feats.kp_pos_un
        assert np.abs(un - d).max() > 50.0
        port = CAM.undistort_points(torch.from_numpy(d)).numpy()
        ref = np.asarray(JCAM.undistort_points(jnp.asarray(d)))
        for got in (port, ref):
            np.testing.assert_allclose(got, un, atol=UNDISTORT_ATOL_PX,
                                       rtol=0)
        inside = CAM.is_in_image(torch.from_numpy(un), 1.0).numpy()
        np.testing.assert_array_equal(feats.kp_out, ~inside)
        n_out += int(feats.kp_out.sum())
    assert n_out > 0
    far = int(np.argmax([seq.frame_twc(i)[1][0] for i in range(N_FRAMES)]))
    start = set(seq.scene.visible(*seq.frame_tcw(0)))
    assert start and not start & set(seq.scene.visible(*seq.frame_tcw(far)))


def test_pinhole_loop_sequence_renders_as_harness():
    """The default camera: the same keypoints, ids and descriptors as
    tests/synthetic_sequence.py's scene renders, kp_pos_un equal to kp_pos
    and no kp_out. (Edges and colines are left out: the port's ring scene
    keeps the box scene's unshifted segment ids, ROADMAP section 3.)"""
    ref = SS.make_loop_sequence(n_frames=N_FRAMES)
    got = testing.make_loop_sequence(n_frames=N_FRAMES)
    for i in range(0, N_FRAMES, 24):
        pose = ref.frame_tcw(i)  # the two differ in f32 ulps (so3.exp)
        fr, ir = ref.scene.render(*pose, noise=0.5)
        fg, ig = got.scene.render(*pose, noise=0.5)
        np.testing.assert_array_equal(ig, ir)
        for key in ("kp_pos", "kp_pos_un", "kp_out", "desc"):
            np.testing.assert_array_equal(getattr(fg, key), getattr(fr, key))
        np.testing.assert_array_equal(fg.kp_pos_un, fg.kp_pos)


def test_loop_sequence_overrun_goes_on_past_the_closure():
    """overrun=k (phase 10 (e) tracks 8 frames past the closure): the first
    n_frames poses and IMU rows are those of the sequence without it, and
    the k frames after them go on along the circle past the start view."""
    base = testing.make_loop_sequence(n_frames=N_FRAMES)
    over = testing.make_loop_sequence(n_frames=N_FRAMES, overrun=8)
    assert over.n_frames == N_FRAMES + 8
    np.testing.assert_array_equal(over.imu[:len(base.imu)], base.imu)
    assert len(over.imu) > len(base.imu)
    for a, b in zip(over.frame_poses[:N_FRAMES], base.frame_poses):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    start = base.frame_twc(0)[1]
    gaps = [np.linalg.norm(over.frame_twc(i)[1] - start)
            for i in range(N_FRAMES - 1, over.n_frames)]
    assert all(g < 1.0 for g in gaps)  # back at the start (~0.3 m)...
    assert np.all(np.diff(gaps) > 0)   # ...and moving on along the circle
