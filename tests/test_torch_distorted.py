"""The distorted cameras through the port's Tracking + LocalMapping against
ppg_slam_tpu's, state by state, on the CPU.

One feature stream per camera is built once in numpy from the synthetic
scene and mono-inertial sequence (testing.SyntheticSequence, seed 3) seen
through a distorted camera: a radtan pinhole with EuRoC's k1, k2, p1, p2,
and a Kannala-Brandt-8 fisheye with TUM-VI's k1..k4 at 640x480 (the focal
length scaled with the width). Each frame's keypoints are the distorted
pixels of the visible landmarks (radtan: the pinhole projection through the
closed-form distortion; KB8: the KB8 projection), with the scene's edges,
colines and descriptors, and their undistorted positions as the extractor
computes them (radtan: cv::undistortPoints' 5 compensation steps; KB8: 10
Newton steps on theta), here in f64. A shim hands the same stream to each
package's Tracking as its extractor would: kp_pos is the distorted pixel on
the fisheye and the undistorted one on the pinhole, and kp_out marks a
keypoint whose undistorted position leaves the image (1 px border)
(PPGExtractor.cpp:141-146). Each package's own camera.undistort_points is
held against the stream's undistortion separately.

Both packages get one stream, not each its own undistortion, because the
f32 undistortions of the two packages differ in the last bits and this
stream holds landmarks on the two-view and triangulation thresholds: with
each package's own kp_pos_un the map point counts part by a few and the
keyframe centres by up to 1.6 mm (measured on the CPU).

The port repairs two faults of the reference on Kannala-Brandt, where
kp_pos_un and kp_pos are different spaces: its pose solves take
kp_pos_un as the observation of a projection that is a distorted pixel
(test_kb8_pose_observations_repair_the_reference), and its initialization
search looks for kp_pos_un positions in a grid of kp_pos
(test_kb8_init_search_repairs_the_reference). For the state-by-state
comparison the JAX package gets, through shims, each matched keypoint's
distorted pixel in its pose optimization and the first frame's kp_pos as
the search positions: the port's repairs, applied to the reference's
inputs.

Visual-only (Map.imu_ini_time far away) over N_FRAMES frames. Held exactly:
the frame of monocular init, every frame's state and map sizes, and the
keyframe timestamps. Within tolerance: the two-view R and t (POSE_TOL) and
the keyframe centres (KF_RMS_TOL RMS).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ppg_slam_tpu.pipeline.tracking as jtr
from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
from ppg_slam_tpu.geometry.cameras import CameraModel as JCamera
from ppg_slam_tpu.pipeline.local_mapping import LocalMapping as JLocalMapping
from ppg_slam_tpu.worldmap import Map as JMap
from ppg_slam_tpu.worldmap import Rig as JRig

import ppg_slam_tpu_torch.pipeline.tracking as ptr
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.frontend.extractor import FrameFeatures as PFeatures
from ppg_slam_tpu_torch.geometry.cameras import (CAM_FISHEYE, CAM_PINHOLE,
                                                 CameraModel)
from ppg_slam_tpu_torch.pipeline import LocalMapping as PLocalMapping

N_FRAMES = 24
# two-view R, t: on the KB8 stream both packages' f32 t lie 1.1e-4 (port)
# and 1.8e-4 (reference) from an f64 solve of the same input
POSE_TOL = {"radtan": 1e-4, "kb8": 2e-4}
KF_RMS_TOL = 1e-4  # m

CAMERAS = {
    "radtan": dict(kind=CAM_PINHOLE, fx=400.0, fy=400.0, cx=320.0, cy=240.0,
                   dist=(-0.28340811, 0.07395907, 0.00019359,
                         1.76187114e-05), width=640, height=480),
    "kb8": dict(kind=CAM_FISHEYE, fx=238.7, fy=238.7, cx=319.5, cy=239.5,
                dist=(0.003482389402, 0.000715034845, -0.002053236141,
                      0.000202936736), width=640, height=480),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: under a parallel test run torch's intra-op thread
    pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _distorted_pixels(cam: CameraModel, Xc: np.ndarray) -> np.ndarray:
    """Where the distorted camera images camera-frame points (f32)."""
    if cam.is_fisheye:
        return cam.project_np(Xc)
    k1, k2, p1, p2 = cam.dist
    x = Xc[:, 0].astype(np.float64) / Xc[:, 2]
    y = Xc[:, 1].astype(np.float64) / Xc[:, 2]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy],
                    1).astype(np.float32)


def _undistorted_pixels(cam: CameraModel, d: np.ndarray) -> np.ndarray:
    """The extractor's undistortion of distorted pixels, in f64: radtan by
    cv::undistortPoints' 5 compensation steps, KB8 by 10 Newton steps on
    theta (KannalaBrandt8.cpp:62-91); f32 out."""
    if cam.is_fisheye:
        return testing.kb8_undistort_f64(cam, d)
    px = (d[:, 0].astype(np.float64) - cam.cx) / cam.fx
    py = (d[:, 1].astype(np.float64) - cam.cy) / cam.fy
    k1, k2, p1, p2 = cam.dist
    x, y = px, py
    for _ in range(5):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (px - dx) * icdist, (py - dy) * icdist
    return np.stack([cam.fx * x + cam.cx, cam.fy * y + cam.cy],
                    1).astype(np.float32)


def make_stream(case, n_frames=N_FRAMES):
    """Per frame: (distorted pixels, undistorted pixels, descriptors,
    edges, colines, connected), the sequence, and the camera (the port's
    CameraModel)."""
    cam = CameraModel(**CAMERAS[case])
    seq = testing.SyntheticSequence(n_frames=n_frames)
    scene = seq.scene
    rng = np.random.RandomState(17)
    frames = []
    for i in range(n_frames):
        Rcw, tcw = seq.frame_tcw(i)
        Xc = scene.points @ Rcw.T + tcw
        front = Xc[:, 2] > 0.3
        d = np.full((scene.n, 2), -1e3, np.float32)
        d[front] = _distorted_pixels(cam, Xc[front])
        inb = (front & (d[:, 0] >= 8) & (d[:, 0] < cam.width - 8)
               & (d[:, 1] >= 8) & (d[:, 1] < cam.height - 8))
        ids = np.nonzero(inb)[0]
        descs = scene.descs[ids] + rng.randn(len(ids), 256).astype(
            np.float32) * seq.desc_noise
        descs /= np.linalg.norm(descs, axis=1, keepdims=True)
        local = np.full(scene.n, -1, np.int64)
        local[ids] = np.arange(len(ids))
        seg = local[scene._segments]
        edges = seg[(seg >= 0).all(1)].astype(np.int32)
        tri = local[scene._triplets]
        colines = tri[(tri >= 0).all(1)].astype(np.int32)
        connected = [[] for _ in ids]
        for eid, (a, b) in enumerate(edges.tolist()):
            connected[a].append(eid)
            connected[b].append(eid)
        frames.append((d[ids], _undistorted_pixels(cam, d[ids]),
                       descs.astype(np.float32), edges, colines, connected))
    return frames, seq, cam


class _StreamExtractor:
    """A package's extractor over a distorted stream: the n-th extract()
    gives frame n's features as that package's FrameFeatures."""

    def __init__(self, frames, cam, features_cls):
        self.frames = frames
        self.cam = cam
        self.features_cls = features_cls
        self.k = 0

    def extract(self, image):
        d, kp_un, descs, edges, colines, connected = self.frames[self.k]
        self.k += 1
        w, h = self.cam.width, self.cam.height
        kp_ok = ((kp_un[:, 0] >= 1) & (kp_un[:, 0] < w - 1)
                 & (kp_un[:, 1] >= 1) & (kp_un[:, 1] < h - 1))
        pos = d.copy() if self.cam.is_fisheye else kp_un.copy()
        return self.features_cls(
            kp_pos=pos, kp_pos_un=kp_un.copy(),
            kp_score=np.ones(len(d), np.float32), kp_out=~kp_ok,
            edges=edges.copy(), edge_score=np.full(len(edges), 0.5,
                                                   np.float32),
            colines=colines.copy(), connected=[list(c) for c in connected],
            desc=descs.copy())


def _distorted_observations(pose_optimization, frames):
    """The reference's pose_optimization with each observation given as
    the stream's distorted pixel of the undistorted one it is handed."""
    lut = {tuple(u): tuple(d) for f in frames for d, u in zip(f[0], f[1])}

    def wrapped(Rcw, tcw, X, uv, valid, cam):
        uv = np.asarray(uv)
        uv = np.array([lut.get(tuple(r), tuple(r)) for r in uv], np.float32)
        return pose_optimization(Rcw, tcw, X, jnp.asarray(uv), valid, cam)

    return wrapped


def _search_from_grid_positions(tracking, mp):
    """The reference's monocular initialization with its search positions
    set to the first frame's kp_pos (the grid's) where it took kp_pos_un."""
    init = tracking.monocular_initialization

    def wrapped():
        fresh = not tracking.ready_to_init
        init()
        if fresh and tracking.ready_to_init:
            tracking.prev_matched = tracking.init_frame.kp.copy()

    mp.setattr(tracking, "monocular_initialization", wrapped)


def _record_two_view(module, out):
    fn = module.two_view_reconstruct

    def wrapped(*a):
        res = fn(*a)
        out.append((bool(res.ok), np.asarray(res.R21).astype(np.float64),
                    np.asarray(res.t21).astype(np.float64)))
        return res

    return wrapped


def _run(side, case):
    with pytest.MonkeyPatch.context() as mp:
        return _track(side, case, mp)


def _track(side, case, mp):
    frames, seq, pcam = make_stream(case)
    two_view = []
    if side == "jax":
        cam = JCamera(**CAMERAS[case])
        ex = _StreamExtractor(frames, cam, JFeatures)
        if pcam.is_fisheye:
            mp.setattr(jtr, "pose_optimization",
                       _distorted_observations(jtr.pose_optimization, frames))
        wmap = JMap(JRig(cam, freq=200.0))
        mp.setattr(jtr, "two_view_reconstruct",
                   _record_two_view(jtr, two_view))
        tr = jtr.Tracking(wmap, ex)
        lm = JLocalMapping(wmap, tracking=tr)
        if pcam.is_fisheye:
            _search_from_grid_positions(tr, mp)
    else:
        pwm.reset_ids()
        ex = _StreamExtractor(frames, pcam, PFeatures)
        wmap = pwm.Map(pwm.Rig(pcam, freq=200.0))
        mp.setattr(ptr, "two_view_reconstruct",
                   _record_two_view(ptr, two_view))
        tr = ptr.Tracking(wmap, ex, device="cpu")
        lm = PLocalMapping(wmap, tracking=tr, device="cpu")
    tr.local_mapper = lm
    log = []
    last_t = -1.0
    for i in range(N_FRAMES):
        t = seq.frame_times[i]
        tr.grab_imu(seq.imu_between(last_t, t))
        last_t = t
        tr.grab_image(np.zeros((2, 2), np.uint8), t)
        log.append((tr.state, wmap.n_keyframes(), wmap.n_map_points()))
    kfs = sorted(wmap.all_keyframes(), key=lambda k: k.mnId)
    return dict(log=log, two_view=two_view, ex=ex, seq=seq,
                kf_t=np.array([kf.timestamp for kf in kfs]),
                kf_c=np.stack([kf.camera_center() for kf in kfs]))


@pytest.fixture(scope="module")
def runs():
    saved = (JMap.imu_ini_time, pwm.Map.imu_ini_time)
    JMap.imu_ini_time = pwm.Map.imu_ini_time = 1e9  # visual-only
    try:
        yield {(side, case): _run(side, case)
               for case in CAMERAS for side in ("jax", "port")}
    finally:
        JMap.imu_ini_time, pwm.Map.imu_ini_time = saved


# the f32 undistortion of each package against the stream's f64 (the
# ROADMAP's named tolerance: 1e-4 px within ~1.2 rad and the 5-step radtan
# convergence; the stream's corners reach past both)
UNDISTORT_ATOL_PX = {"radtan": 2e-3, "kb8": 2e-2}


@pytest.mark.parametrize("case", sorted(CAMERAS))
def test_stream_is_undistorted_as_each_package_does(case):
    """Undistortion moves the stream's keypoints by pixels, on the fisheye
    some out of the image; each package's camera.undistort_points gives
    the stream's kp_pos_un within UNDISTORT_ATOL_PX and the same kp_out."""
    frames, _, cam = make_stream(case, n_frames=N_FRAMES)
    jcam = JCamera(**CAMERAS[case])
    n_out = 0
    for d, kp_un, *_ in frames[::6]:
        assert np.abs(kp_un - d).max() > 5.0
        port = cam.undistort_points(torch.from_numpy(d)).numpy()
        ref = np.asarray(jcam.undistort_points(jnp.asarray(d)))
        for got in (port, ref):
            np.testing.assert_allclose(got, kp_un,
                                       atol=UNDISTORT_ATOL_PX[case], rtol=0)
        inside = cam.is_in_image(torch.from_numpy(kp_un), 1.0).numpy()
        np.testing.assert_array_equal(
            cam.is_in_image(torch.from_numpy(port), 1.0).numpy(), inside)
        n_out += int((~inside).sum())
    assert n_out > 0


@pytest.mark.parametrize("case", sorted(CAMERAS))
def test_tracking_matches_reference_state_by_state(runs, case):
    ref, got = runs[("jax", case)], runs[("port", case)]
    states = [row[0] for row in ref["log"]]
    assert jtr.OK in states, ref["log"]
    k_init = states.index(jtr.OK)
    assert k_init < N_FRAMES - 8  # some tracked frames after the init
    assert states[-1] == jtr.OK
    assert [row[0] for row in got["log"]].index(ptr.OK) == k_init
    assert got["log"] == ref["log"]
    np.testing.assert_array_equal(got["kf_t"], ref["kf_t"])


@pytest.mark.parametrize("case", sorted(CAMERAS))
def test_two_view_and_keyframes_within_tolerance(runs, case):
    ref, got = runs[("jax", case)], runs[("port", case)]
    assert [ok for ok, _, _ in got["two_view"]] == \
        [ok for ok, _, _ in ref["two_view"]]
    (_, R_r, t_r), (_, R_g, t_g) = ref["two_view"][-1], got["two_view"][-1]
    np.testing.assert_allclose(R_g, R_r, atol=POSE_TOL[case])
    np.testing.assert_allclose(t_g, t_r, atol=POSE_TOL[case])
    d = np.linalg.norm(got["kf_c"] - ref["kf_c"], axis=1)
    assert np.sqrt(np.mean(d ** 2)) < KF_RMS_TOL, d


def test_kb8_pose_observations_repair_the_reference():
    """The pose solve of a Kannala-Brandt frame at its true pose: the
    port's observations (frame.kp, the distorted pixels its projection is
    compared with) leave every landmark an inlier; the reference's
    (kp_pos_un) leave fewer than a quarter, so that on a wide fisheye
    tracking is lost after the init (the rendered TUM-VI corridor of
    chip_smoke.py phase 13, in both packages before the repair)."""
    import ppg_slam_tpu.estimator.pose_opt as jpo
    from ppg_slam_tpu_torch.estimator.pose_opt import pose_optimization

    frames, seq, cam = make_stream("kb8", n_frames=12)
    d, kp_un = frames[11][0], frames[11][1]
    Rcw, tcw = seq.frame_tcw(11)
    Xc = seq.scene.points @ Rcw.T + tcw
    front = Xc[:, 2] > 0.3
    proj = np.full((seq.scene.n, 2), -1e3, np.float32)
    proj[front] = cam.project_np(Xc[front])
    # the stream's keypoints are the visible landmarks' projections
    ids = np.array([int(np.argmin(np.abs(proj - p).sum(1))) for p in d])
    X = seq.scene.points[ids].astype(np.float32)
    valid = np.ones(len(X), bool)
    t = torch.from_numpy
    _, _, inl_port, n_port = pose_optimization(
        t(Rcw), t(tcw), t(X), t(d), t(valid), cam)
    jcam = JCamera(**CAMERAS["kb8"])
    _, _, inl_ref, n_ref = jpo.pose_optimization(
        jnp.asarray(Rcw), jnp.asarray(tcw), jnp.asarray(X),
        jnp.asarray(kp_un), jnp.asarray(valid), jcam)
    assert int(n_port) == len(X) > 300
    assert int(n_ref) < 0.25 * len(X)  # 99 of 480 on the CPU


def test_kb8_init_search_repairs_the_reference():
    """The initialization search between two Kannala-Brandt frames: from
    the grid's positions (kp_pos, the port's) it matches most keypoints;
    from kp_pos_un (the reference's) it finds the off-axis keypoints'
    windows empty, as on the rendered UMA-VI corridor of chip_smoke.py
    phase 13, where the reference's search left 70-100 of 500 keypoints
    and no initialization in 36 frames."""
    from ppg_slam_tpu_torch.matching.matcher import Matcher
    from ppg_slam_tpu_torch.worldmap import Frame, Rig

    frames, _, cam = make_stream("kb8", n_frames=3)
    ex = _StreamExtractor(frames, cam, PFeatures)
    rig = Rig(cam, freq=200.0)
    f1 = Frame(ex.extract(None), 0.0, rig)
    f2 = Frame(ex.extract(None), 0.05, rig)
    # the keypoints whose undistorted position lies beyond the window from
    # the distorted one; a match is right where the second frame's
    # keypoint lies near the first's (a frame's motion is a few pixels)
    far = np.linalg.norm(f1.kp_un - f1.kp, axis=1) > 60.0
    right = {}
    for name, pos in (("kp", f1.kp), ("kp_un", f1.kp_un)):
        m12, _ = Matcher(cam, 0.9).search_for_initialization(
            f1, f2, pos.copy(), window=50)
        ok = (m12 >= 0) & far
        right[name] = int((np.linalg.norm(
            f2.kp[m12[ok]] - f1.kp[ok], axis=1) < 20.0).sum())
    assert far.sum() > 30
    assert right["kp"] > 0.8 * far.sum() and right["kp_un"] == 0
