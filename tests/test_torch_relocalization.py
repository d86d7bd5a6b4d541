"""The port's relocalization, held to tests/test_relocalization.py's
scenario and assertions on the port alone: vision is killed mid-sequence
for longer than the IMU coast window (5 s) and then restored; tracking must
recover through BoW -> PnP -> pose optimization (Tracking.cpp:1179-1345)
without a map reset, at a pose consistent with the map.

(Its JAX half would add the reference pipeline's 195 frames to the tier-1
run; the port's Tracking is held frame by frame against the reference's in
tests/test_torch_pipeline.py.)
"""

import os

import numpy as np
import pytest
import torch

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.bow import Vocabulary
from ppg_slam_tpu_torch.frontend.extractor import FrameFeatures
from ppg_slam_tpu_torch.pipeline import LocalMapping, Tracking
from ppg_slam_tpu_torch.pipeline.tracking import OK

VOC_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "voc_euroc_9x3.npz")
BLIND_START, BLIND_END = 62, 167  # tests/test_relocalization.py's window


class BlindableExtractor:
    def __init__(self, seq):
        self.inner = testing.SyntheticExtractor(seq)

    def extract(self, image):
        feats = self.inner.extract(image)
        i = self.inner.frame_idx - 1
        if BLIND_START <= i < BLIND_END:
            return FrameFeatures(
                kp_pos=np.zeros((0, 2), np.float32),
                kp_pos_un=np.zeros((0, 2), np.float32),
                kp_score=np.zeros(0, np.float32),
                kp_out=np.zeros(0, bool),
                edges=np.zeros((0, 2), np.int32),
                edge_score=np.zeros(0, np.float32),
                colines=np.zeros((0, 3), np.int32),
                connected=[], desc=np.zeros((0, 256), np.float32))
        return feats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reloc_run():
    if not os.path.exists(VOC_PATH):
        pytest.skip("reference vocabulary not available")
    pwm.reset_ids()
    seq = testing.SyntheticSequence(n_frames=195, noise_px=0.3,
                                    imu_noise=(2e-3, 2e-2))
    saved = pwm.Map.imu_ini_time
    pwm.Map.imu_ini_time = 2.0
    try:
        wmap = pwm.Map(pwm.Rig(seq.scene.cam, freq=200.0),
                       vocabulary=Vocabulary.load(VOC_PATH))
        tracking = Tracking(wmap, BlindableExtractor(seq),
                            insert_kfs_lost=False, device="cpu")
        tracking.local_mapper = LocalMapping(wmap, tracking=tracking,
                                             device="cpu")
        states, reloc_at = [], []
        orig = tracking.relocalization

        def hooked():
            got = orig()
            if got:
                reloc_at.append(tracking.current.mnId)
            return got

        tracking.relocalization = hooked
        last_t = -1.0
        for i in range(seq.n_frames):
            t = seq.frame_times[i]
            tracking.grab_imu(seq.imu_between(last_t, t))
            last_t = t
            tracking.grab_image(np.zeros((2, 2), np.uint8), t)
            states.append(tracking.state)
    finally:
        pwm.Map.imu_ini_time = saved
    return seq, wmap, tracking, states, reloc_at


class TestRelocalization:
    def test_loses_and_recovers_without_reset(self, reloc_run):
        seq, wmap, tracking, states, reloc_at = reloc_run
        assert tracking.n_resets == 0, "map must NOT be reset"
        assert any(s != OK for s in states[BLIND_START + 1:BLIND_END])
        assert states[-1] == OK, states[-25:]
        assert len(reloc_at) >= 1, "relocalization never succeeded"

    def test_recovered_pose_is_map_consistent(self, reloc_run):
        """Align the map to ground truth with a Sim3 fitted on the
        pre-blind keyframes; the post-reloc camera centre must then match
        ground truth."""
        seq, wmap, tracking, states, reloc_at = reloc_run
        pre = [(kf.camera_center(), seq.frame_poses[kf.frame_id][1])
               for kf in wmap.keyframes
               if not kf.is_bad() and kf.frame_id < BLIND_START]
        E = np.stack([p[0] for p in pre])
        G = np.stack([p[1] for p in pre])
        mu_e, mu_g = E.mean(0), G.mean(0)
        U, D, Vt = np.linalg.svd((G - mu_g).T @ (E - mu_e) / len(E))
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        s = np.trace(np.diag(D) @ S) / (E - mu_e).var(0).sum()
        t = mu_g - s * R @ mu_e
        f = tracking.current
        aligned = s * R @ f.camera_center() + t
        terr = float(np.linalg.norm(aligned - seq.frame_poses[f.mnId][1]))
        assert terr < 0.5, f"post-reloc map-frame error: {terr:.3f} m"

    def test_map_survived(self, reloc_run):
        seq, wmap, tracking, states, reloc_at = reloc_run
        early = [kf for kf in wmap.keyframes if kf.frame_id < BLIND_START]
        assert len(early) >= 5


@pytest.mark.parametrize("start", [44, 20])
def test_resume_relocalizes_where_reference_raises(start):
    """A Tracking resumed into a saved map (resume_from_map: LOST, no last
    frame) on frames from `start` on, over a 12-keyframe visual-only map
    of the synthetic sequence built in both packages. The first frame
    matches the reference keyframe by BoW, so the JAX package's
    track_reference_keyframe reads last_frame.Rcw and raises; the port's
    fails cleanly there, and the frame relocalizes."""
    import types

    import synthetic_sequence as jseq
    import ppg_slam_tpu.worldmap as jwm
    from ppg_slam_tpu.bow import Vocabulary as JVocabulary
    from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
    from ppg_slam_tpu.imu import Preintegrated as JPreintegrated
    from ppg_slam_tpu.pipeline.tracking import Tracking as JTracking

    seq = testing.SyntheticSequence(n_frames=60)
    jax_seq = jseq.SyntheticSequence(n_frames=60)  # the same, in JAX types
    kf_frames = range(0, 48, 4)
    poses = [seq.frame_tcw(i) for i in kf_frames]
    views = testing.render_views(seq.scene, poses)
    pert = ([], [], np.zeros((len(seq.scene.points), 3), np.float32))
    times = [seq.frame_times[i] for i in kf_frames]
    sides = {
        "port": (testing.port_namespace("cpu"), Vocabulary, pwm,
                 lambda m: Tracking(m, testing.SyntheticExtractor(seq),
                                    device="cpu")),
        "jax": (types.SimpleNamespace(wm=jwm, Features=JFeatures,
                                      cam=jax_seq.scene.cam,
                                      Preintegrated=JPreintegrated),
                JVocabulary, jwm,
                lambda m: JTracking(m, jseq.SyntheticExtractor(jax_seq))),
    }
    states = {}
    for side, (pkg, voc_cls, wm_mod, make) in sides.items():
        wm_mod.reset_ids()
        wmap, _, _ = testing.build_map(pkg, poses, views, seq.scene.points,
                                       pert, times,
                                       vocabulary=voc_cls.load(VOC_PATH))
        saved = wm_mod.Map.imu_ini_time
        wm_mod.Map.imu_ini_time = 1e9  # visual-only
        try:
            tracking = make(wmap)
            tracking.extractor.frame_idx = start
            tracking.resume_from_map()
            assert tracking.state == 3  # LOST
            if side == "jax":
                with pytest.raises(AttributeError, match="Rcw"):
                    tracking.grab_image(np.zeros((2, 2), np.uint8),
                                        seq.frame_times[start])
                continue
            states[side] = []
            for i in range(start, start + 4):
                tracking.grab_image(np.zeros((2, 2), np.uint8),
                                    seq.frame_times[i])
                states[side].append(tracking.state)
        finally:
            wm_mod.Map.imu_ini_time = saved
    assert states["port"] == [OK] * 4
    assert tracking.n_resets == 0
