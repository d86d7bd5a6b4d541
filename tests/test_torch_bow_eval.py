"""The port's copies of the BoW vocabulary and the trajectory evaluation
against ppg_slam_tpu's, on the bundled vocabularies and seeded
trajectories: identical vocabularies, BoW vectors and scores (exact: the
same numpy code), and alignments within 1e-12."""

import os

import numpy as np
import pytest

from ppg_slam_tpu.bow import Vocabulary as JVocabulary
from ppg_slam_tpu.utils import evaluation as jev

from ppg_slam_tpu_torch.bow import Vocabulary as PVocabulary
from ppg_slam_tpu_torch.utils import evaluation as pev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["voc_euroc_9x3.npz", "voc_tum_9x3.npz"])
def test_vocabulary_matches_reference(name):
    path = os.path.join(ROOT, "assets", name)
    ref, got = JVocabulary.load(path), PVocabulary.load(path)
    assert (got.k, got.L, got.n_words) == (ref.k, ref.L, ref.n_words) \
        == (9, 3, 729)
    for key in ("node_parent", "node_weight", "node_desc", "children",
                "node_word"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))
    rng = np.random.RandomState(41)
    d = rng.randn(300, 256).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (bv_r, fv_r), (bv_g, fv_g) = ref.transform(d), got.transform(d)
    assert bv_g == bv_r and fv_g == fv_r and list(fv_g) == [0]
    bv2 = got.transform(d[:150])[0]
    assert got.score(bv_g, bv2) == ref.score(bv_r, ref.transform(d[:150])[0])
    assert 0.0 < got.score(bv_g, bv2) < 1.0


def test_evaluation_matches_reference(tmp_path):
    rng = np.random.RandomState(5)
    gt = np.cumsum(rng.randn(80, 3) * 0.1, axis=0)
    a = 0.3
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    est = 0.7 * gt @ Rz.T + np.array([1.0, -2.0, 0.5]) \
        + rng.randn(80, 3) * 0.01
    for scale in (True, False):
        s_r, R_r, t_r = jev.umeyama(est, gt, with_scale=scale)
        s_g, R_g, t_g = pev.umeyama(est, gt, with_scale=scale)
        assert abs(s_g - s_r) < 1e-12
        np.testing.assert_allclose(R_g, R_r, atol=1e-12)
        np.testing.assert_allclose(t_g, t_r, atol=1e-12)
        assert pev.align_and_ate(est, gt, scale) == \
            jev.align_and_ate(est, gt, scale)
    # TUM files: stamps associated, aligned, evaluated alike
    ts = np.arange(80) * 0.05
    q = np.tile([0.0, 0.0, 0.0, 1.0], (80, 1))
    for name, pos in (("gt.txt", gt), ("est.txt", est)):
        np.savetxt(tmp_path / name, np.hstack([ts[:, None], pos, q]))
    got = pev.evaluate_files(str(tmp_path / "est.txt"),
                             str(tmp_path / "gt.txt"))
    ref = jev.evaluate_files(str(tmp_path / "est.txt"),
                             str(tmp_path / "gt.txt"))
    assert got == ref and got.n_pairs == 80 and got.rmse < 0.05
