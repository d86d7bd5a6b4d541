"""full_inertial_ba and the conformal scale search: the port against
ppg_slam_tpu.estimator.ba.

Maps are built in both packages from the same numpy (a synthetic
mono-inertial sequence: N_KF keyframes KF_EVERY frames apart with their
preintegrated IMU links and the scene's colines, poses and points
perturbed). Tolerances are stated with each test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ppg_slam_tpu.estimator.ba as jba

import ppg_slam_tpu_torch.estimator.ba as pba
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.estimator.ba_core import BAOptions, KFStates

from test_torch_ba_entry import JAX, PORT, centres

KF_EVERY, N_KF = 8, 8
SCAN_RTOL = 1e-5
GEOM_TOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port_ids():
    pwm.reset_ids()
    yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's solves are many small ops: under a parallel test run,
    torch's intra-op thread pool only oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fiba_maps(noise_pose=0.01, noise_pt=0.02):
    """[(map, keyframes, {gid: MapPoint})] of the JAX package and the
    port, built from the same sequence window."""
    seq = testing.SyntheticSequence(n_frames=KF_EVERY * N_KF, seed=3)
    frames = list(range(0, KF_EVERY * N_KF, KF_EVERY))
    poses = [seq.frame_tcw(i) for i in frames]
    views = testing.render_views(seq.scene, poses, noise=0.5)
    times = [seq.frame_times[i] for i in frames]
    links = testing.imu_links(seq, times)
    vels = [seq.frame_vels[i] for i in frames]
    pert = testing.perturbation(N_KF, seq.scene.n, noise_pose=noise_pose,
                                noise_pt=noise_pt)
    return [testing.build_map(pkg, poses, views, seq.scene.points, pert,
                              times, (links, vels), colines=True)
            for pkg in (JAX, PORT)]


SIGMAS = np.exp(np.linspace(np.log(0.25), np.log(4.0), 13)).astype(
    np.float32)


def test_conformal_scan_matches_reference():
    """chi2 along the conformal curve at the first pass's 13 sigmas, on
    the unperturbed map (pixel noise only), within 1e-5 relative."""
    (wm_r, _, _), (wm_g, _, _) = fiba_maps(0.0, 0.0)
    opts_r = jba.BAOptions(reproj_kernel="huber")
    st, pts, prob, slot_k, kfs, mps = jba._gather_full_problem(wm_r)
    rig = wm_r.rig
    ref = np.asarray(jba._conformal_scan(
        jba.KFStates(*(jnp.asarray(x) for x in st)), jnp.asarray(pts), prob,
        jnp.asarray(rig.Rcb), jnp.asarray(rig.tcb), rig.cam, opts_r,
        jnp.asarray(SIGMAS), slot_k=slot_k))

    st, pts, prob, kfs_g, _ = pba._gather_full_problem(wm_g)
    assert len(kfs_g) == len(kfs)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = pba._conformal_scan(
        KFStates(*map(t, st)), t(pts), pba._device_problem(prob, "cpu"),
        t(wm_g.rig.Rcb), t(wm_g.rig.tcb), wm_g.rig.cam,
        BAOptions(reproj_kernel="huber"), t(SIGMAS)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=SCAN_RTOL)
    # the curve has its minimum inside the grid: the map is near metric
    assert 0 < int(np.argmin(got)) < len(SIGMAS) - 1


@pytest.mark.parametrize("scale", [1.0, 0.3, 1.7])
def test_whole_map_transform_gain_matches_reference(scale):
    """(chi2 now, chi2 of the transformed map) within 1e-5 relative, the
    map untouched."""
    from ppg_slam_tpu_torch.geometry import so3

    (wm_r, kfs_r, _), (wm_g, kfs_g, _) = fiba_maps(0.0, 0.0)
    Rgw = so3.exp(np.float32([0.05, -0.02, 0.1]) * (scale != 1.0))
    before = centres(kfs_g)
    ref = jba.whole_map_transform_gain(wm_r, Rgw, scale)
    got = pba.whole_map_transform_gain(wm_g, Rgw, scale, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=SCAN_RTOL)
    np.testing.assert_array_equal(centres(kfs_g), before)
    if scale == 1.0:
        assert abs(got[1] - got[0]) <= 1e-5 * got[0]
    else:
        assert got[1] > got[0] * 1.001


def test_conformal_scale_refine_matches_reference():
    """The unperturbed map mis-scaled x2.5 (tests/test_pipeline_e2e.py:198's
    case, grown): both packages find the same correction within 1e-3 and
    apply it. lo = 0.3 keeps the expected 0.4 off the band's edge."""
    maps = fiba_maps(0.0, 0.0)
    I3 = np.eye(3, dtype=np.float32)
    for wm, _, _ in maps:
        wm.apply_scaled_rotation(I3, 2.5, scale_vel=True)
    (wm_r, kfs_r, mps_r), (wm_g, kfs_g, mps_g) = maps
    s_r = jba.conformal_scale_refine(wm_r, lo=0.3)
    s_g = pba.conformal_scale_refine(wm_g, lo=0.3, device="cpu")
    assert s_g < 0.8, s_g  # the 2.5x error is substantially undone
    assert abs(s_g - s_r) <= 1e-3 * s_r, (s_g, s_r)
    np.testing.assert_allclose(centres(kfs_g), centres(kfs_r), atol=1e-3)


@pytest.mark.parametrize("b_init", [False, True], ids=["free", "b_init"])
def test_full_inertial_ba_matches_reference(b_init):
    """KF centres within 1e-3 m, the median point within 1e-3 m,
    velocities and biases within 1e-3 of the reference's."""
    (wm_r, kfs_r, mps_r), (wm_g, kfs_g, mps_g) = fiba_maps()
    kw = dict(iters=30, loop_kf=0, b_init=b_init, prior_g=1e2,
              prior_a=1e5 if b_init else 1e6)
    jba.full_inertial_ba(wm_r, **kw)
    out = pba.full_inertial_ba(wm_g, device="cpu", **kw)
    assert out["final_chi2"] < out["initial_chi2"]
    assert out["n_kf"] == N_KF
    np.testing.assert_allclose(centres(kfs_g), centres(kfs_r), atol=GEOM_TOL)
    d_p = np.median([np.linalg.norm(mps_g[g].pos - mp.pos)
                     for g, mp in mps_r.items()])
    assert d_p <= GEOM_TOL, d_p
    for kr, kg in zip(kfs_r, kfs_g):
        np.testing.assert_allclose(kg.velocity, kr.velocity, atol=GEOM_TOL)
        np.testing.assert_allclose(kg.bias, kr.bias, atol=GEOM_TOL)


def test_full_inertial_ba_loop_kf_writes_scratch_fields():
    """loop_kf != 0: the results go to the gba_* fields and the map is
    untouched; the scratch poses agree with the reference's within 1e-3."""
    (wm_r, kfs_r, _), (wm_g, kfs_g, mps_g) = fiba_maps()
    before = centres(kfs_g)
    loop = kfs_g[-1].mnId
    jba.full_inertial_ba(wm_r, iters=20, loop_kf=kfs_r[-1].mnId)
    pba.full_inertial_ba(wm_g, iters=20, loop_kf=loop, device="cpu")
    np.testing.assert_array_equal(centres(kfs_g), before)
    assert all(kf.ba_global_for_kf == loop for kf in kfs_g)
    assert all(mp.ba_global_for_kf == loop for mp in mps_g.values())
    gba = lambda kfs: np.stack([-kf.gba_Rcw.T @ kf.gba_tcw for kf in kfs])
    np.testing.assert_allclose(gba(kfs_g), gba(kfs_r), atol=GEOM_TOL)
    for kr, kg in zip(kfs_r, kfs_g):
        np.testing.assert_allclose(kg.gba_vel, kr.gba_vel, atol=GEOM_TOL)
        np.testing.assert_allclose(kg.gba_bias, kr.gba_bias, atol=GEOM_TOL)


def test_full_inertial_ba_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, (wm, _, _) = fiba_maps()
    for call in (lambda: pba.full_inertial_ba(wm),
                 lambda: pba.conformal_scale_refine(wm),
                 lambda: pba.whole_map_transform_gain(
                     wm, np.eye(3, dtype=np.float32), 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
