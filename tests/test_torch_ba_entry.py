"""The port's BA entry points and IMU initialization against ppg_slam_tpu's,
and the estimator slice as a whole.

Maps are built in both packages from the same numpy (tests/test_ba_entry.py's
build_map recipe, and a synthetic mono-inertial sequence); each package runs
its own entry point and the results are compared row by row. The JAX entry
points pad to their CPU shape floors (32 KFs, 1024 MPs, 2048 observations);
the port solves at the exact sizes, so only the real rows are compared.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ppg_slam_tpu.estimator.ba as jba
import ppg_slam_tpu.worldmap as jwm
from ppg_slam_tpu import imu as jimu
from ppg_slam_tpu.estimator import inertial_init as jinit
from ppg_slam_tpu.estimator import pose_opt as jpose
from ppg_slam_tpu.frontend.extractor import FrameFeatures as JFeatures
from ppg_slam_tpu.geometry import cameras as jcams
from ppg_slam_tpu.geometry import so3 as jso3

import ppg_slam_tpu_torch.estimator.ba as pba
import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import imu as pimu
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.estimator import inertial_init as pinit
from ppg_slam_tpu_torch.estimator import pose_opt as ppose
from ppg_slam_tpu_torch.frontend.extractor import FrameFeatures as PFeatures

import test_inertial_init as TI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_KW = {k: getattr(testing.CAM, k) for k in
          ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")}

JAX = types.SimpleNamespace(
    wm=jwm, Features=JFeatures, cam=jcams.CameraModel(**CAM_KW),
    Preintegrated=jimu.Preintegrated, ba=jba)
PORT = types.SimpleNamespace(
    wm=pwm, Features=PFeatures,
    cam=testing.CAM,
    Preintegrated=lambda *a: pimu.Preintegrated(*a, device="cpu"), ba=pba)


@pytest.fixture(autouse=True, scope="module")
def _fresh_port_ids():
    """The port's own id counters (tests/conftest.py resets the JAX
    package's)."""
    pwm.reset_ids()
    yield


def _frame(pkg, feats, timestamp, rig, Rcw, tcw):
    f = pkg.wm.Frame(pkg.Features(**feats), timestamp=timestamp, rig=rig)
    f.set_pose(Rcw, tcw)
    return f


def entry_maps(n_kf=6, imu=None):
    """tests/test_ba_entry.py's fixture in both packages."""
    scene = testing.SyntheticScene(seed=13)
    poses = [scene.pose(k * 4) for k in range(n_kf)]
    views = testing.render_views(scene, poses)
    times = [0.2 * k for k in range(n_kf)]
    pert = testing.perturbation(n_kf, scene.n)
    return [testing.build_map(pkg, poses, views, scene.points, pert, times,
                              imu) for pkg in (JAX, PORT)]


def centres(kfs):
    return np.stack([kf.camera_center() for kf in kfs])


def assert_geometry_agrees(c_r, c_g, p_r, p_g, centre_tol=1e-4,
                           point_tol=1e-4, scale_gauge=False):
    """KF centres (N, 3) and points (M, 3) agree: the largest centre
    difference and the median point difference. scale_gauge: the solve
    fixed only KF 0, so a monocular map keeps one free scale about KF 0's
    centre, along which the damped-LM endpoint wanders with summation order
    (tests/test_ba_entry.py: 0.01-0.02 m between equivalent reference
    variants); it is divided out first."""
    o, s = c_r[0], 1.0
    if scale_gauge:
        s = np.median(np.linalg.norm(c_r[1:] - o, axis=1)
                      / np.linalg.norm(c_g[1:] - o, axis=1))
    d_c = np.abs(s * (c_g - o) - (c_r - o)).max()
    assert d_c <= centre_tol, d_c
    d_p = np.median(np.linalg.norm(s * (p_g - o) - (p_r - o), axis=1))
    assert d_p <= point_tol, d_p


def assert_maps_agree(ref, got, scale_gauge=False):
    """Geometry as above, and the same observations erased as outliers and
    the same points culled."""
    (_, kfs_r, mps_r), (_, kfs_g, mps_g) = ref, got
    assert_geometry_agrees(
        centres(kfs_r), centres(kfs_g),
        np.stack([mps_r[g].pos for g in mps_r]),
        np.stack([mps_g[g].pos for g in mps_r]), scale_gauge=scale_gauge)
    assert ({g for g, mp in mps_r.items() if mp.is_bad()}
            == {g for g, mp in mps_g.items() if mp.is_bad()})
    kf_pos_r = {kf.mnId: k for k, kf in enumerate(kfs_r)}
    kf_pos_g = {kf.mnId: k for k, kf in enumerate(kfs_g)}
    obs_r = {(g, kf_pos_r[kf.mnId], i) for g, mp in mps_r.items()
             for kf, i in mp.observations.items()}
    obs_g = {(g, kf_pos_g[kf.mnId], i) for g, mp in mps_g.items()
             for kf, i in mp.observations.items()}
    assert obs_r == obs_g, len(obs_r ^ obs_g)


# Measured on these fixtures (CPU, f32): KF centres within 2e-6 m and the
# median point within 2e-6 m of the reference after each entry point; the
# same observations erased. The bounds are the 1e-4 m the slice is held to.

def test_local_bundle_adjustment_matches_reference():
    ref, got = entry_maps()
    jba.local_bundle_adjustment(ref[1][-1], ref[0])
    pba.local_bundle_adjustment(got[1][-1], got[0], device="cpu")
    assert_maps_agree(ref, got)


@pytest.mark.parametrize("loop", [False, True], ids=["direct", "scratch"])
def test_global_bundle_adjustment_matches_reference(loop):
    ref, got = entry_maps()
    before = centres(got[1])
    for pkg, (wm, kfs, _) in ((jba, ref), (pba, got)):
        kw = {} if pkg is jba else {"device": "cpu"}
        pkg.global_bundle_adjustment(wm, iters=20,
                                     loop_kf=kfs[-1].mnId if loop else 0,
                                     **kw)
    if not loop:
        assert_maps_agree(ref, got, scale_gauge=True)
        return
    # results in the GBA scratch fields; the map itself untouched
    np.testing.assert_array_equal(centres(got[1]), before)
    assert all(kf.ba_global_for_kf == got[1][-1].mnId for kf in got[1])
    gba = lambda kfs: np.stack([-kf.gba_Rcw.T @ kf.gba_tcw for kf in kfs])
    assert_geometry_agrees(
        gba(ref[1]), gba(got[1]),
        np.stack([mp.gba_pos for mp in ref[2].values()]),
        np.stack([got[2][g].gba_pos for g in ref[2]]), scale_gauge=True)


def _fake_imu(n_kf):
    """tests/test_ba_entry.py's stationary-ish IMU (gravity only): weak but
    well-formed, and inconsistent with the trajectory."""
    n = 40
    meas = (np.tile(np.float32([0, 0, 9.81]), (n, 1)),
            np.zeros((n, 3), np.float32), np.full(n, 0.005, np.float32))
    return [meas] * (n_kf - 1), [np.zeros(3, np.float32)] * n_kf


def test_local_inertial_ba_matches_reference():
    """tests/test_ba_entry.py's LIBA fixture: its fake IMU contradicts the
    trajectory (initial chi2 1.8e8), which leaves the f32 solve
    ill-conditioned - the port's own f32 and f64 solves of this problem
    part by 3.3e-3 m in KF positions and 0.14 m in the worst point. So it
    is held to 1e-2 m and to observation sets differing in at most 2 %
    (measured against the reference: centres 2.8e-3 m, median point
    3.8e-3 m, 415 vs 409 observations kept); the well-conditioned
    visual-inertial comparison is the whole-slice test below."""
    ref, got = entry_maps(imu=_fake_imu(6))
    jba.local_inertial_ba(ref[1][-1], ref[0], b_large=True)
    pba.local_inertial_ba(got[1][-1], got[0], b_large=True, device="cpu")
    (_, kfs_r, mps_r), (_, kfs_g, mps_g) = ref, got
    assert_geometry_agrees(
        centres(kfs_r), centres(kfs_g),
        np.stack([mps_r[g].pos for g in mps_r]),
        np.stack([mps_g[g].pos for g in mps_r]), 1e-2, 1e-2)
    n_r = sum(len(mp.observations) for mp in mps_r.values())
    n_g = sum(len(mp.observations) for mp in mps_g.values())
    assert abs(n_r - n_g) <= 0.02 * n_r, (n_r, n_g)
    for kr, kg in zip(kfs_r, kfs_g):
        np.testing.assert_allclose(kg.velocity, kr.velocity, atol=1e-2)
        np.testing.assert_allclose(kg.bias, kr.bias, atol=1e-4)


@pytest.mark.parametrize("variant", ["full", "scale"])
def test_inertial_optimization_matches_reference(variant):
    """tests/test_inertial_init.py's recover-scale-and-gravity and
    scale-refinement fixtures. Measured: velocities within 1.7e-7, the
    biases 1.2e-6, gravity direction 1.9e-7, scale 3.3e-6 of the
    reference's."""
    Rs, ts, vs, segments = TI.simulate()
    prob = TI.build_problem(segments)
    if variant == "full":
        Rv = np.asarray(jso3.exp(jnp.asarray([0.15, -0.1, 0.3])), np.float32)
        R = np.einsum("ij,njk->nik", Rv, Rs).astype(np.float32)
        t = (ts @ Rv.T / 2.5).astype(np.float32)
        v = np.zeros_like(vs)
        kw = dict(prior_g=1e2, prior_a=1e6, iters=60)
    else:
        R, t, v = Rs, (ts / 1.3).astype(np.float32), (vs / 1.3).astype(
            np.float32)
        kw = dict(prior_g=0.0, prior_a=0.0, fix_vel_bias=True, iters=40)
    z3 = np.zeros(3, np.float32)
    args = (R, t, v, z3, z3, np.eye(3, dtype=np.float32), np.float32(1.0))
    ref = jax.device_get(jinit.inertial_optimization(
        *(jnp.asarray(a) for a in args), prob, **kw))
    got = pinit.inertial_optimization(
        *(torch.from_numpy(np.array(a)) for a in args),
        pinit.InertialInitProblem(*(torch.from_numpy(np.array(x))
                                    for x in prob)), **kw)
    for name, g, r in zip(("v", "bg", "ba", "Rwg", "scale"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5,
                                   rtol=1e-5, err_msg=name)


def test_gs_linearization_matches_jacfwd():
    """inertial_optimization's closed-form link linearization against
    torch.func.jacfwd of _gs_residual (the reference's jax.jacfwd) on random
    links, in f64. Measured: 1e-16 of the largest entry, the residuals
    within 1.8e-15; held to 1e-8 and 1e-10."""
    from torch.func import jacfwd, vmap

    from ppg_slam_tpu_torch.geometry import so3

    rng = np.random.RandomState(11)
    L = 16
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    rot = lambda k, s: t64(np.stack([so3.exp(rng.randn(3) * s)
                                     for _ in range(k)]))
    vec = lambda s: t64(rng.randn(L, 3) * s)
    mat = lambda s: t64(rng.randn(L, 3, 3) * s)
    R1, t1, R2, t2, v1, v2 = (rot(L, 0.5), vec(2.0), rot(L, 0.5), vec(2.0),
                              vec(1.0), vec(1.0))
    bg, ba = t64(rng.randn(3) * 0.02), t64(rng.randn(3) * 0.1)
    Rwg, log_s = rot(1, 0.3)[0], t64(0.4)
    link = (rot(L, 0.1), vec(1.0), vec(0.5), mat(0.1), mat(0.1), mat(0.1),
            mat(0.05), mat(0.05), t64(rng.randn(L, 6) * 0.02),
            t64(rng.uniform(0.05, 0.5, L)))
    r, Js = pinit._gs_linearization(R1, t1, R2, t2, v1, v2, bg, ba, Rwg,
                                    log_s, *link)
    z3, z2, z1 = (torch.zeros(k, dtype=torch.float64) for k in (3, 2, ()))

    def one(R1_, t1_, R2_, t2_, v1_, v2_, *lk):
        def f(dv1, dv2, dbg, dba, dgd, ds):
            out = pinit._gs_residual(dv1, dv2, bg + dbg, ba + dba, dgd, ds,
                                     R1_, t1_, v1_, R2_, t2_, v2_, Rwg,
                                     log_s, *lk)
            return out, out

        return jacfwd(f, argnums=tuple(range(6)), has_aux=True)(
            z3, z3, z3, z3, z2, z1)

    Jf, rf = vmap(one)(R1, t1, R2, t2, v1, v2, *link)
    assert float((r - rf).abs().max()) <= 1e-10
    scale = max(float(j.abs().max()) for j in Jf)
    for a, b in zip(Js, Jf):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-8 * scale


# ---------------------------------------------------------------------------
# the slice as a whole: tracking's pose-inertial step on a new frame, the
# frame made a keyframe, then local inertial BA - in both packages
# ---------------------------------------------------------------------------

KF_EVERY, N_KF = 4, 6


def _sequence_maps():
    seq = testing.SyntheticSequence(n_frames=KF_EVERY * N_KF + 3, seed=3)
    frames = list(range(0, KF_EVERY * N_KF, KF_EVERY))
    poses = [seq.frame_tcw(i) for i in frames]
    views = testing.render_views(seq.scene, poses)
    times = [seq.frame_times[i] for i in frames]
    links = testing.imu_links(seq, times)
    vels = [seq.frame_vels[i] for i in frames]
    dRs, dts, dps = testing.perturbation(N_KF, seq.scene.n, noise_pose=0.01,
                                         noise_pt=0.02)
    # the last KF as tracking leaves it (exact), the prior of the next frame
    dRs[-1], dts[-1] = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    pert = (dRs, dts, dps)
    maps = [testing.build_map(pkg, poses, views, seq.scene.points, pert,
                              times, (links, vels)) for pkg in (JAX, PORT)]
    return seq, maps, times


def _track_new_keyframe(pkg, seq, wmap, kfs, mps, t_last, jax_side):
    """The frame 3 steps past the last KF: predicted pose (truth perturbed),
    matches to every visible map point, pose_inertial_optimization against
    the last KF (fix_prev, as tracking after a keyframe), then made a
    keyframe of the map. Returns (state, inlier)."""
    i = KF_EVERY * N_KF + 2
    Rcw, tcw = seq.frame_tcw(i)
    (feats, ids), = testing.render_views(seq.scene, [(Rcw, tcw)])
    rig = wmap.rig
    from ppg_slam_tpu_torch.geometry import so3

    f = _frame(pkg, feats, seq.frame_times[i], rig,
               so3.exp(np.float32([0.004, -0.003, 0.002])) @ Rcw,
               tcw + np.float32([0.02, -0.01, 0.015]))
    m = seq.imu_between(t_last, seq.frame_times[i])
    p = pkg.Preintegrated(np.zeros(6), rig.nga, rig.nga_walk)
    p.integrate_measurements(
        m[:, :3].astype(np.float32), m[:, 3:6].astype(np.float32),
        np.diff(np.concatenate([[t_last], m[:, 6]])).astype(np.float32))
    last = kfs[-1]
    f.velocity = last.velocity.copy()
    matched = [(k, mps[g]) for k, g in enumerate(ids) if g in mps]
    X = np.stack([mp.pos for _, mp in matched]).astype(np.float32)
    uv = np.stack([f.kp_un[k] for k, _ in matched]).astype(np.float32)
    close = np.array([0 < np.linalg.norm(mp.pos - f.camera_center()) < 10
                      for _, mp in matched])
    pd = testing.preint_data(p, "cpu")
    state = [(last.imu_rotation(), last.imu_position(), last.velocity,
              last.bias[:3], last.bias[3:]),
             (f.imu_rotation(), f.imu_position(), f.velocity, f.bias[:3],
              f.bias[3:])]
    zero_prior = (np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3),
                  np.zeros(3), np.zeros((15, 15)))
    if jax_side:
        a = lambda x: jnp.asarray(np.asarray(x, np.float32))
        c, inl, _, _ = jax.device_get(jpose.pose_inertial_optimization(
            jpose.FrameVIState(*map(a, state[1])),
            jpose.FrameVIState(*map(a, state[0])),
            jpose.PreintData(*(a(x.numpy()) for x in pd)),
            jpose.Prior15(*map(a, zero_prior), valid=jnp.asarray(False)),
            a(X), a(uv), jnp.ones(len(X), bool), jnp.asarray(close),
            a(rig.Rcb), a(rig.tcb), pkg.cam, fix_prev=True))
    else:
        t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
        c, inl, _, _ = ppose.pose_inertial_optimization(
            ppose.FrameVIState(*map(t, state[1])),
            ppose.FrameVIState(*map(t, state[0])), pd,
            ppose.Prior15(*map(t, zero_prior),
                          valid=torch.zeros((), dtype=torch.bool)),
            t(X), t(uv), torch.ones(len(X), dtype=torch.bool),
            torch.from_numpy(close), t(rig.Rcb), t(rig.tcb), pkg.cam,
            fix_prev=True)
    c = [np.asarray(x) for x in c]
    inl = np.asarray(inl)
    f.set_imu_pose_velocity(c[0], c[1], c[2])
    f.bias = np.concatenate([c[3], c[4]]).astype(np.float32)
    for (k, mp), ok in zip(matched, inl):
        if ok:
            f.map_points[k] = mp
    kf = pkg.wm.KeyFrame(f, wmap)
    kf.prev_kf, last.next_kf = last, kf
    kf.preintegrated = p
    for k, mp in enumerate(kf.map_points):
        if mp is not None:
            mp.add_observation(kf, k)
    kf.update_connections()
    wmap.add_keyframe(kf)
    kfs.append(kf)
    return c, inl


def test_whole_slice_pose_inertial_then_local_inertial_ba():
    seq, (ref, got), times = _sequence_maps()
    out = [_track_new_keyframe(pkg, seq, *maps, times[-1], jax_side)
           for pkg, maps, jax_side in ((JAX, ref, True), (PORT, got, False))]
    (c_r, inl_r), (c_g, inl_g) = out
    np.testing.assert_array_equal(inl_g, inl_r)
    assert inl_g.mean() > 0.9, inl_g.mean()
    t_true = seq.frame_poses[KF_EVERY * N_KF + 2][1]
    assert np.abs(c_g[1] - t_true).max() < 5e-3
    for name, g, r in zip(("R", "t", "v", "bg", "ba"), c_g, c_r):
        np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)
    jba.local_inertial_ba(ref[1][-1], ref[0])
    pba.local_inertial_ba(got[1][-1], got[0], device="cpu")
    assert_maps_agree(ref, got)
    for kr, kg in zip(ref[1], got[1]):
        np.testing.assert_allclose(kg.velocity, kr.velocity, atol=1e-3)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    (_, _, _), (wm, kfs, _) = entry_maps(n_kf=3)
    for call in (lambda: pba.local_bundle_adjustment(kfs[-1], wm),
                 lambda: pba.local_inertial_ba(kfs[-1], wm),
                 lambda: pba.global_bundle_adjustment(wm)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_estimator_runs_without_jax(tmp_path):
    """The port imports neither jax nor ppg_slam_tpu, nor cv2 or PIL: all
    four are blocked in a fresh interpreter, which imports the pipeline
    (loop closing included), matching, Sim3, pose-graph, map-checkpoint,
    BoW (vocabulary training included), two-view and evaluation modules,
    the user entry points (datasets, the CLIs, the prefetcher, the viewer,
    the weight converter, ops/lines.py), the device mesh (parallel/),
    round-trips a PNG and runs
    local_inertial_ba on the CPU on a small synthetic sequence map."""
    code = textwrap.dedent("""
        import sys
        import os
        for blocked in ("jax", "ppg_slam_tpu", "cv2", "PIL"):
            sys.modules[blocked] = None
        import numpy as np
        import ppg_slam_tpu_torch.bow
        import ppg_slam_tpu_torch.bow.train
        import ppg_slam_tpu_torch.cli.evaluate
        import ppg_slam_tpu_torch.cli.mono_inertial
        import ppg_slam_tpu_torch.cli.train_vocabulary
        import ppg_slam_tpu_torch.datasets.clahe
        import ppg_slam_tpu_torch.frontend.prefetch
        import ppg_slam_tpu_torch.models.convert_weights
        import ppg_slam_tpu_torch.ops.lines
        import ppg_slam_tpu_torch.parallel
        import ppg_slam_tpu_torch.viz
        from ppg_slam_tpu_torch.datasets import (load_euroc, read_gray,
                                                 write_png)
        import ppg_slam_tpu_torch.estimator.pose_graph
        import ppg_slam_tpu_torch.geometry.sim3
        import ppg_slam_tpu_torch.geometry.two_view
        import ppg_slam_tpu_torch.matching
        import ppg_slam_tpu_torch.matching.sim3_solver
        import ppg_slam_tpu_torch.pipeline.local_mapping
        import ppg_slam_tpu_torch.pipeline.loop_closing
        import ppg_slam_tpu_torch.pipeline.system
        import ppg_slam_tpu_torch.pipeline.tracking
        import ppg_slam_tpu_torch.worldmap.serialize
        import ppg_slam_tpu_torch.utils.evaluation
        from ppg_slam_tpu_torch import testing
        from ppg_slam_tpu_torch.estimator.ba import local_inertial_ba
        from ppg_slam_tpu_torch.imu import Preintegrated
        from ppg_slam_tpu_torch.worldmap import (Frame, KeyFrame, Map,
                                                 MapPoint, Rig)
        seq = testing.SyntheticSequence(n_frames=13, seed=3)
        rig = Rig(testing.CAM)
        wm = Map(rig)
        mps, prev = {}, None
        for i in range(0, 13, 4):
            feats, ids = seq.scene.render(*seq.frame_tcw(i))
            f = Frame(feats, seq.frame_times[i], rig)
            f.set_pose(*seq.frame_tcw(i))
            kf = KeyFrame(f, wm)
            kf.velocity = seq.frame_vels[i]
            if prev is not None:
                m = seq.imu_between(prev.timestamp, kf.timestamp)
                p = Preintegrated(np.zeros(6), rig.nga, rig.nga_walk,
                                  device="cpu")
                p.integrate_measurements(m[:, :3], m[:, 3:6],
                                         np.full(len(m), 0.005))
                kf.preintegrated, kf.prev_kf, prev.next_kf = p, prev, kf
            for k, g in enumerate(ids):
                if g not in mps:
                    mps[g] = MapPoint(seq.scene.points[g] + 0.01, kf)
                    wm.add_map_point(mps[g])
                mps[g].add_observation(kf, k)
                kf.add_map_point(mps[g], k)
            wm.add_keyframe(kf)
            prev = kf
        local_inertial_ba(prev, wm, device="cpu")
        img = (np.arange(48 * 64) % 251).astype(np.uint8).reshape(48, 64)
        write_png(os.path.join(sys.argv[1], "a.png"), img)
        assert (read_gray(os.path.join(sys.argv[1], "a.png")) == img).all()
        err = np.median([np.linalg.norm(mp.pos - seq.scene.points[g])
                         for g, mp in mps.items() if not mp.is_bad()])
        assert err < 5e-3, err
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "ppg_slam_tpu",
                                           "cv2", "PIL")
                       for m, v in sys.modules.items() if v is not None)
        print("ok", len(mps), err)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok"), proc.stdout
