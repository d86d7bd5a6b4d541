"""The port's device mesh (ppg_slam_tpu_torch.parallel) on the CPU: Mesh,
pad_problem_for_mesh and make_vi_problem against the reference's,
solve_ba_sharded over four CPU shards against the single-device solve (dense
and implicit routes) and against the reference's solve_ba_sharded on a
4-device virtual CPU mesh, global_bundle_adjustment and full_inertial_ba
with mesh= against no mesh, and PPGExtractor.extract_batch(mesh=) bit-equal
to extract_batch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from ppg_slam_tpu.estimator import ba_core as J
from ppg_slam_tpu.parallel import make_vi_problem as j_make_vi_problem
from ppg_slam_tpu.parallel import pad_problem_for_mesh as j_pad
from ppg_slam_tpu.parallel import solve_ba_sharded as j_solve_ba_sharded

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch import worldmap as pwm
from ppg_slam_tpu_torch.estimator import ba
from ppg_slam_tpu_torch.estimator import ba_core as P
from ppg_slam_tpu_torch.frontend import PPGExtractor
from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel
from ppg_slam_tpu_torch.parallel import (Mesh, dryrun_sharded_ba_step,
                                         make_vi_problem,
                                         pad_problem_for_mesh,
                                         solve_ba_sharded)
from ppg_slam_tpu_torch.utils import profiler

EYE = torch.eye(3)
Z3 = torch.zeros(3)
CPU4 = Mesh(["cpu"] * 4)
# test_torch_ba_core.py's make_vi_problem
VI_5KF = dict(n_kf=5, n_mp=48, n_obs=160, n_col=12, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under a parallel test run, torch's intra-op pool only oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_of_an_absent_device_raises():
    """A mesh naming a CUDA card the machine lacks raises at construction
    (it never runs those shards elsewhere); an empty mesh raises too."""
    absent = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError, match="not present"):
        Mesh(["cpu", absent])
    with pytest.raises(ValueError):
        Mesh([])
    m = Mesh(["cpu", "cpu", "cpu"])
    assert m.size == 3 and m.lead == torch.device("cpu")
    parts = [torch.full((2,), float(k)) for k in range(3)]
    assert torch.equal(m.psum(parts), torch.full((2,), 3.0))


@pytest.mark.parametrize("args", [
    dict(), VI_5KF, dict(n_kf=4, n_mp=16, n_obs=37, n_col=5, seed=1,
                         noise=0.05)], ids=["default", "5kf", "small"])
def test_make_vi_problem_equals_reference(args):
    """The same numbers from the same seed: states, points, every problem
    field, masks (index fields compared as values: int32 there, int64
    here)."""
    ref = j_make_vi_problem(**args)
    got = make_vi_problem(**args, device="cpu")
    (jcam, *jarrs), (pcam, *parrs) = ref, got
    assert all(getattr(jcam, k) == getattr(pcam, k) for k in
               ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height"))
    jst, jpts, jprob, jdof, jfree = jarrs
    pst, ppts, pprob, pdof, pfree = parrs
    pairs = (list(zip(jst, pst)) + [(jpts, ppts), (jdof, pdof),
                                     (jfree, pfree)]
             + list(zip(jprob, pprob)))
    for r, g in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n_dev", [3, 8])
def test_pad_problem_for_mesh_equals_reference(n_dev):
    """Every field padded to a multiple of n_dev exactly as the reference
    pads it (its tests/test_parallel.py problem)."""
    args = dict(n_kf=4, n_mp=16, n_obs=37, n_col=5)
    jprob = j_make_vi_problem(**args)[3]
    pprob = make_vi_problem(**args, device="cpu")[3]
    ref = j_pad(jprob, n_dev)
    got = pad_problem_for_mesh(pprob, n_dev, device="cpu")
    host = pad_problem_for_mesh(P.BAProblem(*(x.numpy() for x in pprob)),
                                n_dev, device="cpu")
    for name, r, g, h in zip(P.BAProblem._fields, ref, got, host):
        assert g.shape[0] % n_dev == 0, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), name)
        assert torch.equal(g, h), name


def _sharded_and_single(implicit, mesh=CPU4, **kw):
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        **VI_5KF, device="cpu")
    opts = P.BAOptions(tol=0.0, **kw)
    single = P.solve_ba(states, points, prob, kf_dof, mp_free, EYE, Z3, cam,
                        opts, implicit=implicit)
    profiler.reset()
    sharded = solve_ba_sharded(states, points, prob, kf_dof, mp_free, EYE,
                               Z3, cam, opts, mesh, implicit=implicit)
    return single, sharded, prob


@pytest.mark.parametrize("route", ["dense", "implicit"])
def test_sharded_equals_single_device(route):
    """Six iterations over four CPU shards (160 observations, 12 colines, 4
    links, one prior, one bias prior: the shards' last rows are padding)
    against the single-device solve; the dense route with the CPU's
    Cholesky, the implicit with PCG(64). This problem's reduced system is
    ill-conditioned: a change of summation order moves its points by
    millimetres (test_torch_implicit_schur.py). Measured (dense,
    implicit): the same iterations, final chi2 within 6.3e-5 and 1.1e-4
    relative, KF positions within 6.1e-5 m and 9.9e-5 m, points within
    3.3e-3 m and 6.2e-3 m, per-observation chi2 within 6.7e-4 and 8.9e-4,
    depths within 9e-4 m and 6.2e-3 m. Held to the port's limits against
    the reference on this problem (test_torch_ba_core.py: 5e-4, 1e-3 m,
    1e-2 m), 1e-2 per observation and 1e-2 m in depth."""
    implicit = route == "implicit"
    (st1, p1, i1), (st4, p4, i4), prob = _sharded_and_single(
        implicit, iters=6, lambda0=1e-2,
        pose_cg_iters=64 if implicit else None)
    assert profiler.counters == {
        "device.solve_ba.cpu": 1, "device.solve_ba_sharded.cpu": 1,
        **({"device.solve_ba_implicit.cpu": 1} if implicit else {})}
    assert i4["iters_run"] == i1["iters_run"] == 6
    c1 = float(i1["final_chi2"])
    assert c1 < 0.2 * float(i1["chi2_hist"][0])
    assert abs(float(i4["final_chi2"]) - c1) <= 5e-4 * c1
    assert float((st4.t - st1.t).abs().max()) <= 1e-3
    assert float((p4 - p1).abs().max()) <= 1e-2
    n_obs = prob.r_kf.shape[0]
    assert i4["obs_chi2"].shape == i4["obs_depth"].shape == (n_obs,)
    torch.testing.assert_close(i4["obs_chi2"], i1["obs_chi2"], rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(i4["obs_depth"], i1["obs_depth"], rtol=0,
                               atol=1e-2)


def test_sharded_matches_reference_sharded():
    """The port's solve_ba_sharded over four CPU shards against the
    reference's over four virtual CPU devices (the dense route both sides,
    the CPU's Cholesky), four iterations on the same numpy problem.
    Measured: KF positions within 1.4e-4 m, points within 6.3e-4 m, final
    chi2 within 8.0e-5 relative, per-observation chi2 within 4.2e-4. Held
    to the port's limits against the reference on this problem
    (test_torch_ba_core.py: 1e-3 m, 1e-2 m, 5e-4) and 1e-2 per
    observation."""
    kw = dict(iters=4, lambda0=1e-2, tol=0.0)
    jcam, jst, jpts, jprob, jdof, jfree = j_make_vi_problem(**VI_5KF)
    jmesh = JMesh(np.array(jax.devices("cpu")[:4]), ("dp",))
    s1, p1, i1 = jax.device_get(j_solve_ba_sharded(
        jst, jpts, jprob, jdof, jfree, jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), jcam, J.BAOptions(**kw), jmesh))
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        **VI_5KF, device="cpu")
    s2, p2, i2 = solve_ba_sharded(states, points, prob, kf_dof, mp_free, EYE,
                                  Z3, cam, P.BAOptions(**kw), CPU4)
    assert i2["iters_run"] == int(i1["iters_run"]) == 4
    assert np.abs(s2.t.numpy() - np.asarray(s1.t)).max() <= 1e-3
    assert np.abs(p2.numpy() - np.asarray(p1)).max() <= 1e-2
    c1 = float(i1["final_chi2"])
    assert abs(float(i2["final_chi2"]) - c1) <= 5e-4 * c1
    n_obs = prob.r_kf.shape[0]
    np.testing.assert_allclose(i2["obs_chi2"].numpy(),
                               np.asarray(i1["obs_chi2"])[:n_obs],
                               rtol=1e-2, atol=1e-2)


def test_dryrun_sharded_ba_step():
    profiler.reset()
    dryrun_sharded_ba_step(CPU4)
    assert profiler.counters["device.solve_ba_sharded.cpu"] == 2
    assert profiler.counters["device.solve_ba_implicit.cpu"] == 1


def _centres(kfs):
    return np.stack([kf.camera_center() for kf in kfs])


def _points(mps):
    return np.stack([mp.pos for mp in mps])


def test_global_bundle_adjustment_mesh_equals_no_mesh():
    """global_bundle_adjustment(mesh=) over three CPU shards against the
    same call without a mesh on a clone of testing.small_gba_map. Only KF 0
    is fixed, so the visual GBA keeps a free scale, which the summation
    order moves (by 1.2e-3 here): it is divided out about KF 0, as
    chip_smoke.py's phase 8 does. Measured: centres within 4.2e-7 m, median
    point within 2.0e-6 m, final chi2 within 4.5e-6 relative. Held to
    1e-4 m and 1e-4."""
    pwm.reset_ids()
    base = testing.small_gba_map()
    import copy

    (m1, k1, _), (m3, k3, _) = copy.deepcopy(base), copy.deepcopy(base)
    profiler.reset()
    out3 = ba.global_bundle_adjustment(m1, iters=6, mesh=Mesh(["cpu"] * 3))
    assert profiler.counters["device.solve_ba_sharded.cpu"] >= 1
    out1 = ba.global_bundle_adjustment(m3, iters=6, device="cpu")
    assert out3["final_chi2"] < 0.5 * out3["initial_chi2"]
    assert abs(out3["final_chi2"] - out1["final_chi2"]) \
        <= 1e-4 * out1["final_chi2"]
    c1, c3 = _centres(k1), _centres(k3)
    o = c3[0]
    scale = float(np.median(np.linalg.norm(c3[1:] - o, axis=1)
                            / np.linalg.norm(c1[1:] - o, axis=1)))
    assert abs(scale - 1.0) < 1e-2
    assert np.abs(scale * (c1 - o) - (c3 - o)).max() <= 1e-4
    pts = lambda m: _points(sorted(m.all_map_points(), key=lambda p: p.mnId))
    d = np.linalg.norm(scale * (pts(m1) - o) - (pts(m3) - o), axis=1)
    assert np.median(d) <= 1e-4


def test_full_inertial_ba_mesh_equals_no_mesh():
    """full_inertial_ba(mesh=) over four CPU shards against no mesh, on an
    8-keyframe EuRoC-width window with its IMU links (Cholesky on the CPU,
    the conformal search on the lead device). Measured: centres within
    2.4e-5 m, median point within 6.3e-5 m, velocities and biases within
    1.8e-5, final chi2 within 9.2e-7 relative, no conformal step on either
    side. Held to chip_smoke.py's phase-8 limits on CUDA against the CPU
    (1e-3 m, 1e-3) and 1e-4 in chi2."""
    win = testing.EurocWindow(seed=1, n_kf=8, n_points=1800)
    pns = testing.port_namespace("cpu", testing.EUROC_CAM)
    pwm.reset_ids()
    m1 = win.build(pns)
    pwm.reset_ids()
    m4 = win.build(pns)
    profiler.reset()
    out4 = ba.full_inertial_ba(m4[0], iters=10, mesh=CPU4)
    assert profiler.counters["device.solve_ba_sharded.cpu"] >= 1
    out1 = ba.full_inertial_ba(m1[0], iters=10, device="cpu")
    assert out4["final_chi2"] < out4["initial_chi2"]
    assert abs(out4["final_chi2"] - out1["final_chi2"]) \
        <= 1e-4 * out1["final_chi2"]
    assert out4["conformal_scales"] == pytest.approx(
        out1["conformal_scales"], rel=1e-4)
    assert np.abs(_centres(m4[1]) - _centres(m1[1])).max() <= 1e-3
    d = np.linalg.norm(_points(m4[2].values()) - _points(m1[2].values()),
                       axis=1)
    assert np.median(d) <= 1e-3
    vb = lambda kfs: np.stack([np.concatenate([k.velocity, k.bias])
                               for k in kfs])
    assert np.abs(vb(m4[1]) - vb(m1[1])).max() <= 1e-3


def _frames(n, h=128, w=160, seed=4):
    """Grid, bars and noise, shifted a little each frame
    (test_torch_prefetch.py's)."""
    rng = np.random.RandomState(seed)
    base = np.full((h, w + 4 * n), 110, np.int32)
    for k in range(1, 8):
        base[:, k * 23 + 3 * k * k % 17] = 230
    for k in range(1, 5):
        base[k * 27, :] = 20
    out = []
    for i in range(n):
        img = base[:, 3 * i:3 * i + w] + rng.randint(-12, 12, (h, w))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def cpu_extractor():
    cam = CameraModel(kind=CAM_PINHOLE, fx=120.0, fy=120.0, cx=80.0,
                      cy=64.0, dist=(0.0, 0.0, 0.0, 0.0), width=160,
                      height=128)
    return PPGExtractor(cam, device="cpu")


def _assert_same_features(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.n_kp == r.n_kp and r.n_kp > 10
        for name in ("kp_pos", "kp_pos_un", "kp_score", "kp_out", "edges",
                     "edge_score", "colines", "desc"):
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name),
                                          err_msg=name)
        assert g.connected == r.connected


@pytest.mark.parametrize("n_frames,n_shards", [(4, 2), (6, 4)],
                         ids=["4-frames-2-shards", "6-frames-4-shards"])
def test_extract_batch_mesh_is_bit_equal(cpu_extractor, n_frames, n_shards):
    """extract_batch(mesh=) equals extract_batch bit for bit; 6 frames on 4
    shards pad to 8 (the last frame repeated) and return 6, in order, from
    a list of frames and from a (B, H, W) tensor; the async call too."""
    frames = _frames(n_frames)
    ref = cpu_extractor.extract_batch(frames)
    mesh = Mesh(["cpu"] * n_shards)
    _assert_same_features(cpu_extractor.extract_batch(frames, mesh=mesh),
                          ref)
    stack = torch.from_numpy(np.stack(frames))
    _assert_same_features(cpu_extractor.extract_batch(stack, mesh=mesh), ref)
    _assert_same_features(
        cpu_extractor.extract_batch_async(frames, mesh=mesh).result(), ref)
