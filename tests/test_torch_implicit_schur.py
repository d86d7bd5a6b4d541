"""The port's implicit-Schur reduced solve (ba_core.solve_ba(implicit=True))
against its dense route and against the reference's solve_ba(slot_k=, kfm=),
and the route ba._padded_solve takes: implicit from IMPLICIT_MIN_KF (65)
keyframes with a PCG pose solve, dense below or with Cholesky.

The implicit route solves the same reduced system as the dense fold, to
round-off: its first step lies as close to an f64 solve as the dense
route's (2.7e-4 m against 4.4e-4 m in KF positions on make_vi_problem's
default 6-KF problem, CPU, f32), so its matvecs run in f32, as the
reference's do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ppg_slam_tpu.estimator import ba as JBA
from ppg_slam_tpu.estimator import ba_core as J
from ppg_slam_tpu.parallel import make_vi_problem as j_make_vi_problem

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch import worldmap as pwm
from ppg_slam_tpu_torch.estimator import ba
from ppg_slam_tpu_torch.estimator import ba_core as P
from ppg_slam_tpu_torch.parallel import make_vi_problem
from ppg_slam_tpu_torch.utils import profiler

EYE = torch.eye(3)
Z3 = torch.zeros(3)
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


def both_routes(states, points, prob, kf_dof, mp_free, cam, **kw):
    opts = P.BAOptions(tol=0.0, pose_cg_iters=64, backtrack=False, **kw)
    return [P.solve_ba(states, points, prob, kf_dof, mp_free, EYE, Z3, cam,
                       opts, implicit=implicit)
            for implicit in (False, True)]


def test_implicit_matches_dense_on_vi_problem():
    """Six iterations on test_torch_ba_core.py's 5-KF make_vi_problem
    (colines, inertial links, random walks, a 15-D prior, bias priors). Its
    reduced system is ill-conditioned along weak modes, where every f32
    route parts from an f64 solve of it by millimetres (measured after six
    iterations: dense PCG 1.1e-3 m, dense Cholesky 2.0e-3 m, implicit
    3.1e-3 m in points; the implicit route in f64 lies 6e-8 m from the dense
    route in f64). Measured implicit against dense PCG: final chi2 within
    2.6e-5 relative, KF positions within 8.5e-5 m, points within 3.0e-3 m.
    Held to the limits the port meets against the reference on this
    problem (test_torch_ba_core.py): 5e-4, 1e-3 m and 1e-2 m."""
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        **VI_5KF, device="cpu")
    (st_d, pts_d, i_d), (st_i, pts_i, i_i) = both_routes(
        states, points, prob, kf_dof, mp_free, cam, iters=6, lambda0=1e-2)
    c_d, c_i = float(i_d["final_chi2"]), float(i_i["final_chi2"])
    assert c_d < 0.2 * float(i_d["chi2_hist"][0])
    assert abs(c_i - c_d) <= 5e-4 * c_d
    assert float((st_i.t - st_d.t).abs().max()) <= 1e-3
    assert float((pts_i - pts_d).abs().max()) <= 1e-2
    assert i_i["iters_run"] == i_d["iters_run"] == 6


def test_implicit_matches_dense_on_euroc_window():
    """The FIBA residual set of an 8-keyframe EuRoC-width window (752x480,
    2602 observations, 79 colines, 7 inertial links), KF 0's pose fixed,
    five iterations with PCG(64) on both routes. Measured: final chi2
    within 1.0e-6 relative, KF positions within 5.8e-5 m, median point
    within 1.9e-4 m (both routes 1.4e-2 m from an f64 Cholesky solve: the
    capped PCG, not the route, sets that). Held to 1e-4 relative and
    1e-3 m."""
    win = testing.EurocWindow(seed=1, n_kf=8, n_points=1800)
    pwm.reset_ids()
    wmap = win.build(testing.port_namespace("cpu", testing.EUROC_CAM))[0]
    states, points, prob, kfs, mps = ba._gather_full_problem(wmap)
    kf_dof = np.ones((len(kfs), 15), bool)
    kf_dof[0, :6] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (P.KFStates(*map(t, states)), t(points),
            P.BAProblem(*map(t, prob)), t(kf_dof),
            torch.ones(len(mps), dtype=torch.bool))
    (st_d, pts_d, i_d), (st_i, pts_i, i_i) = both_routes(
        *args, testing.EUROC_CAM, iters=5, lambda0=1e-5,
        reproj_kernel="huber")
    c_d, c_i = float(i_d["final_chi2"]), float(i_i["final_chi2"])
    assert c_d < 0.5 * float(i_d["chi2_hist"][0])
    assert abs(c_i - c_d) <= 1e-4 * c_d
    assert float((st_i.t - st_d.t).abs().max()) <= 1e-3
    assert float((pts_i - pts_d).norm(dim=1).median()) <= 1e-3


def test_implicit_matches_reference_slot_kfm(monkeypatch):
    """The port's implicit route against the reference's (solve_ba with
    slot_k and kfm, its one-hot assembly forced on the CPU): the same
    numpy problem, laid out slot-major and kf-major for the reference with
    its own _slot_layout / _kfm_layout, its per-observation chi2 mapped back
    to the caller's rows. Four iterations on test_torch_ba_core.py's 5-KF
    make_vi_problem, where the f32 routes of both packages lie within
    1.6e-4 m of an f64 solve (on make_vi_problem(seed=5) even the
    reference's dense route parts from it by 1.7e-3 m, so it cannot tell a
    route from round-off). Measured: KF positions within 3.5e-5 m, points
    within 7.5e-4 m, final chi2 within 3.9e-5 relative, per-observation
    chi2 within 8.6e-4. Held to the limits the port meets against the
    reference's dense route on this problem (test_torch_ba_core.py: 1e-3 m,
    1e-2 m, 5e-4) and 1e-2 per observation."""
    monkeypatch.setenv("PPG_FORCE_ONEHOT", "1")
    jcam, jst, jpts, jprob, jdof, jfree = j_make_vi_problem(**VI_5KF)
    n, m = jst.R.shape[0], jpts.shape[0]
    r_mp = np.asarray(jprob.r_mp)
    rows, K, n_tail = JBA._slot_layout(r_mp, m)
    O = m * K + n_tail
    lay = dict(r_kf=np.zeros(O, np.int32), r_uv=np.zeros((O, 2), np.float32),
               r_valid=np.zeros(O, bool),
               r_mp=(np.arange(O) // K).astype(np.int32))
    for name in lay:
        lay[name][rows] = np.asarray(getattr(jprob, name))
    perm, mask = JBA._kfm_layout(lay["r_kf"], lay["r_valid"], n)
    kw = dict(iters=4, lambda0=1e-2, tol=0.0, pose_cg_iters=64,
              backtrack=False)
    s1, p1, i1 = jax.device_get(J.solve_ba(
        jst, jpts, jprob._replace(**{k: jnp.asarray(v)
                                     for k, v in lay.items()}),
        jdof, jfree, jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), jcam, J.BAOptions(**kw),
        slot_k=K, kfm=(jnp.asarray(perm), jnp.asarray(mask))))

    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        **VI_5KF, device="cpu")
    s2, p2, i2 = P.solve_ba(states, points, prob, kf_dof, mp_free, EYE, Z3,
                            cam, P.BAOptions(**kw), implicit=True)
    assert i2["iters_run"] == int(i1["iters_run"]) == 4
    assert np.abs(s2.t.numpy() - np.asarray(s1.t)).max() <= 1e-3
    assert np.abs(p2.numpy() - np.asarray(p1)).max() <= 1e-2
    c1 = float(i1["final_chi2"])
    assert abs(float(i2["final_chi2"]) - c1) <= 5e-4 * c1
    np.testing.assert_allclose(i2["obs_chi2"].numpy(),
                               np.asarray(i1["obs_chi2"])[rows],
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n_kf,pose_cg,route", [
    (65, 64, "implicit"), (64, 64, "dense"), (65, 0, "dense")],
    ids=["65kf-pcg", "64kf-pcg", "65kf-cholesky"])
def test_padded_solve_route(n_kf, pose_cg, route):
    """ba._padded_solve, the solve of every BA entry point, goes implicit
    exactly from IMPLICIT_MIN_KF = 65 keyframes with a PCG pose solve; read
    from the profiler's per-route counters. A make_vi_problem chain of
    n_kf keyframes, ~32 observations each."""
    assert ba.IMPLICIT_MIN_KF == 65
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        n_kf=n_kf, n_mp=192, n_obs=32 * n_kf, n_col=16, seed=2,
        device="cpu")
    host = lambda xs: type(xs)(*(x.numpy() for x in xs))
    profiler.reset()
    _, _, info = ba._padded_solve(
        host(states), points.numpy(), host(prob), kf_dof.numpy(),
        mp_free.numpy(), pwm.Rig(cam),
        P.BAOptions(iters=2, lambda0=1e-2, pose_cg_iters=pose_cg), "cpu")
    assert float(info["final_chi2"]) < float(info["chi2_hist"][0])
    c = profiler.counters
    assert c.get("device.solve_ba.cpu") == 1
    assert c.get("device.solve_ba_implicit.cpu", 0) == (route == "implicit")
    assert "device.solve_ba_sharded.cpu" not in c


def test_implicit_with_cholesky_raises():
    """No Cholesky on an implicit operator: a pose solve that resolves to
    Cholesky (pose_cg_iters=0, or None on the CPU) raises."""
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        n_kf=4, n_mp=48, n_obs=96, n_col=8, device="cpu")
    for cg in (0, None):
        with pytest.raises(ValueError, match="implicit"):
            P.solve_ba(states, points, prob, kf_dof, mp_free, EYE, Z3, cam,
                       P.BAOptions(iters=1, pose_cg_iters=cg),
                       implicit=True)
