"""The port's BA core (ppg_slam_tpu_torch.estimator.ba_core) against
ppg_slam_tpu's: one linearization term by term, the analytic reprojection
Jacobians against torch.func.jacfwd, and solve_ba with Cholesky, with PCG
and with backtracking on the fixtures of tests/test_estimator.py
(converging visual BA, the colines fixture and the robust-outlier fixture,
rebuilt here from their recipe with a seed of this file's own) and on
make_vi_problem's visual-inertial problem with colines, links and priors.

Both packages get the same float32 numpy inputs. The JAX solve is jitted
with BAOptions as a pytree, so its kernels reach it as codes."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import jax
import jax.numpy as jnp
from ppg_slam_tpu.estimator import ba_core as J
from ppg_slam_tpu.geometry.cameras import CameraModel as JCamera
from ppg_slam_tpu.parallel import make_vi_problem

from ppg_slam_tpu_torch.estimator import ba_core as P
from ppg_slam_tpu_torch.geometry import so3
from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel

CAM_KW = dict(kind=CAM_PINHOLE, fx=400.0, fy=400.0, cx=320.0, cy=240.0,
              dist=(0.0, 0.0, 0.0, 0.0), width=640, height=480)
JCAM, PCAM = JCamera(**CAM_KW), CameraModel(**CAM_KW)
EYE = np.eye(3, dtype=np.float32)
Z3 = np.zeros(3, np.float32)
CAM_FIELDS = ("kind", "fx", "fy", "cx", "cy", "dist", "width", "height")


def _t(x):
    return torch.from_numpy(np.array(x))


def port_problem(jprob):
    return P.BAProblem(*(_t(x) for x in jprob))


# ---------------------------------------------------------------------------
# tests/test_estimator.py's world: cameras on an arc before a point cloud
# ---------------------------------------------------------------------------

def make_world(rng, n_kf=6, n_mp=60):
    points = np.stack([rng.uniform(-2, 2, n_mp), rng.uniform(-1.5, 1.5, n_mp),
                       rng.uniform(4, 8, n_mp)], 1).astype(np.float32)
    R, t = [], []
    for k in range(n_kf):
        R.append(so3.exp(np.float32([0.0, 0.05 * (k - n_kf / 2), 0.0])))
        t.append(np.array([0.5 * k, 0.02 * k, 0.1 * np.sin(k)], np.float32))
    return points, np.stack(R).astype(np.float32), np.stack(t)


def build_problem(rng, points, Rwb, twb, coline_idx=None):
    """Every (kf, mp) observed, exactly (body frame == camera frame); one
    invalid row in each other family, as the reference's fixture pads."""
    n_kf, n_mp = len(Rwb), len(points)
    Xc = np.einsum("kji,kmj->kmi", Rwb, points[None] - twb[:, None])
    uv = np.stack([400 * Xc[..., 0] / Xc[..., 2] + 320,
                   400 * Xc[..., 1] / Xc[..., 2] + 240], -1)
    n_col = 1 if coline_idx is None else len(coline_idx)
    prob = J.empty_problem(n_obs=n_kf * n_mp, n_col=n_col, n_links=1,
                           n_priors=1, n_bp=1)
    prob = prob._replace(
        r_kf=jnp.asarray(np.repeat(np.arange(n_kf), n_mp), jnp.int32),
        r_mp=jnp.asarray(np.tile(np.arange(n_mp), n_kf), jnp.int32),
        r_uv=jnp.asarray(uv.reshape(-1, 2).astype(np.float32)),
        r_valid=jnp.ones(n_kf * n_mp, bool))
    if coline_idx is not None:
        prob = prob._replace(
            c_idx=jnp.asarray(np.asarray(coline_idx, np.int32)),
            c_w=jnp.full((n_col,), 50.0, jnp.float32),
            c_valid=jnp.ones(n_col, bool))
    return prob


def states_of(R, t):
    z = np.zeros((len(t), 3), np.float32)
    return (R.astype(np.float32), t.astype(np.float32), z, z, z)


def fixture_converge():
    """TestVisualBA.test_converges_to_ground_truth: KFs 2.. and every point
    perturbed, the first two KFs fixed (the gauge)."""
    rng = np.random.RandomState(101)
    points, Rwb, twb = make_world(rng)
    prob = build_problem(rng, points, Rwb, twb)
    Rn, tn = Rwb.copy(), twb.copy()
    for k in range(2, len(Rwb)):
        Rn[k] = so3.exp(rng.randn(3).astype(np.float32) * 0.02) @ Rn[k]
        tn[k] += rng.randn(3).astype(np.float32) * 0.05
    pn = points + rng.randn(*points.shape).astype(np.float32) * 0.05
    kf_dof = np.zeros((len(Rwb), 15), bool)
    kf_dof[2:, :6] = True
    return (states_of(Rn, tn), pn, prob, kf_dof, np.ones(len(points), bool),
            dict(iters=15, lambda0=1e-5))


def fixture_colines():
    """TestVisualBA.test_coline_constraint_pulls_points_to_line: the middle
    of three collinear points pushed off the line, both cameras fixed."""
    rng = np.random.RandomState(102)
    points, Rwb, twb = make_world(rng, n_kf=2, n_mp=9)
    points[1] = 0.5 * (points[0] + points[2])
    prob = build_problem(rng, points, Rwb, twb, coline_idx=[[0, 1, 2]])
    pn = points.copy()
    pn[1] += np.float32([0.05, -0.04, 0.06])
    return (states_of(Rwb, twb), pn, prob, np.zeros((2, 15), bool),
            np.ones(9, bool), dict(iters=10, lambda0=1e-4))


def fixture_robust():
    """TestVisualBA.test_robust_kernel_rejects_outliers: 20 observations
    displaced by 80 px (Cauchy weights them down)."""
    rng = np.random.RandomState(103)
    points, Rwb, twb = make_world(rng)
    prob = build_problem(rng, points, Rwb, twb)
    uv = np.asarray(prob.r_uv).copy()
    bad = rng.choice(len(uv), 20, replace=False)
    uv[bad] += rng.randn(20, 2).astype(np.float32) * 80.0
    prob = prob._replace(r_uv=jnp.asarray(uv))
    tn = twb.copy()
    tn[2:] += rng.randn(len(twb) - 2, 3).astype(np.float32) * 0.03
    kf_dof = np.zeros((len(Rwb), 15), bool)
    kf_dof[2:, :6] = True
    return (states_of(Rwb, tn), points, prob, kf_dof,
            np.ones(len(points), bool), dict(iters=15, lambda0=1e-5))


FIXTURES = {"converge": fixture_converge, "colines": fixture_colines,
            "robust": fixture_robust}
SOLVERS = {"cholesky": dict(pose_cg_iters=0, backtrack=False),
           "pcg": dict(pose_cg_iters=64, backtrack=False),
           "backtrack": dict(pose_cg_iters=0, backtrack=True)}


def run_both(states, points, prob, kf_dof, mp_free, opts, cam=None):
    """solve_ba in both packages on the same numpy; (ref, got) as numpy
    (t, points, final_chi2, iters_run, obs_chi2)."""
    jcam, pcam = (JCAM, PCAM) if cam is None else cam
    s1, p1, i1 = J.solve_ba(
        J.KFStates(*(jnp.asarray(x) for x in states)), jnp.asarray(points),
        prob, jnp.asarray(kf_dof), jnp.asarray(mp_free), jnp.asarray(EYE),
        jnp.asarray(Z3), jcam, J.BAOptions(**opts))
    s1, p1, i1 = jax.device_get((s1, p1, i1))
    s2, p2, i2 = P.solve_ba(
        P.KFStates(*(_t(x) for x in states)), _t(points), port_problem(prob),
        _t(kf_dof), _t(mp_free), _t(EYE), _t(Z3), pcam, P.BAOptions(**opts))
    ref = (np.asarray(s1.t), np.asarray(p1), float(i1["final_chi2"]),
           int(i1["iters_run"]), np.asarray(i1["obs_chi2"]))
    got = (s2.t.numpy(), p2.numpy(), float(i2["final_chi2"]),
           i2["iters_run"], i2["obs_chi2"].numpy())
    return ref, got


# Measured on these fixtures (CPU, f32), all three solvers: KF positions
# within 1e-6 m and the median point within 6e-7 m of the reference's,
# final chi2 within 3e-7 of it, and the same observations under the 5.991
# inlier threshold. Held to the slice's 1e-4 m. tol = 0 runs every
# iteration: with the default tol, the robust fixture's third backtracking
# step lands on a chi2 tie (876.49725 against 876.49744) that the reference
# rejects and the port accepts, so the port stops at 3 iterations where the
# reference rejects on to 15 with the same result.
@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_solve_ba_matches_reference(fixture, solver):
    states, points, prob, kf_dof, mp_free, opts = FIXTURES[fixture]()
    ref, got = run_both(states, points, prob, kf_dof, mp_free,
                        dict(opts, tol=0.0, **SOLVERS[solver]))
    (t_r, p_r, c_r, it_r, o_r), (t_g, p_g, c_g, it_g, o_g) = ref, got
    assert it_g == it_r
    assert np.abs(t_g - t_r).max() <= 1e-4
    assert np.median(np.linalg.norm(p_g - p_r, axis=1)) <= 1e-4
    assert abs(c_g - c_r) <= 1e-4 * max(c_r, 1.0)
    np.testing.assert_array_equal(o_g <= 5.991, o_r <= 5.991)
    # and each fixture's own claim, on the port
    if fixture == "colines":
        p_true = 0.5 * (points[0] + points[2])
        assert np.abs(p_g[1] - p_true).max() < 2e-3
    else:
        assert np.median(o_g) < 1.0


def test_solve_ba_exit_rules_match_reference():
    """The default tol's small-gain exit stops both packages at the same
    iteration on the converging fixture with 0.5 px of pixel noise (with
    Cholesky; PCG's fifth step there is a chi2 tie at the f32 floor,
    113.88455 against 113.88452, which flips the exit)."""
    solver = "cholesky"
    states, points, prob, kf_dof, mp_free, opts = fixture_converge()
    rng = np.random.RandomState(104)
    prob = prob._replace(r_uv=prob.r_uv + jnp.asarray(
        rng.randn(*prob.r_uv.shape).astype(np.float32) * 0.5))
    ref, got = run_both(states, points, prob, kf_dof, mp_free,
                        dict(opts, **SOLVERS[solver]))
    assert got[3] == ref[3] < opts["iters"]
    assert abs(got[2] - ref[2]) <= 1e-4 * max(ref[2], 1.0)


# ---------------------------------------------------------------------------
# make_vi_problem: reprojection, colines, inertial links, random walks, a
# 15-D prior and bias priors in one problem
# ---------------------------------------------------------------------------

def vi_problem():
    cam, states, points, prob, kf_dof, mp_free = make_vi_problem(
        n_kf=5, n_mp=48, n_obs=160, n_col=12, seed=3)
    pcam = CameraModel(**{k: getattr(cam, k) for k in CAM_FIELDS})
    return (cam, pcam), [np.asarray(x) for x in states], np.asarray(points), \
        prob, np.asarray(kf_dof), np.asarray(mp_free)


def test_linearization_matches_reference():
    """_compute_all's chi2 and normal equations. Measured: every term
    within 3.3e-7 of its largest entry (Hll_col; Hpp 7.9e-8, W 9.7e-8);
    held to 1e-5."""
    (jcam, pcam), states, points, prob, kf_dof, mp_free = vi_problem()
    opts = J.BAOptions(iters=1, lambda0=1e-2)
    f = jax.jit(lambda st, pts, o: J._compute_all(
        st, pts, prob, jcam, jnp.asarray(EYE), jnp.asarray(Z3), o,
        jnp.asarray(kf_dof), jnp.asarray(mp_free))[:7])
    ref = jax.device_get(f(J.KFStates(*(jnp.asarray(x) for x in states)),
                           jnp.asarray(points), opts))
    pprob = port_problem(prob)
    pprob = pprob._replace(**{k: getattr(pprob, k).long()
                              for k in P._INDEX_FIELDS})
    got = P._compute_all(P.KFStates(*(_t(x) for x in states)), _t(points),
                         pprob, pcam, _t(EYE), _t(Z3),
                         P.BAOptions(iters=1, lambda0=1e-2), _t(kf_dof),
                         _t(mp_free))
    names = ("chi2", "Hpp", "b_p", "Hll", "Hll_col", "b_l", "W")
    for name, g, r in zip(names, got[:7], ref):
        r = np.asarray(r, np.float64)
        g = g.numpy().astype(np.float64)
        assert g.shape == r.shape, name
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_solve_ba_vi_problem_matches_reference(solver):
    """Six iterations on make_vi_problem's random 5-KF problem. Its reduced
    system is ill-conditioned along weak modes, where f32 steps part with
    summation order (the reference's own f32 step lies 3.8e-5 m from the f64
    step after one iteration, the port's 2.4e-5 m). Measured over six
    iterations: the same iterations, KF positions within 4.4e-4 m and points
    within 3.1e-3 m (largest) of the reference's, final chi2 within 1.2e-4
    of it. Held to 1e-3 m, 1e-2 m and 5e-4."""
    (jcam, pcam), states, points, prob, kf_dof, mp_free = vi_problem()
    opts = dict(iters=6, lambda0=1e-2, tol=0.0, **SOLVERS[solver])
    ref, got = run_both(states, points, prob, kf_dof, mp_free, opts,
                        cam=(jcam, pcam))
    (t_r, p_r, c_r, it_r, _), (t_g, p_g, c_g, it_g, _) = ref, got
    assert it_g == it_r == 6
    assert np.abs(t_g - t_r).max() <= 1e-3
    assert np.abs(p_g - p_r).max() <= 1e-2
    assert abs(c_g - c_r) <= 5e-4 * c_r
    assert c_g < 0.2 * float(np.asarray(jax.device_get(J.solve_ba(
        J.KFStates(*(jnp.asarray(x) for x in states)), jnp.asarray(points),
        prob, jnp.asarray(kf_dof), jnp.asarray(mp_free), jnp.asarray(EYE),
        jnp.asarray(Z3), jcam, J.BAOptions(**dict(opts, iters=1)))[2][
            "chi2_hist"]))[0])


# ---------------------------------------------------------------------------
# the analytic reprojection linearization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dist", [
    (0, (0.0, 0.0, 0.0, 0.0)),
    (1, (0.003, 0.0007, -0.002, 0.0002)),  # KB8 fisheye
], ids=["pinhole", "kb8"])
def test_reproj_batch_matches_jacfwd_and_reference(kind, dist):
    """_reproj_batch equals torch.func.jacfwd of make_reproj_residual at
    delta = 0, and the reference's _reproj_batch. Measured: 1.5e-5 of the
    largest Jacobian entry against jacfwd, 3e-7 against the reference."""
    rng = np.random.RandomState(0)
    kw = dict(kind=kind, fx=200.0, fy=210.0, cx=64.0, cy=48.0, dist=dist,
              width=128, height=96)
    cam = CameraModel(**kw)
    O = 40
    Rg = np.stack([so3.exp((rng.randn(3) * 0.2).astype(np.float32))
                   for _ in range(O)]).astype(np.float32)
    tg = rng.randn(O, 3).astype(np.float32)
    Xg = (rng.randn(O, 3) * [2, 2, 1] + [0, 0, 6]).astype(np.float32)
    uv = (rng.rand(O, 2) * 100).astype(np.float32)
    Rcb = so3.exp(np.float32([0.05, -0.02, 0.1])).astype(np.float32)
    tcb = np.float32([0.01, -0.02, 0.03])
    res = P.make_reproj_residual(cam, _t(Rcb), _t(tcb))
    z6, z3 = torch.zeros(6), torch.zeros(3)

    def one(R, t, X, u):
        return jacfwd(res, argnums=(0, 1))(z6, z3, R, t, X, u)

    Jk0, Jx0 = vmap(one)(_t(Rg), _t(tg), _t(Xg), _t(uv))
    r1, depth, Jk1, Jx1 = P._reproj_batch(cam, _t(Rcb), _t(tcb), _t(Rg),
                                          _t(tg), _t(Xg), _t(uv), True)
    ref = J._reproj_batch(JCamera(**kw), jnp.asarray(Rcb), jnp.asarray(tcb),
                          jnp.asarray(Rg), jnp.asarray(tg), jnp.asarray(Xg),
                          jnp.asarray(uv), want_jac=True)
    scale = float(Jk0.abs().max())
    for a, b in ((Jk1, Jk0), (Jx1, Jx0)):
        assert float((a - b).abs().max()) <= 1e-4 * scale
    for a, b in zip((r1, depth, Jk1, Jx1), ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(np.abs(b).max(), 1)
    assert bool((depth > 0).all())


def test_inertial_and_prior_linearizations_match_jacfwd():
    """The closed-form inertial and 15-D prior linearizations against
    torch.func.jacfwd of inertial_residual and prior15_residual (the
    reference's jax.jacfwd) on random states, biases and preintegrations,
    batched over 32 links. Measured (f64): 3.3e-15 of the largest entry,
    the residuals equal; held to 1e-8."""
    rng = np.random.RandomState(7)
    L = 32
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    rot = lambda s: t64(np.stack([so3.exp(rng.randn(3) * s)
                                  for _ in range(L)]))
    vec = lambda s: t64(rng.randn(L, 3) * s)
    mat = lambda s: t64(rng.randn(L, 3, 3) * s)
    args = (rot(0.5), vec(2.0), vec(1.0), vec(0.02), vec(0.1), rot(0.5),
            vec(2.0), vec(1.0), rot(0.1), vec(1.0), vec(0.5), mat(0.1),
            mat(0.1), mat(0.1), mat(0.05), mat(0.05),
            t64(rng.randn(L, 6) * 0.02), t64(rng.uniform(0.05, 0.5, L)))
    z = torch.zeros(15, dtype=torch.float64)
    r, J1, J2 = P.inertial_linearization(*args)
    (J1f, J2f), rf = vmap(lambda *a: jacfwd(
        lambda d1, d2: (P.inertial_residual(d1, d2, *a),) * 2,
        argnums=(0, 1), has_aux=True)(z, z))(*args)
    scale = float(J1f.abs().max())
    assert float((J1 - J1f).abs().max()) <= 1e-8 * scale
    assert float((J2 - J2f).abs().max()) <= 1e-8 * scale
    assert float((r - rf).abs().max()) <= 1e-10
    pargs = (rot(0.5), vec(2.0), vec(1.0), vec(0.02), vec(0.1), rot(0.5),
             vec(2.0), vec(1.0), vec(0.02), vec(0.1))
    r, Jp = P.prior15_linearization(*pargs)
    Jpf, rf = vmap(lambda *a: jacfwd(
        lambda d: (P.prior15_residual(d, *a),) * 2, has_aux=True)(z))(*pargs)
    assert float((Jp - Jpf).abs().max()) <= 1e-8 * float(Jpf.abs().max())
    assert float((r - rf).abs().max()) <= 1e-10


def test_inv3x3_and_robust_kernels_match_reference():
    """_inv3x3 on regularized SPD blocks, and the robust weights and costs
    for every kernel code. Measured: 2e-7 relative; held to 1e-5."""
    from ppg_slam_tpu.estimator import robust as jrobust

    from ppg_slam_tpu_torch.estimator import robust as probust

    rng = np.random.RandomState(5)
    A = rng.randn(64, 3, 3).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    got = P._inv3x3(_t(A)).numpy()
    ref = np.asarray(J._inv3x3(jnp.asarray(A)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    chi2 = (rng.rand(200) * 40).astype(np.float32)
    for name, code in probust.KERNEL_CODES.items():
        for fn in ("kernel_weight", "kernel_rho"):
            g = getattr(probust, fn)(name, _t(chi2), 2.447574).numpy()
            r = np.asarray(getattr(jrobust, fn)(
                code, jnp.asarray(chi2), np.float32(2.447574)))
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{fn} {name}")


# A landmark block from a local BA of the CLI on a half-size render of the
# corridor: a coline of huge weight gives entries of ~1e13 (eigenvalues
# 6.6e6, 2.2e13, 2.2e13).
HUGE_BLOCK = [[3826690293760.0, -2261437644800.0, 8015812493312.0],
              [-2261437644800.0, 21671842938880.0, 999999143936.0],
              [8015812493312.0, 999999143936.0, 18409404235776.0]]


def test_inv3x3_of_an_overflowing_block_matches_reference():
    """The f32 determinant of HUGE_BLOCK overflows. The JAX package's
    solver runs _inv3x3 jit-compiled, where it returns a zero block (the
    landmark is held still for the step); run op by op, as the port ran it,
    the adjugate gave inf - inf = NaN, and the NaN step rejected every
    iteration of the local BA (lambda 100 -> 1e8, the map left as it was).
    The port now returns the zero block there, and what the jit-compiled
    reference returns everywhere else: the regular blocks within 1e-5
    relative, and the same non-finite entries for a block whose
    determinant is exactly 0 and for a block that holds a NaN or an
    infinity, so an upstream fault still rejects the step."""
    rng = np.random.RandomState(6)
    A = rng.randn(8, 3, 3).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[3] = np.float32(HUGE_BLOCK)
    A[5] = np.float32([[2, 1, 0], [1, 2, 0], [0, 0, 0]])   # det == 0
    A[6, 1, 1] = np.nan
    A[7, 2, 0] = np.inf
    got = P._inv3x3(_t(A)).numpy()
    ref = np.asarray(jax.jit(J._inv3x3)(jnp.asarray(A)))
    assert np.isfinite(ref[3]).all() and not ref[3].any()
    np.testing.assert_array_equal(got[3], ref[3])
    for k in (5, 6, 7):
        assert not np.isfinite(ref[k]).all(), k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    ok = [0, 1, 2, 4]
    assert np.abs(got[ok] - ref[ok]).max() <= 1e-5 * np.abs(ref[ok]).max()
    # op by op, the reference's own formula gives the NaN block
    assert np.isnan(np.asarray(J._inv3x3(jnp.asarray(A)))[3]).all()


def test_solver_defaults_follow_the_device():
    """pose_cg_iters/backtrack None resolve as the reference resolves them
    per backend: PCG(64) with backtracking on CUDA, Cholesky without on the
    CPU."""
    assert P.resolve_pose_cg(None, "cuda") == 64
    assert P.resolve_pose_cg(None, "cpu") == 0
    assert P.resolve_pose_cg(8, "cpu") == 8
    assert P.resolve_backtrack(None, "cuda") is True
    assert P.resolve_backtrack(None, "cpu") is False
    assert P.resolve_backtrack(True, "cpu") is True


# ---------------------------------------------------------------------------
# what estimator.ba.LocalBAReplay's CUDA graphs hold: a problem padded to
# its bucket, and the iteration that reads nothing on the host
# (_lm_iteration with sync_free)
# ---------------------------------------------------------------------------

def port_vi_arrays(dtype, noise=0.02):
    """make_vi_problem's 5-KF problem from the port's copy of it (the
    same numbers from the seed) as host arrays, floats in `dtype`: (cam,
    states, points, prob, kf_dof, mp_free)."""
    from ppg_slam_tpu_torch.parallel.sharded_ba import \
        make_vi_problem as port_make_vi_problem

    cam, *tensors = port_make_vi_problem(n_kf=5, n_mp=48, n_obs=160,
                                         n_col=12, seed=3, noise=noise,
                                         device="cpu")

    def host(x):
        a = x.numpy()
        return a.astype(dtype) if a.dtype == np.float32 else a

    states, points, prob, kf_dof, mp_free = tensors
    return (cam, P.KFStates(*(host(x) for x in states)), host(points),
            P.BAProblem(*(host(x) for x in prob)), host(kf_dof),
            host(mp_free))


def solve_host(cam, states, points, prob, kf_dof, mp_free, opts):
    """solve_ba on host arrays; (states, points, info) as numpy/ints."""
    dt = torch.from_numpy(points).dtype
    eye, z3 = torch.eye(3, dtype=dt), torch.zeros(3, dtype=dt)
    st, pts, info = P.solve_ba(
        P.KFStates(*(_t(x) for x in states)), _t(points),
        P.BAProblem(*(_t(x) for x in prob)), _t(kf_dof), _t(mp_free), eye,
        z3, cam, P.BAOptions(**opts))
    return [x.numpy() for x in st], pts.numpy(), info


def replay_host(cam, states, points, prob, kf_dof, mp_free, opts):
    """A LocalBAReplay bucket's solve (ba._IterationGraph) of host arrays
    on the CPU, its CUDA graph stood in for by the iteration it captures,
    run eagerly at each replay: (states, points, info) at the true sizes."""
    from ppg_slam_tpu_torch.estimator import ba as B

    o = P.BAOptions(**opts)
    sizes = B.bucket_sizes(len(kf_dof), len(points), prob)
    g = B._IterationGraph(
        (sizes, False, cam, dataclasses.replace(o, iters=0, lambda0=0.0)),
        "cpu")
    g.fill(states, points, prob, kf_dof, mp_free,
           types.SimpleNamespace(Rcb=np.eye(3), tcb=np.zeros(3)))

    class Graph:
        def replay(self):
            g.flags = g.iteration(commit=True)

    g.graph = Graph()
    st, pts, info = g.run(o)
    return [x.numpy() for x in st], pts.numpy(), info


# padded-*: float64, so that what is compared is the padding alone. In
# float32 this problem's weak modes carry summation-order round-off far:
# merely permuting its observation rows moves the points by 1.3e-5 of
# their largest coordinate after one iteration and 2.4e-4 after six (CPU),
# and the padded solve lies within the same. Measured in float64: 3.1e-11
# (Cholesky) and 3.5e-9 (PCG(64)); held to 1e-5.
REPLAY_CASES = {
    "padded-pcg": dict(dtype=np.float64, pad=True, opts=dict(
        iters=10, lambda0=1e-2, pose_cg_iters=64, backtrack=True)),
    "padded-cholesky": dict(dtype=np.float64, pad=True, opts=dict(
        iters=10, lambda0=1e-2, pose_cg_iters=0, backtrack=False)),
    # at noise 0.3 the fifth and sixth full steps are rejected and a
    # shorter one accepted
    "branch_free_backtrack": dict(dtype=np.float32, noise=0.3, opts=dict(
        iters=6, lambda0=1e-2, tol=0.0, pose_cg_iters=0, backtrack=True)),
    # at this damping the PCG converges before its 64 iterations
    "poll_free_pcg": dict(dtype=np.float32, opts=dict(
        iters=6, lambda0=1e4, tol=0.0, pose_cg_iters=64, backtrack=False)),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_replayed_iteration_matches_solve_ba(case):
    """make_vi_problem (links, walks, colines, priors) solved as
    LocalBAReplay runs it, against solve_ba as it runs eagerly. padded-*:
    solve_ba on the problem padded to the reference's bucket (16 KFs, 512
    points, invalid rows in every family) against the problem at its own
    size, within 1e-5 of the largest entry. The rest: the replay's bucket
    (_IterationGraph: its buffers, the sync-free iteration, the loop and
    the slicing back) against solve_ba on the same padded inputs, equal:
    the backtracking tries picked on the device against the host-read
    branch, the PCG without its exit poll against the polling one. The
    same iterations and the same accepts and rejects in each."""
    from ppg_slam_tpu_torch.estimator import ba as B

    c = REPLAY_CASES[case]
    cam, states, points, prob, kf_dof, mp_free = port_vi_arrays(
        c["dtype"], c.get("noise", 0.02))
    n, m = len(kf_dof), len(points)
    ref = solve_host(cam, states, points, prob, kf_dof, mp_free, c["opts"])
    if c.get("pad"):
        sizes = B.bucket_sizes(n, m, prob)
        assert sizes == (16, 512, 4096, 256, 64, 1, 4)
        padded = B.pad_inputs(states, points, prob, kf_dof, mp_free, sizes)
        assert not padded[6][n:].any() and not padded[7][m:].any()
        st, pts, info = solve_host(
            cam, P.KFStates(*padded[:5]), padded[5],
            P.BAProblem(*padded[8:]), padded[6], padded[7], c["opts"])
        got = ([x[:n] for x in st], pts[:m], info)
        for g, r in zip(got[0] + [got[1]], ref[0] + [ref[1]]):
            assert np.abs(g - r).max() <= 1e-5 * max(np.abs(r).max(), 1.0)
        k = len(prob.r_kf)
        np.testing.assert_allclose(info["obs_chi2"][:k].numpy(),
                                   ref[2]["obs_chi2"].numpy(), rtol=1e-5,
                                   atol=1e-8)
    else:
        padded = B.pad_inputs(states, points, prob, kf_dof, mp_free,
                              B.bucket_sizes(n, m, prob))
        args = (cam, P.KFStates(*padded[:5]), padded[5],
                P.BAProblem(*padded[8:]), padded[6], padded[7])
        st, pts, info = solve_host(*args, c["opts"])
        ref = ([x[:n] for x in st], pts[:m], info)
        got = replay_host(cam, states, points, prob, kf_dof, mp_free,
                          c["opts"])
        for g, r in zip(got[0] + [got[1]], ref[0] + [ref[1]]):
            np.testing.assert_array_equal(g, r)
        k = len(prob.r_kf)
        for key in ("obs_chi2", "obs_depth"):
            np.testing.assert_array_equal(got[2][key].numpy(),
                                          ref[2][key][:k].numpy())
        for key in ("final_chi2", "lam", "chi2_hist"):
            np.testing.assert_array_equal(got[2][key].numpy(),
                                          ref[2][key].numpy())
        assert got[2]["host_syncs"] == got[2]["iters_run"]
        if c["opts"]["backtrack"]:
            # the case takes the branch: without it the solve differs
            plain = solve_host(*args, dict(c["opts"], backtrack=False))
            assert np.abs(plain[1][:m] - ref[1]).max() > 1e-3
        else:
            # the case exits early: fewer than 3 polls an iteration
            assert ref[2]["host_syncs"] < 4 * ref[2]["iters_run"]
    assert got[2]["iters_run"] == ref[2]["iters_run"]
    assert got[2]["accepted"] == ref[2]["accepted"]
