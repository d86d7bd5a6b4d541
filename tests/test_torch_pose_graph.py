"""The port's pose-graph optimizers against ppg_slam_tpu's.

* Per-edge residuals and Jacobians of the Sim3 edge, the 4-DoF edge and the
  Sim3 projection pair (torch.func.jacfwd under vmap) equal to jax.jacfwd's
  on the reference functions, in float32, with edges whose error sits in
  each branch of Sim3.log: consistent (small angle, small log-scale), a
  rotation-only error (|sigma| < 1e-5, where the reference's derivative
  takes the small-sigma constants), a scale-only error and a generic one.
  Measured: Sim3 edges' residuals within 6.3e-8 and Jacobians within
  3.6e-7 (entries up to 2.1); 4-DoF edges' within 2.4e-6 and 1.9e-6
  (entries up to 28: the rotation rows carry the sqrt(1e3) weight); the
  projection pair's within 3.1e-5 px and 1.2e-4 (entries up to 461 px);
  held to the *_TOL constants below.
* The three optimizers on tests/test_pose_graph.py's fixtures
  (make_loop_trajectory + relative_sim3 chains with a true loop edge; a
  60-point Sim3 with 8 outliers) against the reference's at the same
  inputs, and the same scenarios asserted on the port alone. Measured:
  the 4-DoF graph within 3.6e-7, optimize_sim3 within 2.1e-7 with the
  same inlier mask, the fixed-scale Sim3 graph within 1e-6; held to
  OPT_TOL. The free-scale Sim3 graph meets a tie: converged after two
  steps, its damped steps then change chi2 (1.5853e-3) by ~1e-6 relative,
  and at iteration 13 (lambda 2.5e-6) the port accepts a step
  (chi2 0.0015853005 -> 0.0015852985) that the reference, summing the same
  edges in another order, rejects (0.0015852990 -> 0.0015853005), as it
  accepts another at iteration 17. The final states part by 1.0e-5 (R),
  1.8e-5 (t), 6.3e-6 (s); held to TIE_TOL (ROADMAP.md §3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ppg_slam_tpu.estimator import pose_graph as jpg
from ppg_slam_tpu.geometry import Sim3 as JSim3

from ppg_slam_tpu_torch.estimator import pose_graph as ppg
from ppg_slam_tpu_torch.geometry import Sim3, so3
from ppg_slam_tpu_torch.geometry.cameras import CameraModel
from ppg_slam_tpu_torch.utils import profiler

import test_pose_graph as TPG

RES_TOL = 1e-5
JAC_TOL = 1e-5
POSE4_TOL = 2e-5  # the 4-DoF rotation rows are weighted sqrt(1e3)
PROJ_RES_TOL, PROJ_JAC_TOL = 1e-4, 1e-3  # px, px per unit update
OPT_TOL = 1e-5
TIE_TOL = 5e-5    # the free-scale Sim3 graph's tie at iteration 13
CAM = CameraModel(**{k: getattr(TPG.CAM, k) for k in
                     ("kind", "fx", "fy", "cx", "cy", "dist", "width",
                      "height")})


def _f32(*arrays):
    return [np.array(a, np.float32) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in _f32(*arrays)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in _f32(*arrays)]


def _sim3_edges():
    """Vertex pairs and measurements, two edges per branch of the error's
    Sim3.log."""
    rng = np.random.RandomState(7)
    n = 8
    xi_i = rng.randn(n, 7).astype(np.float32) * 0.3
    xi_j = rng.randn(n, 7).astype(np.float32) * 0.3
    Si = Sim3.exp(torch.from_numpy(xi_i))
    Sj = Sim3.exp(torch.from_numpy(xi_j))
    true = Sj @ Si.inverse()
    noise = np.zeros((n, 7), np.float32)
    noise[2:4, 3:6] = rng.randn(2, 3) * 0.05      # rotation only
    noise[4:6, 6] = rng.randn(2) * 0.05           # scale only
    noise[6:8] = rng.randn(2, 7) * 0.05           # generic
    Sm = Sim3.exp(torch.from_numpy(noise)) @ true
    return ([a.numpy() for a in Si] + [a.numpy() for a in Sj]
            + [a.numpy() for a in Sm])


def test_sim3_edge_jacobians_match_jacfwd():
    args = _sim3_edges()
    err = Sim3(*_t(*args[6:9])) @ Sim3(*_t(*args[:3])) @ \
        Sim3(*_t(*args[3:6])).inverse()
    log = err.log().numpy()
    theta, sigma = np.linalg.norm(log[:, 3:6], axis=1), np.abs(log[:, 6])
    assert (theta[:2] < 1e-5).all() and (sigma[:4] < 1e-5).all()
    assert (theta[2:4] > 1e-5).all() and (sigma[4:] > 1e-5).all()

    z7 = jnp.zeros(7, jnp.float32)
    in_axes = (None, None) + (0,) * 9
    r_ref = jax.vmap(jpg._sim3_error, in_axes=in_axes)(z7, z7, *_j(*args))
    Ji_ref, Jj_ref = jax.vmap(jax.jacfwd(jpg._sim3_error, argnums=(0, 1)),
                              in_axes=in_axes)(z7, z7, *_j(*args))
    r, Ji, Jj = ppg._with_jacobians(ppg._sim3_error,
                                    torch.zeros(7), _t(*args))
    assert Ji.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=RES_TOL)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Ji_ref), atol=JAC_TOL)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jj_ref), atol=JAC_TOL)


def test_pose4_edge_jacobians_match_jacfwd():
    rng = np.random.RandomState(8)
    n = 6
    Rwbi = so3.exp(rng.randn(n, 3).astype(np.float32) * 0.5)
    Rwbj = so3.exp(rng.randn(n, 3).astype(np.float32) * 0.5)
    twbi, twbj = rng.randn(2, n, 3).astype(np.float32)
    Ri, Rj = Rwbi.transpose(0, 2, 1), Rwbj.transpose(0, 2, 1)
    ti = -np.einsum("nij,nj->ni", Ri, twbi)
    tj = -np.einsum("nij,nj->ni", Rj, twbj)
    dRij = Ri @ Rj.transpose(0, 2, 1)                     # Ti<-j, exact
    dtij = ti - np.einsum("nij,nj->ni", dRij, tj)
    dRij[2:] = so3.exp(rng.randn(n - 2, 3).astype(np.float32) * 0.05) \
        @ dRij[2:]
    dtij[2:] += rng.randn(n - 2, 3).astype(np.float32) * 0.05
    args = (Rwbi, twbi, Rwbj, twbj, dRij, dtij)
    rot_w = np.sqrt(np.float32(1e3))
    z4 = jnp.zeros(4, jnp.float32)
    in_axes = (None, None) + (0,) * 6 + (None,)
    jargs = _j(*args) + [jnp.float32(rot_w)]
    r_ref = jax.vmap(jpg._pose4_error, in_axes=in_axes)(z4, z4, *jargs)
    Ji_ref, Jj_ref = jax.vmap(jax.jacfwd(jpg._pose4_error, argnums=(0, 1)),
                              in_axes=in_axes)(z4, z4, *jargs)
    w = torch.tensor(rot_w)
    r, Ji, Jj = ppg._with_jacobians(
        lambda a, b, *e: ppg._pose4_error(a, b, *e, w), torch.zeros(4),
        _t(*args))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=POSE4_TOL)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Ji_ref),
                               atol=POSE4_TOL)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jj_ref),
                               atol=POSE4_TOL)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_projection_jacobians_match_jacfwd(fix_scale):
    rng = np.random.RandomState(9)
    m = 20
    X1 = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m),
                   rng.uniform(4, 8, m)], 1).astype(np.float32)
    X2 = (X1 + rng.randn(m, 3) * 0.1).astype(np.float32)
    uv1 = CAM.project_np(X1) + rng.randn(m, 2).astype(np.float32)
    uv2 = CAM.project_np(X2) + rng.randn(m, 2).astype(np.float32)
    S = Sim3.exp(torch.from_numpy(
        np.float32([0.05, -0.02, 0.03, 0.01, 0.02, -0.01, 0.04])))
    S_np = [a.numpy() for a in S]

    def ref_fn(d):
        return jpg._sim3_proj_residuals(d, *_j(*S_np, X1, X2, uv1, uv2),
                                        TPG.CAM, TPG.CAM, fix_scale)

    z7 = jnp.zeros(7, jnp.float32)
    r_ref = ref_fn(z7)
    J_ref = jax.jacfwd(ref_fn)(z7)
    (J12, J21), (r12, r21) = torch.func.jacfwd(
        lambda d: (ppg._sim3_proj_residuals(
            d, *_t(*S_np, X1, X2, uv1, uv2), CAM, CAM, fix_scale),) * 2,
        has_aux=True)(torch.zeros(7))
    for g, r in ((r12, r_ref[0]), (r21, r_ref[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=PROJ_RES_TOL)
    for g, r in ((J12, J_ref[0]), (J21, J_ref[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=PROJ_JAC_TOL)
    if fix_scale:
        assert not J12[..., 6].any() and not J21[..., 6].any()


# ---------------------------------------------------------------------------
# the optimizers on tests/test_pose_graph.py's fixtures
# ---------------------------------------------------------------------------

def _graph_fixture(monkeypatch, use_4dof):
    monkeypatch.setattr(TPG, "RNG", np.random.RandomState(31))
    return TPG.TestEssentialGraph()._run(use_4dof=use_4dof)


def _loop_error(Rcw, tcw, s, ref_Rcw, ref_tcw):
    n = len(Rcw)
    S_last0 = TPG.relative_sim3(Rcw, tcw, s, n - 1, 0)
    S_gt = TPG.relative_sim3(ref_Rcw, ref_tcw, np.ones(n, np.float32),
                             n - 1, 0)
    return float(jnp.linalg.norm((S_gt.inverse() @ S_last0).log()))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_graph_matches_reference(monkeypatch, fix_scale):
    n, Rcw, tcw, Rd, td, sd, ii, jj, SR, St, Ss = _graph_fixture(
        monkeypatch, False)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    ref = jpg.optimize_essential_graph(
        *_j(Rd, td, sd),
        jpg.Sim3Graph(jnp.asarray(ii), jnp.asarray(jj), *_j(SR, St, Ss),
                      jnp.ones(len(ii), bool)),
        jnp.asarray(fixed), fix_scale=fix_scale)
    profiler.reset()
    got = ppg.optimize_essential_graph(
        *_t(Rd, td, sd),
        ppg.Sim3Graph(torch.from_numpy(ii).long(), torch.from_numpy(jj).long(),
                      *_t(SR, St, Ss)),
        torch.from_numpy(fixed), fix_scale=fix_scale)
    assert profiler.counters == {"device.optimize_essential_graph.cpu": 1}
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=OPT_TOL if fix_scale else TIE_TOL)
    if fix_scale:
        np.testing.assert_array_equal(got[2].numpy(), sd)
    else:
        assert _loop_error(*[g.numpy() for g in got], Rcw, tcw) < 0.02


def test_4dof_graph_matches_reference(monkeypatch):
    n, Rcw, tcw, Rd, td, sd, ii, jj, SR, St, Ss = _graph_fixture(
        monkeypatch, True)
    Rwb = np.transpose(Rd, (0, 2, 1))
    twb = -np.einsum("nij,nj->ni", Rwb, td)
    dR = np.transpose(SR, (0, 2, 1))
    dt = -np.einsum("nij,nj->ni", dR, St)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    ref = jpg.optimize_essential_graph_4dof(
        *_j(Rwb, twb),
        jpg.Graph4DoF(jnp.asarray(ii), jnp.asarray(jj), *_j(dR, dt),
                      jnp.ones(len(ii), bool)), jnp.asarray(fixed))
    got = ppg.optimize_essential_graph_4dof(
        *_t(Rwb, twb),
        ppg.Graph4DoF(torch.from_numpy(ii).long(),
                      torch.from_numpy(jj).long(), *_t(dR, dt)),
        torch.from_numpy(fixed))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=OPT_TOL)
    Rcw_f = np.transpose(got[0].numpy(), (0, 2, 1))
    tcw_f = -np.einsum("nij,nj->ni", Rcw_f, got[1].numpy())
    assert _loop_error(Rcw_f, tcw_f, np.ones(n, np.float32), Rcw, tcw) < 0.02


def _sim3_fixture():
    """tests/test_pose_graph.py::TestOptimizeSim3's data."""
    rng = np.random.RandomState(31)
    m = 60
    X1 = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m),
                   rng.uniform(4, 8, m)], 1).astype(np.float32)
    R12 = so3.exp(np.float32([0.05, -0.1, 0.08]))
    t12 = np.float32([0.4, -0.2, 0.3])
    s12 = np.float32(1.35)
    S12 = JSim3(*_j(R12, t12, s12))
    X2 = np.asarray(S12.inverse().apply(jnp.asarray(X1)))
    uv1 = np.array(TPG.CAM.project(jnp.asarray(X1)))
    uv2 = np.array(TPG.CAM.project(jnp.asarray(X2)))
    bad = rng.choice(m, 8, replace=False)
    uv1[bad] += rng.randn(8, 2).astype(np.float32) * 50 + 10
    S0 = JSim3.exp(jnp.asarray(np.float32(
        [0.05, -0.03, 0.04, 0.02, -0.01, 0.03, 0.05]))) @ S12
    return ([np.asarray(a) for a in S0], X1, X2, uv1, uv2,
            (R12, t12, s12), bad)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_reference(fix_scale):
    S0, X1, X2, uv1, uv2, (R12, t12, s12), bad = _sim3_fixture()
    m = len(X1)
    ref = jpg.optimize_sim3(*_j(*S0, X1, X2, uv1, uv2), jnp.ones(m, bool),
                            TPG.CAM, TPG.CAM, fix_scale=fix_scale)
    got = ppg.optimize_sim3(*_t(*S0, X1, X2, uv1, uv2), CAM, CAM,
                            fix_scale=fix_scale)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=OPT_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert int(got[4]) == int(ref[4])
    if not fix_scale:  # the reference's TestOptimizeSim3, on the port
        np.testing.assert_allclose(got[0].numpy(), R12, atol=2e-3)
        np.testing.assert_allclose(got[1].numpy(), t12, atol=1e-2)
        assert abs(float(got[2]) - s12) < 0.01
        assert int(got[4]) >= m - 10
        assert not got[3].numpy()[bad].any()
    else:
        assert float(got[2]) == float(S0[2])
