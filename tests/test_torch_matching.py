"""Data association: the port's matcher, DeviceMatcher and PnPSolver against
ppg_slam_tpu.matching, on the synthetic scene of
tests/test_matching_worldmap.py.

Every world-map object is built in both packages from the same numpy
features; matches are compared as scene ids. The copied matcher must give
identical match lists; DeviceMatcher identical row membership with
distances within the f16 transfer bound of tests/test_torch_device_match.py
(1e-3); PnPSolver the same inlier set and a pose within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ppg_slam_tpu.geometry import so3 as jso3
from ppg_slam_tpu.matching import Matcher as JMatcher
from ppg_slam_tpu.matching import PnPSolver as JPnP
from ppg_slam_tpu.matching.device_match import DeviceMatcher as JDevice
from ppg_slam_tpu.worldmap.elements import MapEdge as JEdge

import ppg_slam_tpu_torch.worldmap as pwm
from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch.matching import DeviceMatcher as PDevice
from ppg_slam_tpu_torch.matching import Matcher as PMatcher
from ppg_slam_tpu_torch.matching import PnPSolver as PPnP
from ppg_slam_tpu_torch.worldmap.elements import MapEdge as PEdge

from test_torch_ba_entry import JAX, PORT

JAX.Matcher, PORT.Matcher = JMatcher, PMatcher
JAX.Edge, PORT.Edge = JEdge, PEdge
DIST_TOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port_ids():
    pwm.reset_ids()
    yield


@pytest.fixture(scope="module")
def scene():
    return testing.SyntheticScene()


def _frame(pkg, rig, scene, k, desc_noise=0.0, seed=0):
    """Frame k of the scene (pose set), its scene ids."""
    Rcw, tcw = scene.pose(k)
    feats, ids = scene.render(Rcw, tcw)
    kw = testing.feature_kwargs(feats)
    if desc_noise:
        rng = np.random.RandomState(seed)
        d = kw["desc"] + rng.randn(*kw["desc"].shape).astype(
            np.float32) * desc_noise
        kw["desc"] = d / np.linalg.norm(d, axis=1, keepdims=True)
    f = pkg.wm.Frame(pkg.Features(**kw), timestamp=0.05 * k, rig=rig)
    f.set_pose(Rcw, tcw)
    return f, ids


def _mapped_keyframe(pkg, wm, scene, k=0, edges=True):
    """A keyframe at pose k with a map point (scene descriptor) for every
    keypoint and a valid MapEdge for every visible scene segment. Returns
    (keyframe, {scene id: MapPoint})."""
    f, ids = _frame(pkg, wm.rig, scene, k)
    kf = pkg.wm.KeyFrame(f, wm)
    mps = {}
    for i, g in enumerate(ids):
        mp = pkg.wm.MapPoint(scene.points[g], kf)
        mp.add_observation(kf, i)
        kf.add_map_point(mp, i)
        mp.descriptor = scene.descs[g].copy()
        mp.update_normal_and_depth()
        mps[g] = mp
        wm.add_map_point(mp)
    if edges:
        for a, b in scene.segments:
            if a in mps and b in mps:
                me = pkg.Edge(mps[a], mps[b])
                me.valid = True
                wm.add_map_edge(me)
    wm.add_keyframe(kf)
    return kf, mps


def _as_ids(map_points, mps):
    gid = {id(mp): g for g, mp in mps.items()}
    return [gid.get(id(mp), -2) if mp is not None else -1
            for mp in map_points]


def _both(build):
    """build(pkg) in each package, the port's ids reset first."""
    out = []
    for pkg in (JAX, PORT):
        if pkg is PORT:
            pwm.reset_ids()
        out.append(build(pkg))
    return out


def test_search_for_initialization_matches_reference(scene):
    def run(pkg):
        rig = pkg.wm.Rig(pkg.cam)
        f1, _ = _frame(pkg, rig, scene, 0)
        f2, _ = _frame(pkg, rig, scene, 6, desc_noise=0.05)
        prev = f1.kp.copy()
        m12, n = pkg.Matcher(pkg.cam, nn_ratio=0.9).search_for_initialization(
            f1, f2, prev, window=100)
        return m12, n, prev

    (m_r, n_r, p_r), (m_g, n_g, p_g) = _both(run)
    assert n_g == n_r and n_g > 50
    np.testing.assert_array_equal(m_g, m_r)
    np.testing.assert_array_equal(p_g, p_r)


def test_search_by_projection_last_frame_matches_reference(scene):
    def run(pkg):
        wm = pkg.wm.Map(pkg.wm.Rig(pkg.cam))
        kf, mps = _mapped_keyframe(pkg, wm, scene, 0, edges=False)
        last, _ = _frame(pkg, wm.rig, scene, 0)
        last.map_points = list(kf.map_points)
        f, _ = _frame(pkg, wm.rig, scene, 2, desc_noise=0.03, seed=1)
        n = pkg.Matcher(pkg.cam, 0.9).search_by_projection_last_frame(
            f, last, 15)
        return n, _as_ids(f.map_points, mps)

    (n_r, ids_r), (n_g, ids_g) = _both(run)
    assert n_g == n_r and n_g > 50
    assert ids_g == ids_r


@pytest.mark.parametrize("device_rows", [False, True], ids=["host", "device"])
def test_extend_map_matches_matches_reference(scene, device_rows):
    """Seed growing through the map edges, with the host distance rows or
    with each package's DeviceMatcher rows: identical match lists."""
    def run(pkg):
        wm = pkg.wm.Map(pkg.wm.Rig(pkg.cam))
        _, mps = _mapped_keyframe(pkg, wm, scene, 0)
        f, _ = _frame(pkg, wm.rig, scene, 4, desc_noise=0.03, seed=2)
        points = list(mps.values())
        for mp in points:
            f.check_in_frustum(mp, 0.5)
        dists = None
        if device_rows:
            dists = _gated(pkg, f, points, 1.0)[0]
        n = pkg.Matcher(pkg.cam, 0.9).extend_map_matches(f, points, th=1.0,
                                                         dists=dists)
        return n, _as_ids(f.map_points, mps)

    (n_r, ids_r), (n_g, ids_g) = _both(run)
    assert n_g == n_r and n_g > 60
    assert ids_g == ids_r


def test_fuse_matches_reference(scene):
    """A keyframe's own map points fused into a second keyframe holding
    its own points for a third of the same landmarks: the same merges and
    new observations."""
    def run(pkg):
        wm = pkg.wm.Map(pkg.wm.Rig(pkg.cam))
        kf1, mps1 = _mapped_keyframe(pkg, wm, scene, 0, edges=False)
        f2, ids2 = _frame(pkg, wm.rig, scene, 3)
        kf2 = pkg.wm.KeyFrame(f2, wm)
        mps2 = {}
        for i, g in enumerate(ids2):
            if g % 3:
                continue
            mp = pkg.wm.MapPoint(scene.points[g] + 0.01, kf2)
            mp.add_observation(kf2, i)
            kf2.add_map_point(mp, i)
            mp.descriptor = scene.descs[g].copy()
            mp.update_normal_and_depth()
            mps2[g] = mp
            wm.add_map_point(mp)
        wm.add_keyframe(kf2)
        n = pkg.Matcher(pkg.cam).fuse(kf2, list(mps1.values()))
        both = {**{("a", g): mp for g, mp in mps1.items()},
                **{("b", g): mp for g, mp in mps2.items()}}
        obs = sorted((key, len(mp.observations), mp.is_bad())
                     for key, mp in both.items())
        return n, _as_ids(kf2.map_points, {**mps2, **mps1}), obs

    (n_r, ids_r, obs_r), (n_g, ids_g, obs_g) = _both(run)
    assert n_g == n_r and n_g > 20
    assert ids_g == ids_r
    assert obs_g == obs_r


def _gated(pkg, f, points, th):
    """A DeviceMatcher of the package over the frame's descriptors (device
    form), queried as tracking's extend-map gate: (GatedRows, matcher)."""
    desc = f.feats.desc
    padded = np.zeros((512, 256), np.float32)
    padded[:len(desc)] = desc
    if pkg is JAX:
        f.feats.desc_dev = jnp.asarray(padded)
        dm = JDevice(bank_cap=1024)
    else:
        f.feats.desc_dev = torch.from_numpy(padded)
        dm = PDevice(bank_cap=1024, device="cpu")
    queries = [(mp, mp.track_proj_x, mp.track_proj_y,
                th * (2.5 if mp.track_view_cos > 0.998 else 4.0))
               for mp in points if mp.track_in_view]
    dm.ensure_bank([q[0] for q in queries])
    return dm.gated_rows(f, queries), dm


def test_device_matcher_rows_match_reference(scene):
    def run(pkg):
        wm = pkg.wm.Map(pkg.wm.Rig(pkg.cam))
        _, mps = _mapped_keyframe(pkg, wm, scene, 0, edges=False)
        f, _ = _frame(pkg, wm.rig, scene, 4, desc_noise=0.03, seed=3)
        points = list(mps.values())
        for mp in points:
            f.check_in_frustum(mp, 0.5)
        rows, dm = _gated(pkg, f, points, 6.0)
        gid = {mp.mnId: g for g, mp in mps.items()}
        table = {gid[k]: dict(r.d) for k, r in rows.rows.items()}
        # bank bookkeeping: a changed descriptor re-uploads one slot, a
        # culled point's slot is reclaimed when the bank is full
        uploads = dm.n_bank_uploads
        mp0 = next(mp for mp in points if mp.mnId in dm._slot_of)
        slot0 = dm._slot_of[mp0.mnId]
        mp0.descriptor = mp0.descriptor.copy()
        dm.ensure_bank(points)
        return (table, rows.overflow_rows, rows.n_rows,
                dm.n_bank_uploads - uploads, dm._slot_of[mp0.mnId] == slot0)

    (t_r, o_r, n_r, up_r, same_r), (t_g, o_g, n_g, up_g, same_g) = _both(run)
    assert (o_g, n_g, up_g, same_g) == (o_r, n_r, up_r, same_r)
    assert n_g > 100 and up_g == 1 and same_g
    assert t_g.keys() == t_r.keys()
    for g in t_r:
        assert t_g[g].keys() == t_r[g].keys(), g
        for j, d in t_r[g].items():
            assert abs(t_g[g][j] - d) <= DIST_TOL


def test_device_matcher_reclaims_culled_slots(scene):
    wm = pwm.Map(pwm.Rig(testing.CAM))
    kf, mps = _mapped_keyframe(PORT, wm, scene, 0, edges=False)
    points = list(mps.values())
    dm = PDevice(bank_cap=len(points), device="cpu")
    dm.ensure_bank(points)
    assert not dm._free
    points[5].set_bad()
    extra = pwm.MapPoint(np.float32([0, 0, 5]), kf)
    extra.descriptor = scene.descs[0].copy()
    dm.ensure_bank([extra])
    assert extra.mnId in dm._slot_of and points[5].mnId not in dm._slot_of
    np.testing.assert_array_equal(
        dm.bank[dm._slot_of[extra.mnId]].numpy(), extra.descriptor)


def test_device_matcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        PDevice()


def test_pnp_matches_reference():
    rng = np.random.RandomState(51)
    n = 80
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], 1).astype(np.float32)
    Rcw = np.asarray(jso3.exp(jnp.asarray([0.1, -0.05, 0.2], jnp.float32)),
                     np.float32)
    tcw = np.float32([0.2, -0.1, 0.3])
    uv = testing.CAM.project_np(Xw @ Rcw.T + tcw).astype(np.float32)
    bad = rng.choice(n, 15, replace=False)
    uv[bad] += (rng.randn(15, 2) * 50 + 20).astype(np.float32)
    uv += rng.randn(n, 2).astype(np.float32) * 0.3
    ref = JPnP(Xw, uv, JAX.cam, min_inliers=30, seed=4).iterate(200)
    got = PPnP(Xw, uv, PORT.cam, min_inliers=30, seed=4).iterate(200)
    assert got[0] and ref[0]
    np.testing.assert_array_equal(got[3], np.asarray(ref[3]))
    assert got[4] == ref[4] and got[4] >= 60
    assert not got[3][bad].any()
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), atol=1e-4)
    np.testing.assert_allclose(got[1], Rcw, atol=2e-3)
