"""Port parity: NMS, heat refinement, pair probing, line validation and
descriptor sampling of ppg_slam_tpu_torch.ops against ppg_slam_tpu.ops, on the
same inputs (made with numpy, or by the port's net on the extractor test
image)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ppg_slam_tpu.ops import descriptors as JD
from ppg_slam_tpu.ops import heatmap as JH
from ppg_slam_tpu.ops import nms as JN
from ppg_slam_tpu.ops import pairs as JP

from ppg_slam_tpu_torch.models import load_net
from ppg_slam_tpu_torch.ops import descriptors as TD
from ppg_slam_tpu_torch.ops import heatmap as TH
from ppg_slam_tpu_torch.ops import nms as TN
from ppg_slam_tpu_torch.ops import pairs as TP


def _junction_map(seed, h=96, w=128, n=400):
    rng = np.random.RandomState(seed)
    junc = np.zeros((h, w), np.float32)
    ys = rng.randint(0, h, n)
    xs = rng.randint(0, w, n)
    junc[ys, xs] = rng.rand(n).astype(np.float32) * 0.9 + 0.01
    return junc


def _junction_map_with_ties():
    """Equal scores that greedy NMS and the iterated form resolve alike: a
    far-apart pair, and an adjacent pair in an otherwise empty region."""
    junc = _junction_map(12)
    junc[20, 20] = junc[70, 100] = 0.93
    junc[48:73, 18:44] = 0.0
    junc[60, 30] = junc[60, 31] = 0.5
    return junc


def _junction_map_tie_cascade():
    """Three equal scores in one window: the iterated form accepts all
    three in one round, and the tie losers' suppression windows, kept after
    the tie clean-up, also cover (x=53, y=48), which greedy NMS accepts."""
    junc = _junction_map(12)
    junc[40, 50] = junc[42, 53] = junc[44, 51] = 0.95
    return junc


_MAPS = {"random": functools.partial(_junction_map, 11),
         "ties": _junction_map_with_ties,
         "tie_cascade": _junction_map_tie_cascade}


def _nms_all(junc):
    fast = [np.asarray(a) for a in JN.nms_keypoints(jnp.asarray(junc))]
    scan = [np.asarray(a) for a in JN.nms_keypoints_scan(jnp.asarray(junc))]
    port = [a.numpy() for a in TN.nms_keypoints(torch.from_numpy(junc))]
    return fast, scan, port


@pytest.mark.parametrize("name", sorted(_MAPS))
def test_nms_matches_reference(name):
    (xy_j, sc_j, va_j), _, (xy_t, sc_t, va_t) = _nms_all(_MAPS[name]())
    np.testing.assert_array_equal(va_t, va_j)
    np.testing.assert_array_equal(xy_t, xy_j)
    np.testing.assert_array_equal(sc_t, sc_j.astype(np.float32))


@pytest.mark.parametrize("name", ["random", "ties"])
def test_nms_matches_reference_scan(name):
    _, (xy_s, _, va_s), (xy_t, _, va_t) = _nms_all(_MAPS[name]())
    n = int(va_s.sum())
    assert int(va_t.sum()) == n
    np.testing.assert_array_equal(xy_t[:n], xy_s[:n])


def test_nms_tie_cascade_pinned():
    """Pins a reference fault the port mirrors (ROADMAP.md §3): with three
    equal scores in one window, the reference's iterated NMS (and the port)
    drops (x=53, y=48), which the greedy scan accepts."""
    (xy_j, _, _), (xy_s, _, va_s), (xy_t, _, _) = _nms_all(
        _junction_map_tie_cascade())
    n = int(va_s.sum())
    assert [53, 48] in xy_s[:n].tolist()
    assert [53, 48] not in xy_j.tolist()
    assert [53, 48] not in xy_t.tolist()


def test_nms_cap_and_radius():
    rng = np.random.RandomState(13)
    junc = np.zeros((480, 752), np.float32)
    ys, xs = np.mgrid[10:470:10, 10:740:10]
    junc[ys.ravel(), xs.ravel()] = rng.rand(ys.size) * 0.5 + 0.1
    xy, _, valid = TN.nms_keypoints(torch.from_numpy(junc))
    ref_xy, _, ref_valid = JN.nms_keypoints(jnp.asarray(junc))
    assert int(valid.sum()) == 500
    np.testing.assert_array_equal(xy.numpy(), np.asarray(ref_xy))
    p = xy.numpy()[:500].astype(np.int64)
    d = np.max(np.abs(p[:, None] - p[None, :]), axis=-1) + np.eye(500, dtype=int) * 1000
    assert d.min() > 4


def _refine_fixture(seed):
    rng = np.random.RandomState(seed)
    heat = np.clip(rng.rand(96, 128).astype(np.float32) ** 3, 0, 1)
    heat[:16, :16] = 0.5      # saturated tile
    heat[16:32, :16] = 0.0    # untouched tile
    heat[32:48, 16:32] = 0.02  # all above threshold, not saturated
    return heat


def test_refine_heatmap_matches_reference_exactly():
    """On values whose partial sums are exact in f32 (multiples of 2^-10),
    the order of the tile-mean sum cannot matter: bit-equal."""
    heat = np.round(_refine_fixture(14) * 1024) / np.float32(1024)
    ref = np.asarray(JH.refine_heatmap(jnp.asarray(heat))).astype(np.float32)
    got = TH.refine_heatmap(torch.from_numpy(heat)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_refine_heatmap_matches_reference():
    """On unquantized values the tile mean's prefix sum runs in another
    order: the reference's cumsum is an XLA reduce_window scan (measured up
    to 10 ulp from a sequential f32 cumsum over 256 values), the port's is
    sequential. The mean sums at most 77 values (0.3 * 256); the quotient
    carries its relative error: measured 3 ulp on this fixture. Bound: 4."""
    heat = _refine_fixture(14)
    ref = np.asarray(JH.refine_heatmap(jnp.asarray(heat))).astype(np.float32)
    got = TH.refine_heatmap(torch.from_numpy(heat)).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=4)
    assert np.mean(got == ref) > 0.7


def test_bilinear_sample_matches_reference():
    rng = np.random.RandomState(15)
    img = rng.rand(32, 40).astype(np.float32)
    x = rng.uniform(-1.5, 40.5, 500).astype(np.float32)
    y = rng.uniform(-1.5, 32.5, 500).astype(np.float32)
    ref = np.asarray(JH.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                        jnp.asarray(y)))
    got = TH.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                             torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def frame_inputs():
    """Refined heat, undistorted keypoints and validity from the port's net
    on the extractor test image (320x240 pinhole): realistic line heat."""
    rng = np.random.RandomState(5)
    h, w = 240, 320
    img = np.full((h, w), 128, np.uint8)
    for k in range(1, 6):
        img[k * 40, :] = 255
        img[:, k * 50] = 255
    for _ in range(8):
        x0, y0 = rng.randint(0, w - 80), rng.randint(0, h - 80)
        for t in range(80):
            img[y0 + t // 2, x0 + t] = 0
    img = np.clip(img.astype(np.int32) + rng.randint(-15, 15, (h, w)),
                  0, 255).astype(np.uint8)
    net = load_net(device="cpu")
    with torch.inference_mode():
        out = net(torch.from_numpy(img).float()[None, None] / 255.0)
    heat = TH.refine_heatmap(out["heat"][0])
    xy, _, valid = TN.nms_keypoints(out["junc_prob"][0])
    kp = xy.float()
    kp_ok = valid & (kp[:, 0] >= 1) & (kp[:, 0] < w - 1) & (kp[:, 1] >= 1) \
        & (kp[:, 1] < h - 1)
    desc = out["desc"][0].permute(1, 2, 0).contiguous()
    return dict(heat=heat.numpy(), kp_un=kp.numpy(), kp_ok=kp_ok.numpy(),
                valid=valid.numpy(), desc=desc.numpy())


@pytest.fixture(scope="module")
def reference_selection(frame_inputs):
    f = frame_inputs
    return jax.jit(JP.probe_and_select)(
        jnp.asarray(f["heat"]), jnp.asarray(f["kp_un"]),
        jnp.asarray(f["kp_ok"]))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_probe_and_select_matches_reference(frame_inputs, reference_selection,
                                            impl):
    f = frame_inputs
    ref = {k: np.asarray(v) for k, v in reference_selection.items()}
    got = TP.probe_and_select(torch.from_numpy(f["heat"]),
                              torch.from_numpy(f["kp_un"]),
                              torch.from_numpy(f["kp_ok"]), impl=impl)
    assert ref["n_cand"] > 50
    for key in ("ci", "cj", "cand_valid", "n_cand", "saturated"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)


def test_candidate_geometry_matches_reference(frame_inputs, reference_selection):
    kp = frame_inputs["kp_un"]
    ci = np.array(reference_selection["ci"])
    cj = np.array(reference_selection["cj"])
    ref = JP.candidate_geometry(jnp.asarray(kp), jnp.asarray(ci), jnp.asarray(cj))
    got = TP.candidate_geometry(torch.from_numpy(kp), torch.from_numpy(ci).long(),
                                torch.from_numpy(cj).long())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-6)


def test_validate_candidates_matches_reference(frame_inputs, reference_selection):
    f = frame_inputs
    sel = {k: np.array(v) for k, v in reference_selection.items()}
    dist, _, _ = JP.candidate_geometry(jnp.asarray(f["kp_un"]),
                                       jnp.asarray(sel["ci"]),
                                       jnp.asarray(sel["cj"]))
    good_j, ls_j, of_j = (np.asarray(a) for a in jax.jit(JP.validate_candidates)(
        jnp.asarray(f["heat"]), jnp.asarray(f["kp_un"]), jnp.asarray(sel["ci"]),
        jnp.asarray(sel["cj"]), dist, jnp.asarray(sel["cand_valid"])))
    good_t, ls_t, of_t = TP.validate_candidates(
        torch.from_numpy(f["heat"]), torch.from_numpy(f["kp_un"]),
        torch.from_numpy(sel["ci"]).long(), torch.from_numpy(sel["cj"]).long(),
        torch.from_numpy(np.array(dist)), torch.from_numpy(sel["cand_valid"]))
    assert good_j.sum() > 20
    np.testing.assert_array_equal(good_t.numpy(), good_j)
    assert bool(of_t) == bool(of_j)
    # the bounds of tests/test_extractor.py: a fused multiply-add in the
    # reference's sample positions can move one sample a cell
    diffs = np.abs(ls_t.numpy() - ls_j)[good_j]
    assert np.mean(diffs < 5e-4) > 0.9, diffs[diffs >= 5e-4]
    assert diffs.max() < 5e-2, diffs.max()


@pytest.mark.parametrize("n_valid,with_zero", [(5, True), (8, True), (5, False),
                                               (0, False)])
def test_update_compacted_mirrors_reference_scatter(n_valid, with_zero):
    """The reference's `r.at[sel].set(where(valid, vals, r[sel]))` runs its
    updates in order, and unused slots (index 0, after the valid ones) write
    r[0]'s old value back last: index 0 keeps its update only when every
    slot is valid."""
    cap = 8
    rng = np.random.RandomState(n_valid + 10 * with_zero)
    dst = rng.rand(32).astype(np.float32)
    idx = np.sort(rng.choice(np.arange(1, 32), n_valid, replace=False))
    if with_zero and n_valid:
        idx[0] = 0
    sel = np.zeros(cap, np.int64)
    sel[:n_valid] = idx
    valid = np.arange(cap) < n_valid
    vals = rng.rand(cap).astype(np.float32)
    ref = jax.jit(lambda r, s, v, ok: r.at[s].set(jnp.where(ok, v, r[s])))(
        jnp.asarray(dst), jnp.asarray(sel), jnp.asarray(vals),
        jnp.asarray(valid))
    got = TP._update_compacted(torch.from_numpy(dst), torch.from_numpy(sel),
                               torch.from_numpy(valid), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("length", [150.0, 50.0], ids=["long", "short"])
def test_validate_first_candidate_rejected_like_reference(length):
    """Pins a reference fault the port mirrors (ROADMAP.md §3): on a heat
    map that passes every line, candidate 0 is rejected when it needs a
    scattered long rate or a scattered score, because the unused slots of
    that scatter restore its old value. Candidates 1 and 2 pass."""
    heat = np.full((240, 320), 0.9, np.float32)
    kp = np.array([[20.0, 20.0], [20.0 + length, 20.0], [20.0, 20.0 + length]],
                  np.float32)
    ci = np.zeros(TP.CAND_CAP, np.int64)
    cj = np.zeros(TP.CAND_CAP, np.int64)
    ci[:3] = [0, 0, 1]
    cj[:3] = [1, 2, 2]
    valid = np.arange(TP.CAND_CAP) < 3
    dist = np.zeros(TP.CAND_CAP, np.float32)
    d = kp[cj[:3]] - kp[ci[:3]]
    dist[:3] = np.sqrt((d * d).sum(1))
    good_j, _, _ = jax.jit(JP.validate_candidates)(
        jnp.asarray(heat), jnp.asarray(kp), jnp.asarray(ci.astype(np.int32)),
        jnp.asarray(cj.astype(np.int32)), jnp.asarray(dist), jnp.asarray(valid))
    good_t, _, _ = TP.validate_candidates(
        torch.from_numpy(heat), torch.from_numpy(kp), torch.from_numpy(ci),
        torch.from_numpy(cj), torch.from_numpy(dist), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(good_j)[:3], [False, True, True])
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))


def test_sample_descriptors_matches_reference(frame_inputs):
    rng = np.random.RandomState(16)
    desc = frame_inputs["desc"]  # (30, 40, 256) from the net
    k = 300
    kp = np.stack([rng.uniform(-3, 323, k), rng.uniform(-3, 243, k)],
                  1).astype(np.float32)
    kp[:20] = np.round(kp[:20])
    kp[-10:] = -50.0  # the invalid-slot position of nms_keypoints
    ok = rng.rand(k) > 0.1
    ref = np.asarray(jax.jit(JD.sample_descriptors, static_argnums=(3, 4))(
        jnp.asarray(desc), jnp.asarray(kp), jnp.asarray(ok), 320, 240))
    got = TD.sample_descriptors(torch.from_numpy(desc), torch.from_numpy(kp),
                                torch.from_numpy(ok), 320, 240).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_descriptor_distance_matrix_matches_reference():
    rng = np.random.RandomState(17)
    a = rng.randn(40, 256).astype(np.float32)
    b = rng.randn(60, 256).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ref = np.asarray(JD.descriptor_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = TD.descriptor_distance_matrix(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
