"""Port parity: ppg_slam_tpu_torch.ops.device_match against
ppg_slam_tpu.ops.device_match on seeded random banks and gate rectangles."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ppg_slam_tpu.ops import device_match as J

from ppg_slam_tpu_torch.ops import device_match as T


def _problem(seed=0, m=48, n=96, cap=128):
    rng = np.random.RandomState(seed)
    bank = rng.randn(cap, 256).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    fd = rng.randn(n, 256).astype(np.float32)
    fd /= np.linalg.norm(fd, axis=1, keepdims=True)
    kp = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    valid = rng.rand(n) > 0.1
    idx = rng.permutation(cap)[:m].astype(np.int32)
    idx[::7] = -1  # dead rows
    c = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    r = rng.uniform(5, 40, m).astype(np.float32)
    rects = np.stack([c[:, 0] - r, c[:, 0] + r, c[:, 1] - r, c[:, 1] + r],
                     1).astype(np.float32)
    return bank, idx, fd, kp, valid, rects


def _min_gap(arrays, k=8):
    """Smallest gap between consecutive in-gate distances among each row's
    k+1 nearest: the fixtures keep it >= 2e-5, far above the 1e-6 the two
    bf16 distance computations differ by, so the ranking has no ties."""
    bank, idx, fd, kp, valid, rects = arrays
    D = np.asarray(J.dist_block(jnp.asarray(bank[np.maximum(idx, 0)]),
                                jnp.asarray(fd)))
    inside = ((kp[None, :, 0] > rects[:, 0:1]) & (kp[None, :, 0] < rects[:, 1:2])
              & (kp[None, :, 1] > rects[:, 2:3]) & (kp[None, :, 1] < rects[:, 3:4])
              & valid[None] & (idx >= 0)[:, None])
    gaps = [np.diff(np.sort(D[r, inside[r]])[:k + 1]).min()
            for r in range(len(idx)) if inside[r].sum() > 1]
    return min(gaps)


def _both(fn_j, fn_t, arrays, **kw):
    ref = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return ref, got


@pytest.mark.parametrize("seed,k", [(1, 8), (5, 4)])
def test_gated_topk_matches_reference(seed, k):
    arrays = _problem(seed)
    assert _min_gap(arrays, k) >= 2e-5
    (ri, rd, rn), (gi, gd, gn) = _both(J.gated_topk, T.gated_topk, arrays, k=k)
    ri, rd, rn = np.asarray(ri), np.asarray(rd), np.asarray(rn)
    assert (rn > k).any() and (rn == 0).any()
    np.testing.assert_array_equal(gi.numpy(), ri)
    np.testing.assert_array_equal(gn.numpy(), rn)
    # both sides round the operands to bf16 and sum f32 products
    np.testing.assert_allclose(gd.numpy(), rd, atol=1e-6, rtol=0)


def test_dist_block_matches_reference():
    bank, _, fd, *_ = _problem(2)
    ref = np.asarray(J.dist_block(jnp.asarray(bank[:40]), jnp.asarray(fd)))
    got = T.dist_block(torch.from_numpy(bank[:40]), torch.from_numpy(fd)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_flatten_and_pack_match_reference():
    arrays = _problem(6)
    assert _min_gap(arrays) >= 2e-5
    k = 8
    tables_j = J.gated_topk(*(jnp.asarray(a) for a in arrays), k=k)
    tables_t = T.gated_topk(*(torch.from_numpy(a) for a in arrays), k=k)
    for cap in (J.PAIR_CAP, 64):  # 64: the flat list is cut
        ref = [np.asarray(a) for a in J.flatten_topk(*tables_j, pair_cap=cap)]
        got = [a.numpy() for a in T.flatten_topk(*tables_t, pair_cap=cap)]
        for name, g, r in zip(("rows", "kps", "ds", "n_pairs", "n_over"),
                              got, ref):
            if name == "ds":
                np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(g, r, err_msg=name)
    m = arrays[1].shape[0]
    buf_j = np.asarray(J.gated_match_packed(*(jnp.asarray(a) for a in arrays)))
    buf_t = T.gated_match_packed(*(torch.from_numpy(a) for a in arrays)).numpy()
    assert buf_t.dtype == np.uint8 and buf_t.shape == buf_j.shape
    cap = min(J.PAIR_CAP, m * J.MATCH_K)
    rj = J.unpack_match(buf_j, cap)
    rt = T.unpack_match(buf_t, cap)
    for g, r in zip(rt[:2] + rt[3:], rj[:2] + rj[3:]):
        np.testing.assert_array_equal(g, r)
    # f16 distances: equal up to one f16 rounding step of a 1e-6 difference
    np.testing.assert_allclose(rt[2].astype(np.float32),
                               rj[2].astype(np.float32), atol=1e-3, rtol=0)


def test_quantize_desc_i8_bytes_match_reference():
    rng = np.random.RandomState(4)
    d = rng.randn(500, 256).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[-3:] = 0.0  # zero descriptors (the <10-keypoint quirk) keep scale 1e-8
    ref = np.asarray(J.quantize_desc_i8(jnp.asarray(d)))
    got = T.quantize_desc_i8(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(T.dequantize_desc_i8(got, 500),
                                  J.dequantize_desc_i8(ref, 500))


def test_bank_update_matches_reference():
    rng = np.random.RandomState(5)
    bank = rng.randn(64, 256).astype(np.float32)
    slots = np.array([3, 9, 60], np.int32)
    descs = rng.randn(3, 256).astype(np.float32)
    ref = np.asarray(J.bank_update(jnp.asarray(bank), jnp.asarray(slots),
                                   jnp.asarray(descs)))
    got = T.bank_update(torch.from_numpy(bank.copy()), torch.from_numpy(slots),
                        torch.from_numpy(descs)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cap", [J.PAIR_CAP, 64, 384])
def test_match_bytes_matches_reference(cap):
    assert T.match_bytes(cap) == J.match_bytes(cap) == cap * 6 + 8
    buf = T.gated_match_packed(*(torch.from_numpy(a) for a in _problem(3)),
                               pair_cap=cap)
    assert buf.numel() == T.match_bytes(min(cap, 48 * T.MATCH_K))


def _batch(seeds, cap=128):
    """B frames (bank slots, descriptors, keypoints, gates) from _problem
    against the first seed's bank."""
    frames = [_problem(s, cap=cap) for s in seeds]
    bank = frames[0][0]
    for f in frames:
        assert _min_gap((bank,) + f[1:]) >= 2e-5
    return bank, [np.stack([f[i] for f in frames]) for i in range(1, 6)]


def test_gated_match_batch_packed_matches_frames_and_reference():
    """B = 3 frames against one bank: each row of the batched buffer is
    gated_match_packed of that frame, bit for bit, and holds the JAX
    batched call's matches: the counters and the (row, keypoint) pairs
    exactly, the f16 distances to one f16 step. The order of two matches
    of one row may differ where their distances lie ~1e-4 apart: the
    reference's jit-compiled program computes its bf16 distances to about
    that (its standalone gated_topk, to 1e-6), and swaps such pairs."""
    bank, stacked = _batch((1, 4, 7))
    got = T.gated_match_batch_packed(torch.from_numpy(bank),
                                     *(torch.from_numpy(a) for a in stacked))
    assert got.dtype == torch.uint8 and got.shape == (3, T.match_bytes(384))
    for b in range(3):
        one = T.gated_match_packed(torch.from_numpy(bank),
                                   *(torch.from_numpy(a[b]) for a in stacked))
        assert torch.equal(got[b], one)
    ref = np.asarray(J.gated_match_batch_packed(
        jnp.asarray(bank), *(jnp.asarray(a) for a in stacked)))
    assert ref.shape == tuple(got.shape)
    for b in range(3):
        rj = J.unpack_match(ref[b], 384)
        rt = T.unpack_match(got[b].numpy(), 384)
        assert rj[3] > 0 and rt[3:] == rj[3:]
        oj = np.lexsort((rj[1], rj[0]))
        ot = np.lexsort((rt[1], rt[0]))
        for g, r in zip(rt[:3], rj[:3]):
            g, r = g[ot], r[oj]
            if g.dtype == np.float16:
                np.testing.assert_allclose(g.astype(np.float32),
                                           r.astype(np.float32), atol=1e-3,
                                           rtol=0)
            else:
                np.testing.assert_array_equal(g, r)
        assert (rt[0] == rj[0]).all()  # row order of the flat list
