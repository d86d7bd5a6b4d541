"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor ppg_slam_tpu, so it also runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ppg_slam_tpu_torch.ops import pairs as TP
from ppg_slam_tpu_torch.ops import sampling
from ppg_slam_tpu_torch.testing import LSCORE_MAX_ULP, saturating_case, ulp_diff

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _mask_and_samples(seed, n, h=480, w=752):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w) > 0.7, rng.randint(0, h, n).astype(np.int32),
            rng.randint(0, w, n).astype(np.int32))


@pytest.mark.parametrize("n", [250000, 32768, 131072, 65024, 1])
def test_nearest_binary_packed_kernel_matches_plain(cuda_device, n):
    """Bit for bit at the main path's sample counts (and one sample)."""
    mask, ys, xs = _mask_and_samples(n % 97, n)
    packed = sampling.pack_binary_mask(torch.from_numpy(mask)).to(cuda_device)
    y = torch.from_numpy(ys).to(cuda_device)
    x = torch.from_numpy(xs).to(cuda_device)
    before = sampling.nearest_binary_packed.launches
    got = sampling.nearest_binary_packed(packed, y, x)
    torch.cuda.synchronize()
    assert sampling.nearest_binary_packed.launches == before + 1
    assert torch.equal(got, sampling.nearest_binary_packed_ref(packed, y, x))
    assert torch.equal(got.cpu(), torch.from_numpy(mask[ys, xs]))


def test_nearest_binary_packed_rejects_wrong_inputs(cuda_device):
    packed = torch.zeros(4, 2, dtype=torch.uint8, device=cuda_device)
    y = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        sampling.nearest_binary_packed(packed.float(), y, y)
    with pytest.raises(ValueError):
        sampling.nearest_binary_packed(packed, y.long(), y.long())


def _random_case(k=500, h=480, w=752, seed=3):
    rng = np.random.RandomState(seed)
    heat = (rng.rand(h, w) ** 4).astype(np.float32)
    heat[::9, :] = 0.8
    heat[:, ::13] = 0.6
    kp = np.stack([rng.uniform(2, w - 3, k), rng.uniform(2, h - 3, k)],
                  1).astype(np.float32)
    return heat, kp, np.ones(k, bool)


def _empty_case():
    heat, kp, ok = _random_case()
    return np.zeros_like(heat), kp, ok


_CASES = {"random_k500": _random_case,
          "random_k7": lambda: _random_case(k=7, seed=4),
          "saturating": saturating_case, "empty": _empty_case}


def _check_validate(heat, kp, ci, cj, dist, valid):
    before = TP.line_validate.launches
    got = TP.line_validate(heat, kp, ci, cj, dist, valid)
    mask = sampling.pack_binary_mask(heat > TP.LINE_HEATMAP_THRESH)
    ref = TP._validate_from_mask(mask, heat, kp, ci, cj, dist, valid)
    torch.cuda.synchronize()
    assert TP.line_validate.launches == before + 1
    assert torch.equal(got["overflow"], ref["overflow"])
    assert torch.equal(got["rate"], ref["rate"])
    assert ulp_diff(got["score"], ref["score"]) <= LSCORE_MAX_ULP
    near = (ref["score"] - TP.LINE_HEATMAP_THRESH).abs() <= (
        LSCORE_MAX_ULP * 2.0 ** -23 * TP.LINE_HEATMAP_THRESH)
    differ = got["good"] != ref["good"]
    assert not bool((differ & ~near).any()), "good differs away from 0.2"
    assert not bool(differ.any()), f"{int(differ.sum())} near-threshold flips"
    assert ulp_diff(got["lscore"], ref["lscore"]) <= LSCORE_MAX_ULP
    return got


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_kernels_equal_plain(cuda_device, case):
    """pair_probe and line_validate against the plain version: bit-equal
    outputs, lscore within LSCORE_MAX_ULP."""
    heat, kp, ok = (torch.from_numpy(a).to(cuda_device)
                    for a in _CASES[case]())
    before = TP.pair_probe.launches
    sel = TP.pair_probe(heat, kp, ok)
    ref = TP.probe_and_select(heat, kp, ok, impl="plain")
    torch.cuda.synchronize()
    assert TP.pair_probe.launches == before + 1
    for key, val in ref.items():
        assert torch.equal(sel[key], val), key
    dist, _, _ = TP.candidate_geometry(kp, ref["ci"], ref["cj"])
    got = _check_validate(heat, kp, ref["ci"], ref["cj"], dist,
                          ref["cand_valid"])
    n_cand = int(ref["n_cand"])
    if case == "empty":
        assert n_cand == 0 and not bool(got["good"].any())
    elif case == "saturating":
        assert bool(ref["saturated"]) and bool(got["overflow"])
    else:
        assert n_cand > 0


@pytest.mark.parametrize("length", [150.0, 50.0], ids=["long", "short"])
def test_line_validate_slot0_like_plain(cuda_device, length):
    """The inputs of tests/test_torch_decode.py
    test_validate_first_candidate_rejected_like_reference: candidate 0 is
    rejected (the slot-0 revert), candidates 1 and 2 pass."""
    heat = torch.full((240, 320), 0.9, device=cuda_device)
    kp = torch.tensor([[20.0, 20.0], [20.0 + length, 20.0],
                       [20.0, 20.0 + length]], device=cuda_device)
    ci = torch.zeros(TP.CAND_CAP, dtype=torch.int64, device=cuda_device)
    cj = torch.zeros_like(ci)
    ci[:3] = torch.tensor([0, 0, 1])
    cj[:3] = torch.tensor([1, 2, 2])
    valid = torch.arange(TP.CAND_CAP, device=cuda_device) < 3
    dist, _, _ = TP.candidate_geometry(kp, ci, cj)
    got = _check_validate(heat, kp, ci, cj, dist, valid)
    assert got["good"][:3].tolist() == [False, True, True]


def test_fused_kernels_reject_wrong_inputs(cuda_device):
    heat = torch.zeros(48, 64, device=cuda_device)
    kp = torch.zeros(513, 2, device=cuda_device)
    ok = torch.ones(513, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        TP.pair_probe(heat, kp, ok)
    with pytest.raises(ValueError, match="float32"):
        TP.pair_probe(heat, kp.double(), ok)
    ci = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int64"):
        TP.line_validate(heat, kp, ci, ci, torch.zeros(8, device=cuda_device),
                         torch.zeros(8, dtype=torch.bool, device=cuda_device))


def test_line_validate_indices_like_plain(cuda_device):
    """Negative indices count from the end, as in the plain version; an
    index outside [-K, K) raises IndexError (the launch still counts)."""
    heat, kp, _ = (torch.from_numpy(a).to(cuda_device)
                   for a in _random_case(k=40, seed=5))
    k = kp.shape[0]
    ci = torch.zeros(TP.CAND_CAP, dtype=torch.int64, device=cuda_device)
    cj = torch.zeros_like(ci)
    ci[:3] = torch.tensor([0, 5, 7])
    cj[:3] = torch.tensor([k - 1, k - 2, 9])
    valid = torch.arange(TP.CAND_CAP, device=cuda_device) < 3
    dist, _, _ = TP.candidate_geometry(kp, ci, cj)
    ref = _check_validate(heat, kp, ci, cj, dist, valid)
    cj_neg = cj.clone()
    cj_neg[:2] -= k
    got = _check_validate(heat, kp, ci, cj_neg, dist, valid)
    for key in ("good", "lscore", "overflow", "rate", "score"):
        assert torch.equal(got[key], ref[key]), key
    for bad in (k, -k - 1):
        cj_bad = cj.clone()
        cj_bad[TP.CAND_CAP - 1] = bad  # an unused slot counts too
        before = TP.line_validate.launches
        with pytest.raises(IndexError):
            TP.line_validate(heat, kp, ci, cj_bad, dist, valid)
        assert TP.line_validate.launches == before + 1


def test_extract_batch_on_a_two_shard_mesh(cuda_device):
    """extract_batch(mesh=) over two shards of cuda:0 equals extract_batch
    bit for bit, 3 frames padded to 4, and launches each fused kernel once
    a frame (the padding frame included)."""
    from ppg_slam_tpu_torch.frontend import PPGExtractor
    from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel
    from ppg_slam_tpu_torch.parallel import Mesh

    cam = CameraModel(kind=CAM_PINHOLE, fx=300.0, fy=300.0, cx=376.0,
                      cy=240.0, dist=(0.0, 0.0, 0.0, 0.0), width=752,
                      height=480)
    rng = np.random.RandomState(8)
    base = np.full((480, 800), 110, np.int32)
    for k in range(1, 20):
        base[:, k * 37 % 800] = 230
        base[k * 23 % 480, :] = 20
    frames = [np.clip(base[:, 8 * i:8 * i + 752]
                      + rng.randint(-12, 12, (480, 752)), 0, 255
                      ).astype(np.uint8) for i in range(3)]
    ex = PPGExtractor(cam, device=cuda_device)
    ref = ex.extract_batch(frames)
    before = (TP.pair_probe.launches, TP.line_validate.launches)
    got = ex.extract_batch(frames, mesh=Mesh([cuda_device, cuda_device]))
    assert (TP.pair_probe.launches - before[0],
            TP.line_validate.launches - before[1]) == (4, 4)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.n_kp == r.n_kp
        for name in ("kp_pos_un", "kp_score", "edges", "edge_score",
                     "colines", "desc"):
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name),
                                          err_msg=name)
