"""Port parity on the caps and flags of the pair probe and line validation
(ops/pairs.py), which the fused CUDA kernels' compaction and finalise
passes must reproduce: the plain path against the JAX package on a heat map
that saturates every cap, the `impl=` dispatch on CPU tensors, and the
kernel build's header tracking."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ppg_slam_tpu.ops import pairs as JP

from ppg_slam_tpu_torch import kernels
from ppg_slam_tpu_torch.ops import pairs as TP
from ppg_slam_tpu_torch.testing import saturating_case


def _empty_inputs():
    heat = np.zeros((240, 320), np.float32)
    _, kp, ok = saturating_case()
    return heat, kp, ok


def _random_inputs():
    rng = np.random.RandomState(22)
    heat = (rng.rand(240, 320) ** 4).astype(np.float32)
    heat[::9, :] = 0.8
    heat[:, ::13] = 0.6
    kp = np.stack([rng.uniform(2, 317, 300), rng.uniform(2, 237, 300)],
                  1).astype(np.float32)
    return heat, kp, rng.rand(300) > 0.05


_FIXTURES = {"saturating": saturating_case, "empty": _empty_inputs,
             "random": _random_inputs}


@pytest.fixture(scope="module")
def saturating_reference():
    """The JAX package's probe and validation on the saturating fixture."""
    heat, kp, ok = saturating_case()
    sel = {k: np.array(v) for k, v in jax.jit(JP.probe_and_select)(
        jnp.asarray(heat), jnp.asarray(kp), jnp.asarray(ok)).items()}
    dist, _, _ = JP.candidate_geometry(jnp.asarray(kp), jnp.asarray(sel["ci"]),
                                       jnp.asarray(sel["cj"]))
    good, lscore, overflow = (np.array(a) for a in jax.jit(
        JP.validate_candidates)(jnp.asarray(heat), jnp.asarray(kp),
                                jnp.asarray(sel["ci"]), jnp.asarray(sel["cj"]),
                                dist, jnp.asarray(sel["cand_valid"])))
    return dict(sel=sel, dist=np.array(dist), good=good, lscore=lscore,
                overflow=overflow)


def test_probe_saturated_matches_reference(saturating_reference):
    heat, kp, ok = saturating_case()
    ref = saturating_reference["sel"]
    got = TP.probe_and_select(torch.from_numpy(heat), torch.from_numpy(kp),
                              torch.from_numpy(ok), impl="plain")
    assert bool(ref["saturated"]) and int(ref["n_cand"]) > TP.CAND_CAP
    for key in ("ci", "cj", "cand_valid", "n_cand", "saturated"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)


def test_validate_overflow_matches_reference(saturating_reference):
    heat, kp, _ = saturating_case()
    ref = saturating_reference
    sel = ref["sel"]
    # the fixture exercises both caps
    h, w = heat.shape
    lvl = np.clip((ref["dist"] * np.float32(TP._inv_scale(h, w))
                   * np.float32(4)).astype(np.int32), 0, 3)
    seg = np.clip((ref["dist"] * np.asarray(TP.INV_SAMPLE_GAP, np.float32)[lvl])
                  .astype(np.int32), 0, TP.MAX_SEG)
    assert (seg > TP.SHORT_S).sum() > TP.LONG_CAP
    assert ((seg >= 2) & (seg <= TP.SHORT_S)).sum() > TP.SCORE_S_CAP
    good, lscore, overflow = TP.validate_candidates(
        torch.from_numpy(heat), torch.from_numpy(kp),
        torch.from_numpy(sel["ci"]).long(), torch.from_numpy(sel["cj"]).long(),
        torch.from_numpy(ref["dist"]), torch.from_numpy(sel["cand_valid"]),
        impl="plain")
    assert bool(ref["overflow"])
    np.testing.assert_array_equal(good.numpy(), ref["good"])
    assert bool(overflow) == bool(ref["overflow"])
    # candidate 0 keeps its long rate and score: both compactions are full
    assert seg[0] > TP.SHORT_S and ref["good"][0]
    # the bounds of test_validate_candidates_matches_reference
    diffs = np.abs(lscore.numpy() - ref["lscore"])[ref["good"]]
    assert np.mean(diffs < 5e-4) > 0.9, diffs[diffs >= 5e-4]
    assert diffs.max() < 5e-2, diffs.max()


def _run_both(fixture, impl):
    heat, kp, ok = (torch.from_numpy(a) for a in _FIXTURES[fixture]())
    sel = TP.probe_and_select(heat, kp, ok, impl=impl)
    dist, _, _ = TP.candidate_geometry(kp, sel["ci"], sel["cj"])
    good, lscore, overflow = TP.validate_candidates(
        heat, kp, sel["ci"], sel["cj"], dist, sel["cand_valid"], impl=impl)
    return dict(sel, good=good, lscore=lscore, overflow=overflow)


@pytest.mark.parametrize("fixture", sorted(_FIXTURES))
def test_kernel_impl_on_cpu_runs_plain(fixture):
    """impl="kernel" on CPU tensors takes the plain version: equal outputs,
    and no kernel launch."""
    before = (TP.pair_probe.launches, TP.line_validate.launches)
    got = _run_both(fixture, "kernel")
    ref = _run_both(fixture, "plain")
    assert (TP.pair_probe.launches, TP.line_validate.launches) == before
    for key, val in ref.items():
        assert torch.equal(got[key], val), key
    if fixture == "empty":
        assert int(ref["n_cand"]) == 0 and not bool(ref["saturated"])
        assert not bool(ref["good"].any()) and not bool(ref["overflow"])


@pytest.mark.parametrize("fn", ["probe", "validate"])
def test_unknown_impl_raises(fn):
    heat, kp, ok = (torch.from_numpy(a) for a in _random_inputs())
    if fn == "probe":
        call = lambda: TP.probe_and_select(heat, kp, ok, impl="cuda")
    else:
        ci = torch.zeros(TP.CAND_CAP, dtype=torch.int64)
        call = lambda: TP.validate_candidates(
            heat, kp, ci, ci, torch.zeros(TP.CAND_CAP),
            torch.zeros(TP.CAND_CAP, dtype=torch.bool), impl="sampler")
    with pytest.raises(ValueError, match="impl"):
        call()


def test_validate_indices_follow_torch_indexing():
    """The plain validation indexes kp_un as PyTorch does, which the
    line_validate kernel mirrors: index -1 is keypoint K-1, and an index
    outside [-K, K) raises."""
    heat, kp, _ = (torch.from_numpy(a) for a in _random_inputs())
    k = kp.shape[0]
    ci = torch.zeros(TP.CAND_CAP, dtype=torch.int64)
    ci[:3] = torch.tensor([0, 5, 7])
    cj = torch.zeros_like(ci)
    cj[:3] = torch.tensor([k - 1, k - 2, 9])
    valid = torch.arange(TP.CAND_CAP) < 3
    dist, _, _ = TP.candidate_geometry(kp, ci, cj)
    ref = TP.validate_candidates(heat, kp, ci, cj, dist, valid, impl="plain")
    cj_neg = cj.clone()
    cj_neg[:2] -= k
    got = TP.validate_candidates(heat, kp, ci, cj_neg, dist, valid,
                                 impl="plain")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    cj[2] = k
    with pytest.raises(IndexError):
        TP.validate_candidates(heat, kp, ci, cj, dist, valid, impl="plain")


def test_fused_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; only the
    impl="kernel" dispatch sends CPU tensors to the plain version."""
    heat, kp, ok = (torch.from_numpy(a) for a in _random_inputs())
    ci = torch.zeros(TP.CAND_CAP, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        TP.pair_probe(heat, kp, ok)
    with pytest.raises(ValueError, match="CUDA"):
        TP.line_validate(heat, kp, ci, ci, torch.zeros(TP.CAND_CAP),
                         torch.zeros(TP.CAND_CAP, dtype=torch.bool))


def test_kernel_sources_follow_includes():
    names = {n: [os.path.basename(p) for p in kernels.sources(n)]
             for n in kernels.SIGNATURES}
    assert sorted(names["nearest_binary_packed"]) == [
        "nearest_binary_packed.cu", "packed_mask.cuh"]
    for n in ("pair_probe", "line_validate"):
        assert sorted(names[n]) == sorted([f"{n}.cu", "block_scan.cuh",
                                           "packed_mask.cuh"])


def test_stale_when_only_a_shared_header_is_newer(tmp_path, monkeypatch):
    """A built library is stale when a header its source includes is newer,
    even where the .cu file itself is older (on a copy of the sources)."""
    src = tmp_path / "kernels"
    build = tmp_path / "_build"
    src.mkdir()
    build.mkdir()
    for f in os.listdir(kernels._DIR):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(kernels._DIR, f), src / f)
    monkeypatch.setattr(kernels, "_DIR", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    for f in os.listdir(src):
        os.utime(src / f, (1000, 1000))
    for n in kernels.SIGNATURES:
        assert kernels._stale(n)  # not built
        (build / f"lib{n}.so").write_bytes(b"")
        os.utime(build / f"lib{n}.so", (2000, 2000))
        assert not kernels._stale(n)
    os.utime(src / "block_scan.cuh", (3000, 3000))
    assert not kernels._stale("nearest_binary_packed")
    assert kernels._stale("pair_probe") and kernels._stale("line_validate")
    os.utime(src / "packed_mask.cuh", (3000, 3000))
    assert kernels._stale("nearest_binary_packed")
