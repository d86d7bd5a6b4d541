"""Local BA's LM iterations replayed from CUDA graphs (estimator.ba.
LocalBAReplay) against the eager solve on the same inputs, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor ppg_slam_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_local_ba_replay_cuda.py -q
"""

import contextlib
import copy
import types
import warnings

import numpy as np
import pytest
import torch

from ppg_slam_tpu_torch import testing
from ppg_slam_tpu_torch import worldmap as pwm
from ppg_slam_tpu_torch.estimator import ba as B
from ppg_slam_tpu_torch.estimator import ba_core
from ppg_slam_tpu_torch.utils import profiler
from slam_bench import registry

pytestmark = pytest.mark.cuda

TIMERS = ("local_ba.capture", "local_ba.replay", "local_mapping.lba")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def window():
    """phase 8's 20-KF EuRoC window as a built map (integrated on the
    card), and a function that gives a fresh copy of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    win = testing.EurocWindow(seed=3)
    pwm.reset_ids()
    built = win.build(testing.port_namespace("cuda", testing.EUROC_CAM))
    return lambda: copy.deepcopy(built)


@contextlib.contextmanager
def deterministic_sums():
    """CUDA's index_add_ in a fixed order: two solves then part by their
    own arithmetic only, not by the order of atomic adds (which alone moves
    two eager calls on this window apart by 1.3-1.7e-4 of the largest
    entry)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def counts():
    return {k: profiler.stats[k].count if k in profiler.stats else 0
            for k in TIMERS}


def state_of(built) -> dict:
    """The keyframes' body rotations, positions, velocities, gyro and
    accelerometer biases and the points, each stacked."""
    wmap, kfs, mps = built
    return dict(R=np.stack([kf.imu_rotation() for kf in kfs]),
                p=np.stack([kf.imu_position() for kf in kfs]),
                v=np.stack([kf.velocity for kf in kfs]),
                bg=np.stack([kf.bias[:3] for kf in kfs]),
                ba=np.stack([kf.bias[3:] for kf in kfs]),
                points=np.stack([mp.pos for mp in mps.values()]))


def liba(built, replay, **kw):
    wmap, kfs, _ = built
    return B.local_inertial_ba(kfs[-1], wmap, device="cuda", replay=replay,
                               **kw)


def test_replay_matches_solve_ba_on_the_padded_problem(cuda_device, window,
                                                      monkeypatch):
    """The replay of the window's local inertial BA against solve_ba run
    eagerly on the same padded inputs, deterministic sums: the same
    iterations, accepts and values (the graph holds the eager iteration's
    kernels)."""
    seen = []
    solve = B._padded_solve

    def spy(*args, **kw):
        seen.append(args)
        return solve(*args, **kw)

    monkeypatch.setattr(B, "_padded_solve", spy)
    liba(window(), None)
    states, points, prob, kf_dof, mp_free, rig, opts, device = seen[0]
    replay = B.LocalBAReplay(cuda_device)
    with deterministic_sums():
        key = replay.key(len(kf_dof), len(points), prob, rig, opts, False,
                         device)
        graph = replay.load(key, states, points, prob, kf_dof, mp_free, rig)
        st, pts, info = graph.run(opts)
        got = [x.cpu().numpy() for x in (*st, pts)]
        dev = [torch.from_numpy(a).to(cuda_device) for a in B.pad_inputs(
            states, points, prob, kf_dof, mp_free, key[0])]
        rst, rpts, ref = ba_core.solve_ba(
            ba_core.KFStates(*dev[:5]), dev[5], ba_core.BAProblem(*dev[8:]),
            dev[6], dev[7], torch.from_numpy(rig.Rcb).to(cuda_device),
            torch.from_numpy(rig.tcb).to(cuda_device), rig.cam, opts)
    n, m = len(kf_dof), len(points)
    want = [x[:n].cpu().numpy() for x in rst] + [rpts[:m].cpu().numpy()]
    gap = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, want))
    print(f"{n} KFs, {m} points in bucket {key[0]}: {info['iters_run']} "
          f"iterations, {info['host_syncs']} host reads (eager "
          f"{ref['host_syncs']}); gap {gap:.3g} of the largest entry")
    assert info["iters_run"] == ref["iters_run"]
    assert info["accepted"] == ref["accepted"]
    assert info["host_syncs"] == info["iters_run"] < ref["host_syncs"]
    assert gap <= 1e-6


# local_inertial_ba replayed against eager differs by the padded problem's
# summation order alone: each array's largest gap over its own largest
# entry within GAP_LIMITS, and under MOVE_SHARE of the most the solve moved
# that array (a stale or misrouted write-back reads its whole move).
# Measured on an H100: R 5.0e-6, p 9.4e-6, v 1.3e-5, bg 0.039, ba 0.013,
# points 1.7e-4; the eager call with CUDA's atomic sums against itself with
# deterministic ones, over 6 calls, up to 5.6e-6, 8.9e-6, 2.3e-5, 0.062,
# 0.013 and 2.1e-4. The gyro biases start at 0 and end within 6.2e-6
# rad/s, so their share is large and their move small (gap / move 0.039).
GAP_LIMITS = dict(R=2e-5, p=2e-5, v=5e-5, bg=0.1, ba=0.03, points=5e-4)
MOVE_SHARE = 0.1


def test_replayed_local_inertial_ba_matches_eager(cuda_device, window):
    """local_inertial_ba through the replay against the eager call on a
    copy of the same map, deterministic sums: the same iterations and
    observations erased; the keyframes' rotations, positions, velocities,
    gyro and accelerometer biases and the points each within GAP_LIMITS
    and MOVE_SHARE. The first call captures, the second replays the same
    graph."""
    replay = B.LocalBAReplay(cuda_device)
    start = state_of(window())
    for call in range(2):
        before = counts()
        eager_map, replay_map = window(), window()
        with deterministic_sums():
            ref = liba(eager_map, None)
            got = liba(replay_map, replay)
        after = counts()
        assert after["local_ba.replay"] - before["local_ba.replay"] == 1
        assert (after["local_ba.capture"]
                - before["local_ba.capture"]) == (call == 0)
        assert got["iters_run"] == ref["iters_run"]
        assert got["n_erased"] == ref["n_erased"]
        want, have = state_of(eager_map), state_of(replay_map)
        gap = {k: float(np.abs(have[k] - r).max()) for k, r in want.items()}
        top = {k: float(np.abs(r).max()) for k, r in want.items()}
        move = {k: float(np.abs(r - start[k]).max()) for k, r in want.items()}
        shares = ", ".join(f"{k} {gap[k] / top[k]:.3g}, "
                           f"{gap[k] / max(move[k], 1e-30):.3g}" for k in gap)
        print(f"call {call}: {ref['n_kf']} KFs, {ref['n_mp']} points, "
              f"{ref['n_obs']} observations, {ref['iters_run']} iterations;"
              f" gap / largest, gap / move: {shares}; chi2 "
              f"{ref['final_chi2']} / {got['final_chi2']}")
        for k in gap:
            assert gap[k] <= GAP_LIMITS[k] * top[k], (k, gap[k] / top[k])
            assert gap[k] <= MOVE_SHARE * move[k], (k, gap[k] / move[k])
    assert len(replay._graphs) == 1


def test_one_capture_per_key_and_the_least_recent_evicted(cuda_device,
                                                          window,
                                                          monkeypatch):
    """Solves of three buckets (the window's first 6, 12 and 20 KFs) and a
    visual LBA: a capture at each new key and none on its repeats; with
    room for two graphs the least recently used one goes."""
    monkeypatch.setattr(B, "MAX_GRAPHS", 2)
    replay = B.LocalBAReplay(cuda_device)
    win = testing.EurocWindow(seed=3)
    maps = {}
    for n in (6, 12):
        pwm.reset_ids()
        maps[n] = win.build(testing.port_namespace("cuda", testing.EUROC_CAM),
                            n_kf=n)
    before = counts()
    keys = []
    for n in (6, 12, 6):
        liba(copy.deepcopy(maps[n]), replay)
        keys.append(list(replay._graphs)[-1])
    liba(window(), replay)
    keys.append(list(replay._graphs)[-1])
    after = counts()
    assert keys[0] == keys[2] and len(set(keys)) == 3, [k[0] for k in keys]
    assert after["local_ba.capture"] - before["local_ba.capture"] == 3
    assert after["local_ba.replay"] - before["local_ba.replay"] == 4
    # room for two: the 12-KF key went, the 6-KF one (used third) stayed
    assert list(replay._graphs) == [keys[0], keys[3]]
    wmap, kfs, _ = window()
    assert B.local_bundle_adjustment(kfs[-1], wmap, device="cuda",
                                     replay=replay) is not None
    assert counts()["local_ba.capture"] - after["local_ba.capture"] == 1
    assert len(replay._graphs) == 2


def test_a_solve_past_the_largest_bucket_runs_eagerly(cuda_device, window,
                                                      monkeypatch):
    replay = B.LocalBAReplay(cuda_device)
    built = window()
    # caps below this window's map points: its solve does not fit
    monkeypatch.setattr(B, "BUCKET_CAPS", (256, 256) + B.BUCKET_CAPS[2:])
    before = counts()
    eager = liba(built, replay)
    assert eager is not None and eager["n_mp"] > 256
    assert counts() == before and not replay._graphs


def test_lba_replay_share_reads_the_counters(cuda_device, window,
                                             monkeypatch):
    """lba_replay_share (slam_bench/metrics) over local_mapping.lba calls
    as LocalMapping makes them: two replayed and one past the caps read
    2/3."""
    replay = B.LocalBAReplay(cuda_device)
    read = registry.reader("lba_replay_share")
    before = counts()
    for call in range(3):
        if call == 2:
            monkeypatch.setattr(B, "BUCKET_CAPS",
                                (256, 256) + B.BUCKET_CAPS[2:])
        with profiler.timer("local_mapping.lba"):
            liba(window(), replay)
    after = counts()
    stats = {k: (after[k] - before[k], 0.0) for k in TIMERS}
    assert stats["local_mapping.lba"][0] == 3
    assert read(types.SimpleNamespace(stats=stats)) == pytest.approx(
        100.0 * 2 / 3)
