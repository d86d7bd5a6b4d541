"""BA entry points: snapshot the world map into a problem, solve, write back.

Port of ppg_slam_tpu/estimator/ba.py's visual and visual-inertial entry
points. Each gathers the reference's window/fixed-set selection from the
host map into a BAProblem, runs ba_core.solve_ba on `device` (CUDA unless
the caller names another) and applies the reference's post-passes (chi2
observation erasure, MapEdge re-validation, coline outlier culling).

  * local_bundle_adjustment  - OptimizerLBA.cpp:35-329 (LM l0=100, 10 its,
    Cauchy reproj sqrt(5.991), Huber coline sqrt(7.815))
  * local_inertial_ba        - OptimizerLBA.cpp:354-846 (<=50-KF temporal
    window, <=200 single fixed observers, l0=1e-2/1e0, depth-aware chi2)
  * global_bundle_adjustment - OptimizerGBA.cpp:24-289 (results to the GBA
    scratch fields when loop_kf != 0)
  * full_inertial_ba         - OptimizerGBA.cpp:291-683, interleaved with
    the reference's conformal (global-scale) line search
  * whole_map_transform_gain / conformal_scale_refine - the full-objective
    checks behind IMU initialization and scale refinement

Eager solves run at their exact sizes: the reference's slot-major layout
is an XLA/TPU workaround. Its pow2 shape buckets come back for one reason:
the local BAs of the mapping thread take a LocalBAReplay, which replays
their LM iterations on CUDA from a CUDA graph per bucket. Past 64
keyframes a solve whose pose system resolves to PCG takes solve_ba's
implicit route (IMPLICIT_MIN_KF), as the reference's accelerator route
does; the global entry points take `mesh=` (a parallel.Mesh) and then
solve through parallel.solve_ba_sharded, the residual set sharded over its
devices.

The local and global BA entry points pass `pose_cg_iters` and `backtrack`
through to BAOptions; None keeps the reference's backend defaults (PCG(64)
and backtracking on CUDA, Cholesky without backtracking on the CPU).
"""

from __future__ import annotations

import collections
import dataclasses
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import StaticBuffers, resolve_device
from ..utils import profiler
from ..worldmap.elements import MapPoint
from ..worldmap.frame import KeyFrame, Rig
from ..worldmap.map import Map
from .ba_core import (
    _INDEX_FIELDS,
    MAX_HIST,
    BAOptions,
    BAProblem,
    KFStates,
    _chi2_only,
    _exit_test,
    _finish,
    _lm_iteration,
    _lm_loop,
    _obs_residuals,
    empty_problem,
    resolve_pose_cg,
    solve_ba,
)

CHI2_MONO = 5.991

# The fewest keyframes that take solve_ba's implicit route. The reference
# pads the keyframe count of an accelerator solve to a power of two with a
# floor of 16 (ba.py _bucket_nm, _kf_mp_floors) and goes implicit from the
# 128 bucket (_implicit_min_n), i.e. from 65 keyframes, when the pose
# solve is PCG (ba.py:250-262).
IMPLICIT_MIN_KF = 65


def _sqrt_info_psd(M: np.ndarray) -> np.ndarray:
    """PSD-projected inverse square root used for whitening (the reference
    PSD-projects Info = C^-1, G2oEdge.cpp EdgeInertial ctor)."""
    M = 0.5 * (M + M.T).astype(np.float64)
    info = np.linalg.inv(M + 1e-14 * np.eye(len(M)))
    w, V = np.linalg.eigh(0.5 * (info + info.T))
    w = np.clip(w, 0.0, None)
    return ((V * np.sqrt(w)) @ V.T).astype(np.float32)


def _upload(arrays, device) -> list:
    """numpy arrays -> tensors on `device`, f32 data in one transfer."""
    # (ascontiguousarray makes a 0-d array 1-d; the reshape restores it)
    out = [torch.from_numpy(np.ascontiguousarray(a).reshape(np.shape(a)))
           for a in arrays]
    floats = [k for k, a in enumerate(out) if a.dtype == torch.float32]
    if floats and torch.device(device).type != "cpu":
        flat = torch.cat([out[k].reshape(-1) for k in floats]).to(device)
        for k, part in zip(floats, torch.split(
                flat, [out[k].numel() for k in floats])):
            out[k] = part.view(out[k].shape)
    return [a.to(device) for a in out]


def _fetch(*tensors) -> list:
    """Device tensors -> numpy arrays in one transfer (one host sync)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(tuple(t.shape)))
        k += t.numel()
    return out


def _padded_solve(states: KFStates, points, prob: BAProblem, kf_dof,
                  mp_free, rig: Rig, opts: BAOptions, device,
                  abort_check=None, chunk: int = 2, mesh=None, replay=None):
    """solve_ba on `device` from host (numpy) states, points and problem.
    The pose system is solved implicitly from IMPLICIT_MIN_KF keyframes on
    where it resolves to PCG; with `mesh` the solve is solve_ba_sharded's
    (its lead device is `device`). With `replay` (a LocalBAReplay, which
    the local BAs take), a solve that fits it is replayed from its CUDA
    graphs instead, padded to its bucket; the states and points returned
    are then views of the replay's buffers, valid until its next solve.

    abort_check: polled between fixed-size chunks of the damped-GN loop,
    the reference's force-stop flag inside g2o (OptimizerLBA.cpp:112-113);
    each chunk resumes the previous one's damping."""
    implicit = (len(kf_dof) >= IMPLICIT_MIN_KF
                and resolve_pose_cg(opts.pose_cg_iters, device) > 0)
    key = None if replay is None else replay.key(
        len(kf_dof), len(points), prob, rig, opts, implicit, device)
    if key is not None:
        with profiler.timer("local_ba.replay"), torch.cuda.device(device):
            graph = replay.load(key, states, points, prob, kf_dof, mp_free,
                                rig)
            return _chunked(lambda s, p, o: graph.run(o), None, None, opts,
                            abort_check, chunk)
    host = list(states) + [points, np.asarray(kf_dof), np.asarray(mp_free),
                           rig.Rcb, rig.tcb] + list(prob)
    dev = _upload(host, device)
    st = KFStates(*dev[:5])
    pts, dof, free, Rcb, tcb = dev[5:10]
    prob_d = BAProblem(*dev[10:])

    def _solve(s, p, o):
        if mesh is not None:
            from ..parallel.sharded_ba import solve_ba_sharded

            return solve_ba_sharded(s, p, prob_d, dof, free, Rcb, tcb,
                                    rig.cam, o, mesh, implicit=implicit)
        return solve_ba(s, p, prob_d, dof, free, Rcb, tcb, rig.cam, o,
                        implicit=implicit)

    return _chunked(_solve, st, pts, opts, abort_check, chunk)


def _chunked(solve, st, pts, opts: BAOptions, abort_check, chunk: int):
    """solve(st, pts, opts) at once, or where abort_check is given, in
    chunks of `chunk` iterations, each resuming the previous one's damping
    and states, abort_check polled between them."""
    if abort_check is None or opts.iters <= chunk:
        with profiler.timer("ba.dispatch"):
            return solve(st, pts, opts)
    done = 0
    lam = opts.lambda0
    info = None
    initial = None
    prev_chi2 = np.inf
    stalled_chunks = 0
    syncs = 0
    while done < opts.iters:
        st, pts, info = solve(st, pts, dataclasses.replace(
            opts, iters=chunk, lambda0=lam))
        lam = info["lam"]
        if initial is None:
            initial = info["chi2_hist"][0]
        # the inner loop can exit before `chunk` iterations when tol > 0
        done += info["iters_run"]
        syncs += info["host_syncs"] + 1
        chi2 = float(info["final_chi2"])
        if chi2 < prev_chi2 and chi2 > (1.0 - opts.tol) * prev_chi2:
            break  # converged: accepted progress with small gain
        # a chunk with no accepted step is lambda search; allow 8 of them
        # (16 rejected iterations, the solver's own rejection cap)
        stalled_chunks = stalled_chunks + 1 if chi2 >= prev_chi2 else 0
        if stalled_chunks >= 8:
            break
        prev_chi2 = min(chi2, prev_chi2)
        if done < opts.iters and abort_check():
            info["aborted"] = True
            break
    info["iters_run"] = done
    info["host_syncs"] = syncs
    info["chi2_hist"] = info["chi2_hist"].clone()
    info["chi2_hist"][0] = initial
    return st, pts, info


# ---------------------------------------------------------------------------
# local BA replayed from CUDA graphs (the mapping path)
# ---------------------------------------------------------------------------

# The reference pads every accelerator solve to power-of-two buckets
# (ppg_slam_tpu/estimator/ba.py _bucket_nm, _kf_mp_floors, _obs_floor,
# _pad_problem), with these floors: keyframes, map points, then the rows of
# each residual family (observations, colines, inertial links, 15-D priors,
# bias priors). A graph holds fixed shapes, so a LocalBAReplay pads to them.
BUCKET_FLOORS = (16, 512, 4096, 256, 64, 1, 4)
# the largest bucket a LocalBAReplay captures; a larger solve runs eagerly
BUCKET_CAPS = (256, 16384, 131072, 16384, 256, 64, 64)
# the graphs a LocalBAReplay keeps, the least recently used evicted past it
MAX_GRAPHS = 8
# the bucket (an index into the sizes) of each BAProblem field, by prefix
_FAMILY = {"r": 2, "c": 3, "i": 4, "rw": 4, "p": 5, "bp": 6}


def _pow2(n: int, lo: int) -> int:
    return max(lo, 1 << (n - 1).bit_length())


def bucket_sizes(n_kf: int, n_mp: int, prob: BAProblem) -> tuple:
    """(keyframes, map points, observations, colines, links, priors, bias
    priors) of a solve, each a power of two at or above its BUCKET_FLOORS
    entry; an empty residual family stays empty."""
    sizes = (n_kf, n_mp, len(prob.r_kf), len(prob.c_idx), len(prob.i_kf1),
             len(prob.p_kf), len(prob.bp_kf))
    return tuple(_pow2(k, lo) if k else 0
                 for k, lo in zip(sizes, BUCKET_FLOORS))


def pad_inputs(states: KFStates, points, prob: BAProblem, kf_dof, mp_free,
               sizes: tuple, out=None) -> list:
    """The host (numpy) inputs of a solve padded to `sizes`
    (bucket_sizes), the reference's padding: a padded keyframe is an
    identity state with no free DOF, a padded map point sits fixed at
    (0, 0, 1), and a padded residual row is ba_core.empty_problem's, not
    valid (so no observation sees a padded point). Returns [R, t, v, bg,
    ba, points, kf_dof, mp_free, *prob], written into `out` (arrays of
    those shapes) where given."""
    N, M = sizes[:2]
    pad_row = [np.asarray(x[0]) for x in empty_problem(1, 1, 1, 1, 1)]
    src = [*states, points, kf_dof, mp_free, *prob]
    fills = [np.eye(3), 0.0, 0.0, 0.0, 0.0, (0.0, 0.0, 1.0), False,
             False] + pad_row
    rows = [N] * 5 + [M, N, M] + [sizes[_FAMILY[f.split("_")[0]]]
                                  for f in BAProblem._fields]
    if out is None:
        out = [np.empty((r,) + np.shape(a)[1:], np.asarray(a).dtype)
               for r, a in zip(rows, src)]
    for dst, a, fill in zip(out, src, fills):
        k = len(a)
        dst[:k] = a
        dst[k:] = fill
    return out


class _IterationGraph:
    """One bucket of a LocalBAReplay: the padded inputs as static device
    buffers, the LM loop's state (damping, last chi2, chi2 history and its
    slot) on the device, and the CUDA graph of one iteration of solve_ba
    (_lm_iteration with sync_free) that updates them in place."""

    def __init__(self, key, device):
        self.sizes, self.implicit, self.cam, self.opts = key
        N, M = self.sizes[:2]
        tmpl = empty_problem()
        specs = ([((N, 3, 3), torch.float32)] + [((N, 3), torch.float32)] * 4
                 + [((M, 3), torch.float32), ((N, 15), torch.bool),
                    ((M,), torch.bool)]
                 + [((self.sizes[_FAMILY[f.split("_")[0]]],) + x.shape[1:],
                     x.dtype) for f, x in zip(BAProblem._fields, tmpl)]
                 + [((3, 3), torch.float32), ((3,), torch.float32)])
        self.buf = StaticBuffers(specs, device)
        d = self.buf.dev
        self.states, self.points = KFStates(*d[:5]), d[5]
        self.kf_dof, self.mp_free = d[6], d[7]
        self.prob = BAProblem(*d[8:-2])
        self.Rcb, self.tcb = d[-2:]
        f32 = dict(dtype=torch.float32, device=device)
        self.lam = torch.zeros((), **f32)
        self.last = torch.zeros((), **f32)
        self.hist = torch.zeros(MAX_HIST, **f32)
        self.slot = torch.zeros(1, dtype=torch.int64, device=device)
        self.graph = self.flags = None

    def fill(self, states, points, prob, kf_dof, mp_free, rig) -> None:
        """Pad a solve's host inputs into the buffers and upload them."""
        self.n_kf, self.n_mp, self.n_obs = (len(kf_dof), len(points),
                                            len(prob.r_kf))
        h = self.buf.host
        pad_inputs(states, points, prob, kf_dof, mp_free, self.sizes,
                   out=h[:-2])
        h[-2][...] = rig.Rcb
        h[-1][...] = rig.tcb
        # the solve's host reads come after this copy on the same stream,
        # so the next fill of the pinned arrays finds it done
        self.buf.upload()

    def iteration(self, commit: bool):
        """One LM iteration on the buffers: its exit-test flags; with
        commit, the iteration's states, points, damping and chi2 written
        back into the buffers and its chi2 into the history."""
        solve_iter, _ = _lm_iteration(
            self.states, self.points, self.prob, self.kf_dof, self.mp_free,
            self.Rcb, self.tcb, self.cam, self.opts, self.implicit, None,
            [0], sync_free=True)
        st, pts, lam, chi2_acc, chi2_pre = solve_iter(self.states,
                                                      self.points, self.lam)
        flags = _exit_test(chi2_acc, self.last, self.opts.tol)
        if commit:
            self.hist.index_copy_(0, self.slot, chi2_pre[None])
            self.slot.add_(1).clamp_(max=MAX_HIST - 1)
            for dst, src in zip((*self.states, self.points, self.lam,
                                 self.last), (*st, pts, lam, chi2_acc)):
                dst.copy_(src)
        return flags

    def run(self, opts: BAOptions):
        """solve_ba's loop from the states in the buffers, its damping
        opts.lambda0 (a float or a device scalar), one replay and one host
        read an iteration: (states, points, info) as solve_ba returns them,
        the states and points views of the buffers at the true sizes."""
        profiler.count_device("solve_ba", self.points)
        if self.implicit:
            profiler.count_device("solve_ba_implicit", self.points)
        if torch.is_tensor(opts.lambda0):
            self.lam.copy_(opts.lambda0)
        else:
            self.lam.fill_(opts.lambda0)
        self.last.fill_(torch.inf)
        self.slot.zero_()

        def step(it):
            self.graph.replay()
            return self.flags.tolist()

        it, accepts = _lm_loop(step, opts)
        st = KFStates(*(x[:self.n_kf] for x in self.states))
        pts = self.points[:self.n_mp]
        k = self.n_obs
        obs = _obs_residuals(
            st, pts, self.prob._replace(r_kf=self.prob.r_kf[:k],
                                        r_mp=self.prob.r_mp[:k],
                                        r_uv=self.prob.r_uv[:k]),
            self.cam, self.Rcb, self.tcb)
        return st, pts, _finish(it, accepts, self.hist, self.last.clone(),
                                self.lam.clone(), *obs, it)


class LocalBAReplay:
    """The LM iterations of the local BAs on a CUDA device replayed from
    CUDA graphs, one replay an iteration: an eager iteration issues ~2.2k
    small launches at ~25 us of host issue each, a replayed one a single
    graph launch.

    A solve is padded to its bucket (bucket_sizes, pad_inputs) and filled
    into that bucket's static buffers by one host-to-device copy a dtype.
    One graph per key (the bucket sizes, the route dense or implicit, the
    camera, the solver options but iters and lambda0), captured at its
    first solve into the instance's own memory pool on its own stream, in
    thread-local capture mode (the threaded GBA and the prefetcher launch
    eagerly from other threads meanwhile); at most MAX_GRAPHS kept, the
    least recently used evicted. The iteration is solve_ba's with
    sync_free (the same values), and the host loop around the replays is
    solve_ba's: one read of the exit test an iteration. A solve past
    BUCKET_CAPS does not fit (key() is None): the caller solves eagerly."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(self.device)
        self._graphs = collections.OrderedDict()  # key -> _IterationGraph
        self._warm = False

    def key(self, n_kf: int, n_mp: int, prob: BAProblem, rig: Rig,
            opts: BAOptions, implicit: bool, device):
        """The graph key of a solve on `device`, or None where it does not
        fit: another device, or a bucket past BUCKET_CAPS."""
        sizes = bucket_sizes(n_kf, n_mp, prob)
        if torch.device(device) != self.device or any(
                k > cap for k, cap in zip(sizes, BUCKET_CAPS)):
            return None
        return (sizes, bool(implicit), rig.cam,
                dataclasses.replace(opts, iters=0, lambda0=0.0))

    def load(self, key, states, points, prob, kf_dof, mp_free,
             rig) -> _IterationGraph:
        """The key's graph with the solve's inputs in its buffers, captured
        at its first use."""
        graph = self._graphs.pop(key, None)
        if graph is None:
            graph = _IterationGraph(key, self.device)
        self._graphs[key] = graph
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        graph.fill(states, points, prob, kf_dof, mp_free, rig)
        if graph.graph is None:
            self._capture(graph)
        return graph

    def _capture(self, graph: _IterationGraph) -> None:
        with profiler.timer("local_ba.capture"):
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            cuda_graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                if not self._warm:
                    # warm up on the capture stream once: cuBLAS creates
                    # its handle and workspace for a stream lazily
                    graph.iteration(commit=False)
                # capture_begin/end, not the torch.cuda.graph context: that
                # also synchronizes the device, collects garbage and
                # empties the allocator's cache (~0.1 s a capture in a
                # running System)
                cuda_graph.capture_begin(pool=self._pool,
                                         capture_error_mode="thread_local")
                try:
                    graph.flags = graph.iteration(commit=True)
                finally:
                    cuda_graph.capture_end()
            current.wait_stream(self._stream)
            graph.graph = cuda_graph
            self._warm = True


def _body_states(kfs: List[KeyFrame], rig: Rig) -> KFStates:
    """numpy body states [Rwb, twb, v, bg, ba] of the keyframes."""
    R = np.stack([kf.imu_rotation() for kf in kfs])
    t = np.stack([kf.imu_position() for kf in kfs])
    v = np.stack([kf.velocity for kf in kfs])
    bg = np.stack([kf.bias[:3] for kf in kfs])
    ba = np.stack([kf.bias[3:] for kf in kfs])
    return KFStates(R.astype(np.float32), t.astype(np.float32),
                    v.astype(np.float32), bg.astype(np.float32),
                    ba.astype(np.float32))


def _write_back_poses(kfs: List[KeyFrame], states: KFStates, rig: Rig,
                      free: np.ndarray, velocities: bool) -> None:
    R, t, v, bg, ba = (np.asarray(x) for x in states)
    for i, kf in enumerate(kfs):
        if not free[i]:
            continue
        Rbw = R[i].T
        tbw = -Rbw @ t[i]
        kf.set_pose(rig.Rcb @ Rbw, rig.Rcb @ tbw + rig.tcb)
        if velocities:
            kf.velocity = v[i].copy()
            kf.bias = np.concatenate([bg[i], ba[i]]).astype(np.float32)


def _gather_reproj(kfs: List[KeyFrame], kf_index: Dict[int, int],
                   mps: List[MapPoint], mp_index: Dict[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Observation triplets (kf_slot, mp_slot, uv) over the local window."""
    r_kf, r_mp, r_uv, refs = [], [], [], []
    for mp in mps:
        j = mp_index[mp.mnId]
        for kf, idx in mp.observations.items():
            i = kf_index.get(kf.mnId)
            if i is None or kf.is_bad():
                continue
            r_kf.append(i)
            r_mp.append(j)
            r_uv.append(kf.kp[idx])
            refs.append((kf, mp, idx))
    if not r_kf:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, 2), np.float32), [])
    return (np.asarray(r_kf, np.int64), np.asarray(r_mp, np.int64),
            np.asarray(r_uv, np.float32), refs)


def _gather_colines(wmap: Map, mp_index: Dict[int, int]
                    ) -> Tuple[np.ndarray, np.ndarray, list]:
    idx, w, refs = [], [], []
    for mc in wmap.map_colines:
        if mc.is_bad() or not mc.valid:
            continue
        a = mp_index.get(mc.mp_s.mnId)
        b = mp_index.get(mc.mp_m.mnId)
        c = mp_index.get(mc.mp_e.mnId)
        if a is None or b is None or c is None:
            continue
        idx.append((a, b, c))
        w.append(mc.ave_weight())
        refs.append(mc)
    if not idx:
        return np.zeros((0, 3), np.int64), np.zeros(0, np.float32), []
    return np.asarray(idx, np.int64), np.asarray(w, np.float32), refs


def _np_problem_template(O: int, C: int, L: int, P: int, B: int) -> dict:
    """numpy mirror of ba_core.empty_problem for the host assemblers."""
    return {k: v.numpy() for k, v in
            empty_problem(O, C, L, P, B)._asdict().items()}


def _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w, links=None,
                 bias_priors=None) -> BAProblem:
    """A numpy BAProblem holding exactly the given residual families (every
    row valid). The name is the reference's; nothing is padded here."""
    n_links = len(links[0]) if links else 0
    n_bp = len(bias_priors[0]) if bias_priors else 0
    p = _np_problem_template(len(r_kf), len(c_idx), n_links, 0, n_bp)
    p.update(r_kf=np.asarray(r_kf, np.int64), r_mp=np.asarray(r_mp, np.int64),
             r_uv=np.asarray(r_uv, np.float32),
             c_idx=np.asarray(c_idx, np.int64).reshape(-1, 3),
             c_w=np.asarray(c_w, np.float32))
    p["r_valid"][:] = True
    p["c_valid"][:] = True
    if links:
        names = ("i_kf1", "i_kf2", "i_dR", "i_dV", "i_dP", "i_JRg", "i_JVg",
                 "i_JVa", "i_JPg", "i_JPa", "i_b0", "i_sqi", "i_dt",
                 "i_huber", "rw_sqig", "rw_sqia")
        for name, vals in zip(names, links):
            p[name] = np.asarray(vals, p[name].dtype)
        p["i_valid"][:] = True
        p["rw_valid"][:] = True
    if bias_priors:
        for name, vals in zip(("bp_kf", "bp_wg", "bp_wa"), bias_priors):
            p[name] = np.asarray(vals, p[name].dtype)
        p["bp_valid"][:] = True
    return BAProblem(**p)


def _gather_links(kfs: List[KeyFrame], kf_index: Dict[int, int],
                  soft_prev_ids: Optional[set] = None,
                  info_scale_soft: float = 1e-2):
    """Temporal preintegration links within the window (consecutive KFs).

    Links whose previous KF is in `soft_prev_ids` (the boundary link into the
    fixed past) get information x 1e-2 + Huber(sqrt 16.92), matching
    OptimizerLBA.cpp:583-589."""
    cols = [[] for _ in range(16)]
    for kf in kfs:
        prev = kf.prev_kf
        if prev is None or kf.preintegrated is None:
            continue
        i = kf_index.get(prev.mnId)
        j = kf_index.get(kf.mnId)
        if i is None or j is None:
            continue
        p = kf.preintegrated
        st = p.state
        C = np.asarray(st.C, np.float64)
        sqi = _sqrt_info_psd(C[:9, :9])
        is_last = soft_prev_ids is not None and prev.mnId in soft_prev_ids
        if is_last:
            sqi = sqi * np.sqrt(info_scale_soft)
        vals = [i, j, np.asarray(st.dR), np.asarray(st.dV), np.asarray(st.dP),
                np.asarray(st.JRg), np.asarray(st.JVg), np.asarray(st.JVa),
                np.asarray(st.JPg), np.asarray(st.JPa), p.b.copy(), sqi,
                np.float32(st.dT), bool(is_last),
                _sqrt_info_psd(C[9:12, 9:12]),
                _sqrt_info_psd(C[12:15, 12:15])]
        for c, v in zip(cols, vals):
            c.append(v)
    if not cols[0]:
        return None
    return [np.asarray(c) for c in cols]


def _apply_outlier_pass(chi2: np.ndarray, depth: np.ndarray, refs,
                        close_flags: Optional[np.ndarray] = None) -> int:
    """Erase observations with chi2 > 5.991 (x 1.5 where close_flags) or
    non-positive depth (the LBA post-pass, OptimizerLBA.cpp:259-, :743-750).
    chi2/depth are per observation, in `refs` order."""
    n_bad = 0
    for k, (kf, mp, idx) in enumerate(refs):
        th = CHI2_MONO
        if close_flags is not None and close_flags[k]:
            th = 1.5 * CHI2_MONO
        if chi2[k] > th or depth[k] <= 0:
            mp.erase_observation(kf)
            n_bad += 1
    return n_bad


def _coline_edge_cleanup(wmap: Map, mps: List[MapPoint]) -> None:
    """Post-BA edge/coline validity sweep (OptimizerLBA.cpp:306-326)."""
    seen = set()
    for mp in mps:
        if mp.is_bad():
            continue
        for me in mp.get_edges():
            if me.mnId not in seen:
                seen.add(me.mnId)
                me.check_valid()
        mp.remove_coline_outliers()


def _summary(info: dict, chi2, n_kf: int, n_mp: int, n_obs: int,
             n_erased: int = 0) -> dict:
    """What an entry point returns: the solve's initial and final chi2
    (`chi2`: the fetched [initial, final] pair), iterations and host syncs
    (the solve's own and the one result fetch), and the problem's size."""
    return dict(initial_chi2=float(chi2[0]), final_chi2=float(chi2[1]),
                iters_run=int(info["iters_run"]),
                host_syncs=int(info["host_syncs"]) + 1, n_kf=n_kf, n_mp=n_mp,
                n_obs=n_obs, n_erased=n_erased)


def _chi2_pair(info: dict) -> torch.Tensor:
    """[initial, final] chi2 of a solve, on its device."""
    return torch.stack([info["chi2_hist"][0], info["final_chi2"]])


def _write_back_points(mps: List[MapPoint], pts: np.ndarray) -> None:
    for j, mp in enumerate(mps):
        if not mp.is_bad():
            mp.pos = pts[j].copy()
            mp.update_normal_and_depth()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def local_bundle_adjustment(kf: KeyFrame, wmap: Map, iters: int = 10,
                            abort_check=None, map_lock=None, device=None,
                            pose_cg_iters=None, backtrack=None,
                            replay=None) -> Optional[dict]:
    """Visual local BA (OptimizerLBA.cpp:35-329). abort_check: polled
    between GN chunks (the reference's force-stop flag, :112-113).
    map_lock: held around the host gather and apply phases only, so the
    device solve of a threaded local mapper overlaps tracking. If the map's
    transform_epoch moves mid-solve (IMU init / loop correction rescaled the
    world) the write-back is dropped entirely. replay: a LocalBAReplay on
    `device` (the local mapper's), which replays the solve where it fits
    (_padded_solve). Returns the solve's summary (_summary), or None where
    there was nothing to solve or the write-back was dropped."""
    device = resolve_device(device)
    guard = map_lock if map_lock is not None else nullcontext()
    rig = wmap.rig
    with guard, profiler.timer("lba.gather"):
        epoch0 = wmap.transform_epoch
        local = [kf] + [k for k in kf.ordered_connected if not k.is_bad()]
        local_ids = {k.mnId for k in local}
        mps: List[MapPoint] = []
        seen = set()
        for k in local:
            for mp in k.map_points:
                if mp is not None and not mp.is_bad() and mp.mnId not in seen:
                    seen.add(mp.mnId)
                    mps.append(mp)
        fixed: List[KeyFrame] = []
        fixed_ids = set()
        for mp in mps:
            for k in mp.observations:
                if k.mnId not in local_ids and k.mnId not in fixed_ids \
                        and not k.is_bad():
                    fixed_ids.add(k.mnId)
                    fixed.append(k)
        kfs = local + fixed
        if len(kfs) < 2 or not mps:
            return None
        kf_index = {k.mnId: i for i, k in enumerate(kfs)}
        mp_index = {mp.mnId: j for j, mp in enumerate(mps)}
        states = _body_states(kfs, rig)
        points = np.stack([mp.pos for mp in mps]).astype(np.float32)
        r_kf, r_mp, r_uv, refs = _gather_reproj(kfs, kf_index, mps, mp_index)
        c_idx, c_w, _ = _gather_colines(wmap, mp_index)
        prob = _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w)
        kf_dof = np.zeros((len(kfs), 15), bool)
        kf_dof[: len(local), :6] = True
        # the origin KF stays fixed
        for i, k in enumerate(local):
            if wmap.kf_origin is not None and k.mnId == wmap.kf_origin.mnId:
                kf_dof[i] = False

    opts = BAOptions(iters=iters, lambda0=100.0, reproj_kernel="cauchy",
                     pose_cg_iters=pose_cg_iters, backtrack=backtrack)
    with profiler.timer("lba.solve"):
        st, pts, info = _padded_solve(states, points, prob, kf_dof,
                                      np.ones(len(mps), bool), rig, opts,
                                      device, abort_check=abort_check,
                                      replay=replay)
    with profiler.timer("lba.apply"):
        # one transfer for everything the host post-pass reads, fetched
        # outside the map lock: it is the long device wait
        *st_np, pts_np, chi2, depth, chi2s = _fetch(
            *st, pts, info["obs_chi2"], info["obs_depth"], _chi2_pair(info))
        with (map_lock if map_lock is not None else nullcontext()):
            if wmap.transform_epoch != epoch0:
                profiler.count("lba_dropped_stale")
                return None
            n_bad = _apply_outlier_pass(chi2, depth, refs)
            _write_back_poses(kfs, KFStates(*st_np), rig, kf_dof.any(axis=1),
                              velocities=False)
            _write_back_points(mps, pts_np)
            _coline_edge_cleanup(wmap, mps)
            wmap.info_map_change()
    return _summary(info, chi2s, len(kfs), len(mps), len(refs), n_bad)


def local_inertial_ba(kf: KeyFrame, wmap: Map, b_large: bool = False,
                      b_rec_init: bool = False, iters: int = 10,
                      abort_check=None, map_lock=None, device=None,
                      pose_cg_iters=None, backtrack=None,
                      replay=None) -> Optional[dict]:
    """Visual-inertial local BA (OptimizerLBA.cpp:354-846). map_lock: see
    local_bundle_adjustment - gather/apply locked, device solve unlocked,
    write-back dropped on a mid-solve whole-map transform; replay as
    there. Returns as local_bundle_adjustment does."""
    device = resolve_device(device)
    guard = map_lock if map_lock is not None else nullcontext()
    rig = wmap.rig
    with guard, profiler.timer("liba.gather"):
        epoch0 = wmap.transform_epoch
        max_opt = 50
        nd = min(wmap.n_keyframes() - 2, max_opt)
        window: List[KeyFrame] = [kf]
        while len(window) < nd and window[-1].prev_kf is not None:
            window.append(window[-1].prev_kf)
        local_ids = {k.mnId for k in window}

        mps: List[MapPoint] = []
        seen = set()
        for k in window:
            for mp in k.map_points:
                if mp is not None and not mp.is_bad() \
                        and mp.mnId not in seen:
                    seen.add(mp.mnId)
                    mps.append(mp)

        fixed: List[KeyFrame] = []
        fixed_ids = set()
        if window[-1].prev_kf is not None:
            fixed.append(window[-1].prev_kf)
            fixed_ids.add(window[-1].prev_kf.mnId)
        else:
            # no previous: fix the oldest window KF itself
            oldest = window.pop()
            local_ids.discard(oldest.mnId)
            fixed.append(oldest)
            fixed_ids.add(oldest.mnId)
        for mp in mps:  # ONE fixed observer per point (reference quirk)
            if len(fixed) >= 200:
                break
            for k in mp.observations:
                if k.mnId not in local_ids and k.mnId not in fixed_ids \
                        and not k.is_bad():
                    fixed_ids.add(k.mnId)
                    fixed.append(k)
                    break
        kfs = window + fixed
        if not mps or len(kfs) < 2:
            return None
        kf_index = {k.mnId: i for i, k in enumerate(kfs)}
        mp_index = {mp.mnId: j for j, mp in enumerate(mps)}

        states = _body_states(kfs, rig)
        points = np.stack([mp.pos for mp in mps]).astype(np.float32)
        r_kf, r_mp, r_uv, refs = _gather_reproj(kfs, kf_index, mps, mp_index)
        c_idx, c_w, _ = _gather_colines(wmap, mp_index)
        # temporal links over window + the link into the fixed previous KF
        soft = {fixed[0].mnId} if fixed else set()
        links = _gather_links(window, kf_index, soft_prev_ids=soft)
        prob = _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w, links=links)
        kf_dof = np.zeros((len(kfs), 15), bool)
        kf_dof[: len(window), :] = True

    opts = BAOptions(iters=iters, lambda0=(1e-2 if b_large else 1e0),
                     reproj_kernel="cauchy", pose_cg_iters=pose_cg_iters,
                     backtrack=backtrack)
    with profiler.timer("liba.solve"):
        st, pts, info = _padded_solve(states, points, prob, kf_dof,
                                      np.ones(len(mps), bool), rig, opts,
                                      device, abort_check=abort_check,
                                      replay=replay)
    with profiler.timer("liba.apply"):
        *st_np, pts_np, chi2, depth, chi2s = _fetch(
            *st, pts, info["obs_chi2"], info["obs_depth"], _chi2_pair(info))
        with (map_lock if map_lock is not None else nullcontext()):
            if wmap.transform_epoch != epoch0:
                profiler.count("lba_dropped_stale")
                return None
            # depth-aware chi2 (close = tracked depth < 10, :743-750), with
            # the optimized depth as the closeness proxy
            n_bad = _apply_outlier_pass(chi2, depth, refs,
                                        close_flags=depth < 10.0)
            _write_back_poses(kfs, KFStates(*st_np), rig, kf_dof.any(axis=1),
                              velocities=True)
            _write_back_points(mps, pts_np)
            _coline_edge_cleanup(wmap, mps)
            wmap.info_map_change()
    return _summary(info, chi2s, len(kfs), len(mps), len(refs), n_bad)


def global_bundle_adjustment(wmap: Map, iters: int = 20, loop_kf: int = 0,
                             robust: bool = True, abort_check=None,
                             map_lock=None, device=None, pose_cg_iters=None,
                             backtrack=None, mesh=None) -> Optional[dict]:
    """Visual-only GBA (OptimizerGBA.cpp:24-289). map_lock (if given) guards
    the host gather/write phases so a background-thread GBA (the reference's
    RunGlobalBundleAdjustment thread, LoopClosing.cpp:1050) does not race
    tracking; the device solve runs unlocked. mesh (a parallel.Mesh, if
    given) shards the solve's residual set over its devices; the solve then
    runs on the mesh's lead device, whatever `device` says. Returns the
    solve's summary (_summary; GBA erases no observation), or None where
    there was nothing to solve."""
    device = mesh.lead if mesh is not None else resolve_device(device)
    guard = map_lock if map_lock is not None else nullcontext()
    rig = wmap.rig
    with guard:
        kfs = wmap.all_keyframes()
        mps = wmap.all_map_points()
        if len(kfs) < 2 or not mps:
            return None
        kfs.sort(key=lambda k: k.mnId)
        kf_index = {k.mnId: i for i, k in enumerate(kfs)}
        mp_index = {mp.mnId: j for j, mp in enumerate(mps)}
        states = _body_states(kfs, rig)
        points = np.stack([mp.pos for mp in mps]).astype(np.float32)
        r_kf, r_mp, r_uv, _ = _gather_reproj(kfs, kf_index, mps, mp_index)
        c_idx, c_w, _ = _gather_colines(wmap, mp_index)
        prob = _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w)

    kf_dof = np.zeros((len(kfs), 15), bool)
    kf_dof[:, :6] = True
    kf_dof[0] = False  # origin fixed
    opts = BAOptions(iters=iters, lambda0=1e-5,
                     reproj_kernel="cauchy" if robust else "none",
                     pose_cg_iters=pose_cg_iters, backtrack=backtrack)
    st, pts, info = _padded_solve(states, points, prob, kf_dof,
                                  np.ones(len(mps), bool), rig, opts, device,
                                  abort_check=abort_check, mesh=mesh)
    R, t, v, bg, ba, pts_np, chi2s = _fetch(*st, pts, _chi2_pair(info))
    with guard:
        if loop_kf == 0:
            _write_back_poses(kfs, KFStates(R, t, v, bg, ba), rig,
                              np.ones(len(kfs), bool), velocities=False)
            for j, mp in enumerate(mps):
                mp.pos = pts_np[j].copy()
                mp.update_normal_and_depth()
            _coline_edge_cleanup(wmap, mps)
        else:
            for i, kf in enumerate(kfs):
                Rbw = R[i].T
                tbw = -Rbw @ t[i]
                kf.gba_Rcw = rig.Rcb @ Rbw
                kf.gba_tcw = rig.Rcb @ tbw + rig.tcb
                kf.ba_global_for_kf = loop_kf
            for j, mp in enumerate(mps):
                mp.gba_pos = pts_np[j].copy()
                mp.ba_global_for_kf = loop_kf
        wmap.info_map_change()
    return _summary(info, chi2s, len(kfs), len(mps), len(r_kf))


# ---------------------------------------------------------------------------
# the conformal (global-scale) mode: line search against the full objective
# ---------------------------------------------------------------------------

def _device_problem(prob: BAProblem, device) -> BAProblem:
    """A host (numpy) problem on `device`, its index fields int64."""
    p = BAProblem(*_upload(list(prob), device))
    return p._replace(**{k: getattr(p, k).long() for k in _INDEX_FIELDS})


def _conformal_scan(states: KFStates, points, prob: BAProblem, Rcb, tcb,
                    cam, opts: BAOptions, sigmas) -> torch.Tensor:
    """chi2 along the exact conformal (global-scale) curve: t, v and the
    landmarks scaled about the origin keyframe's position by each sigma.
    One _chi2_only a sigma, on the tensors' device; prob's index fields
    int64 (_device_problem)."""
    profiler.count_device("conformal_scan", points)
    c = states.t[0]
    out = []
    for s in sigmas:
        st = states._replace(t=c + (states.t - c) * s, v=states.v * s)
        out.append(_chi2_only(st, c + (points - c) * s, prob, cam, Rcb, tcb,
                              opts))
    return torch.stack(out)


def _conformal_best_scale(st: KFStates, pts, prob: BAProblem, rig: Rig,
                          opts: BAOptions, syncs: list) -> float:
    """Global-scale line search against the FULL objective (the reference's
    ba.py:894-943): the Schur fold's coline diagonal makes the reduced
    system look far stiffer along the vision-invariant conformal mode than
    it is, so the damped GN cannot anneal a wrong monocular scale. Three
    bracketed 13-point grid passes (one host read each, counted in
    `syncs`) find the optimum; returns it, or 1.0 for no improvement."""
    dev = pts.device
    Rcb = torch.as_tensor(rig.Rcb, device=dev)
    tcb = torch.as_tensor(rig.tcb, device=dev)

    def scan(sigmas):
        chis = _conformal_scan(
            st, pts, prob, Rcb, tcb, rig.cam, opts,
            torch.as_tensor(np.asarray(sigmas, np.float32), device=dev))
        syncs[0] += 1
        chis = chis.cpu().numpy()
        # extreme sigmas can overflow chi2 to inf/NaN in f32; np.argmin
        # returns the FIRST NaN index, which would steer the search into
        # garbage: non-finite counts as +inf
        return np.where(np.isfinite(chis), chis, np.inf)

    G = 13
    sig1 = np.exp(np.linspace(np.log(0.25), np.log(4.0), G))
    chis = scan(sig1)
    k = int(np.argmin(chis))
    lo, hi = sig1[max(k - 1, 0)], sig1[min(k + 1, len(sig1) - 1)]
    sig2 = np.exp(np.linspace(np.log(lo), np.log(hi), G))
    chis2 = scan(sig2)
    k2 = int(np.argmin(chis2))
    lo2 = sig2[max(k2 - 1, 0)]
    hi2 = sig2[min(k2 + 1, len(sig2) - 1)]
    sig3 = np.concatenate([[1.0], np.exp(np.linspace(
        np.log(lo2), np.log(hi2), G - 1))])
    chis3 = scan(sig3)
    base = float(chis3[0])
    k3 = int(np.argmin(chis3))
    s = float(sig3[k3])
    if float(chis3[k3]) >= base * (1.0 - 1e-4) or abs(s - 1.0) < 1e-3:
        return 1.0
    return s


def _apply_conformal(st: KFStates, pts: np.ndarray, s: float):
    """Host states/landmarks scaled about the origin KF's position."""
    c = st.t[0]
    return (st._replace(t=c + (st.t - c) * s, v=st.v * s),
            c + (pts - c) * s)


def _gather_full_problem(wmap: Map):
    """The live map's FIBA residual set as host arrays (no solve):
    (states, points, prob, kfs, mps), or None when the map is too small."""
    rig = wmap.rig
    kfs = sorted(wmap.all_keyframes(), key=lambda k: k.mnId)
    mps = wmap.all_map_points()
    if len(kfs) < 3 or not mps:
        return None
    kf_index = {k.mnId: i for i, k in enumerate(kfs)}
    mp_index = {mp.mnId: j for j, mp in enumerate(mps)}
    states = _body_states(kfs, rig)
    points = np.stack([mp.pos for mp in mps]).astype(np.float32)
    r_kf, r_mp, r_uv, _ = _gather_reproj(kfs, kf_index, mps, mp_index)
    c_idx, c_w, _ = _gather_colines(wmap, mp_index)
    links = _gather_links(kfs, kf_index)
    prob = _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w, links=links)
    return states, points, prob, kfs, mps


def whole_map_transform_gain(wmap: Map, Rgw: np.ndarray, scale: float,
                             device=None):
    """The FULL visual-inertial chi2 of the current map and of a candidate
    whole-map transform (ApplyScaledRotation semantics: R' = Rgw R,
    t' = s Rgw t, v' = s Rgw v, X' = s Rgw X), without mutating the map.
    Returns (chi2_now, chi2_cand); (0.0, inf) where either is not finite;
    None when the map is too small to evaluate (callers decide)."""
    device = resolve_device(device)
    g = _gather_full_problem(wmap)
    if g is None:
        return None
    states, points, prob, _, _ = g
    rig = wmap.rig
    opts = BAOptions(reproj_kernel="huber")
    Rcb, tcb = _upload([rig.Rcb, rig.tcb], device)
    prob_d = _device_problem(prob, device)
    one = torch.ones(1, dtype=torch.float32, device=device)
    Rgw = np.asarray(Rgw, np.float32)
    s = np.float32(scale)
    st1 = KFStates(np.einsum("ij,njk->nik", Rgw, states.R),
                   s * states.t @ Rgw.T, s * states.v @ Rgw.T,
                   states.bg, states.ba)
    pts1 = s * points @ Rgw.T
    chis = []
    for st, pts in ((states, points), (st1, pts1)):
        dev = _upload(list(st) + [pts], device)
        chis.append(_conformal_scan(KFStates(*dev[:5]), dev[5], prob_d, Rcb,
                                    tcb, rig.cam, opts, one)[0])
    c0, c1 = (float(c) for c in torch.stack(chis).cpu())
    if not (np.isfinite(c0) and np.isfinite(c1)):
        return 0.0, float("inf")
    return c0, c1


def conformal_scale_refine(wmap: Map, lo: float = 0.4, hi: float = 2.5,
                           device=None) -> float:
    """Full-objective global-scale correction of a live inertial map: the
    FIBA residual set gathered (no GN solve) and its one-dimensional
    conformal mode line-searched against the TOTAL chi2. Applies a
    correction beyond 1 % and inside [lo, hi] through ApplyScaledRotation
    and returns it (1.0 = the map is left as it is)."""
    device = resolve_device(device)
    g = _gather_full_problem(wmap)
    if g is None:
        return 1.0
    states, points, prob, _, _ = g
    opts = BAOptions(reproj_kernel="huber")
    dev = _upload(list(states) + [points], device)
    s = _conformal_best_scale(KFStates(*dev[:5]), dev[5],
                              _device_problem(prob, device), wmap.rig, opts,
                              [0])
    # sub-percent rescalings are within the estimator's own noise, and a
    # correction outside [lo, hi] is evidence of a degenerate objective
    if abs(s - 1.0) <= 0.01 or not (lo <= s <= hi):
        return 1.0
    wmap.apply_scaled_rotation(np.eye(3, dtype=np.float32), s,
                               scale_vel=True)
    wmap.info_map_change()
    return s


def full_inertial_ba(wmap: Map, iters: int = 100, loop_kf: int = 0,
                     b_init: bool = False, prior_g: float = 1e2,
                     prior_a: float = 1e6, abort_check=None, map_lock=None,
                     conformal_shrink_cum: float = 1.0, device=None,
                     backtrack=None, mesh=None) -> Optional[dict]:
    """Visual-inertial global BA (OptimizerGBA.cpp:291-683). map_lock
    guards the host gather/write phases; mesh shards the solves' residual
    set over a parallel.Mesh, on its lead device (see
    global_bundle_adjustment); the conformal line search runs on the lead.

    b_init: one shared bias (the random-walk links made rigid). Bias priors
    prior_g/prior_a hold the last keyframe. At <= 64 KFs the solve is the
    reference's exact reduced solve (pose_cg_iters=0) for the full `iters`;
    beyond, 25 iterations at the device default (on CUDA the implicit
    PCG, IMPLICIT_MIN_KF). backtrack: None = the
    device default (on for CUDA, off on the CPU); a comparison of two
    devices names it. Each solve is followed by the conformal line search
    (up to 3 rounds) and a re-solve from the rescaled state.

    conformal_shrink_cum: cumulative DOWNWARD clamp of that annealing
    (growth is free); 1.0 = shrink-free, the first IMU init passes 0.6.
    loop_kf != 0 writes the gba_* fields instead of the map. Returns the
    solve summary (_summary, chi2 from the first solve's start to the last
    solve's end, iterations and host syncs summed, `conformal_scales` the
    applied sigmas), or None where there was nothing to solve."""
    device = mesh.lead if mesh is not None else resolve_device(device)
    guard = map_lock if map_lock is not None else nullcontext()
    rig = wmap.rig
    with guard:
        kfs = sorted(wmap.all_keyframes(), key=lambda k: k.mnId)
        mps = wmap.all_map_points()
        if len(kfs) < 2 or not mps:
            return None
        kf_index = {k.mnId: i for i, k in enumerate(kfs)}
        mp_index = {mp.mnId: j for j, mp in enumerate(mps)}
        states = _body_states(kfs, rig)
        points = np.stack([mp.pos for mp in mps]).astype(np.float32)
        r_kf, r_mp, r_uv, _ = _gather_reproj(kfs, kf_index, mps, mp_index)
        c_idx, c_w, _ = _gather_colines(wmap, mp_index)
        links = _gather_links(kfs, kf_index)
        if links is not None and b_init:
            # single shared bias: make the random-walk links rigid
            links[14] = np.broadcast_to(np.eye(3, dtype=np.float32) * 1e4,
                                        links[14].shape).copy()
            links[15] = np.broadcast_to(np.eye(3, dtype=np.float32) * 1e4,
                                        links[15].shape).copy()
        # bias priors on the LAST keyframe (OptimizerGBA.cpp:466-472)
        bias_priors = ([kf_index[kfs[-1].mnId]], [prior_g], [prior_a])
        prob = _pad_problem(r_kf, r_mp, r_uv, c_idx, c_w, links=links,
                            bias_priors=bias_priors)

    kf_dof = np.ones((len(kfs), 15), bool)
    kf_dof[0, :6] = False  # origin pose fixed; velocity/bias free
    small = len(kfs) <= 64
    opts = BAOptions(iters=iters if small else min(iters, 25), lambda0=1e-5,
                     reproj_kernel="huber",
                     pose_cg_iters=0 if small else None,
                     backtrack=backtrack)
    free = np.ones(len(mps), bool)
    with profiler.timer("fiba.solve"):
        st, pts, info = _padded_solve(states, points, prob, kf_dof, free,
                                      rig, opts, device,
                                      abort_check=abort_check, mesh=mesh)
    initial = info["chi2_hist"][0]
    iters_run, syncs = info["iters_run"], [info["host_syncs"]]
    prob_d = _device_problem(prob, device)
    # conformal-scale annealing: line-search the global-scale mode the
    # damped-GN fold cannot move, then let the solver re-polish; shrink
    # steps are clamped (>= 0.75 a step, cumulative >= conformal_shrink_cum)
    # because the attenuation bias only ever pulls the mode DOWN
    cum = 1.0
    scales = []
    for _ in range(3):
        s = _conformal_best_scale(st, pts, prob_d, rig, opts, syncs)
        if s == 1.0:
            break
        if s < 1.0:
            s = max(s, 0.75, conformal_shrink_cum / cum)
            if s >= 0.999:
                break
        cum *= s
        scales.append(s)
        *st_np, pts_np = _fetch(*st, pts)
        syncs[0] += 1
        st_np, pts_np = _apply_conformal(KFStates(*st_np), pts_np, s)
        with profiler.timer("fiba.solve"):
            st, pts, info = _padded_solve(st_np, pts_np, prob, kf_dof, free,
                                          rig, opts, device,
                                          abort_check=abort_check, mesh=mesh)
        iters_run += info["iters_run"]
        syncs[0] += info["host_syncs"]

    R, t, v, bg, ba, pts_np, chi2s = _fetch(
        *st, pts, torch.stack([initial, info["final_chi2"]]))
    with guard:
        if loop_kf == 0:
            _write_back_poses(kfs, KFStates(R, t, v, bg, ba), rig,
                              np.ones(len(kfs), bool), velocities=True)
            for j, mp in enumerate(mps):
                mp.pos = pts_np[j].copy()
                mp.update_normal_and_depth()
            _coline_edge_cleanup(wmap, mps)
        else:
            for i, kf in enumerate(kfs):
                Rbw = R[i].T
                tbw = -Rbw @ t[i]
                kf.gba_Rcw = rig.Rcb @ Rbw
                kf.gba_tcw = rig.Rcb @ tbw + rig.tcb
                kf.gba_vel = v[i].copy()
                kf.gba_bias = np.concatenate([bg[i], ba[i]]).astype(
                    np.float32)
                kf.ba_global_for_kf = loop_kf
            for j, mp in enumerate(mps):
                mp.gba_pos = pts_np[j].copy()
                mp.ba_global_for_kf = loop_kf
        wmap.info_map_change()
    out = _summary(dict(iters_run=iters_run, host_syncs=syncs[0]), chi2s,
                   len(kfs), len(mps), len(r_kf))
    out["conformal_scales"] = scales
    return out
