// The 3-probe pair gate and its two compactions, fused, for Hopper (sm_90a).
//
// Replaces the device work of ops/pairs.py probe_and_select (JAX
// counterpart: ppg_slam_tpu/ops/pairs.py:67-130 probe_and_select), which
// samples the packed line mask through the TPU kernel
// ppg_slam_tpu/ops/sampling.py _nearest_binary_packed_kernel. Given the
// packed mask of heat >= 0.2, the keypoints kp (K, 2) f32 and kp_ok (K,):
//   1. the midpoint probe of every pair (i, j), i < j, both keypoints ok:
//      bit at round_clip(kp_i * 0.5 + kp_j * 0.5);
//   2. the first PHASE2_CAP midpoint survivors in lexicographic (i, j)
//      order are probed at 20 % (kp_j * 0.2 + kp_i * 0.8) and 80 %
//      (kp_j * 0.8 + kp_i * 0.2);
//   3. the first CAND_CAP pairs passing all three probes, in that order,
//      become the candidates (ci, cj, cand_valid), with n_cand (which may
//      exceed CAND_CAP) and saturated = (midpoint survivors > PHASE2_CAP)
//      | (n_cand > CAND_CAP).
// Outputs have the plain version's dtypes and values: ci, cj int64 (0 in
// unused slots), cand_valid bool, n_cand 0-d int64, saturated 0-d bool.
//
// Design. Launch A runs one warp per 32-pair word of the (K, ceil(K/32))
// pair matrix: each lane probes one pair (the 20 %/80 % probes only where
// the midpoint passed) and two ballots write the words of two bitmasks,
// "midpoint passed" and "all three passed". Probing 20 %/80 % for every
// midpoint survivor, not just the first PHASE2_CAP, is exact: the caps only
// select. Launch B is one block of 1024 threads; each warp owns 256
// consecutive words, lane l every 32nd of them, so loads coalesce. Warp
// scans and a block scan of the warps' totals rank the midpoint survivors
// and find the PHASE2_CAP cut (inside a word, the lowest remaining bits are
// kept), a second pass ranks the kept full passes, and the words holding
// the first CAND_CAP of those go, in order, into a list in shared memory.
// Then each output slot finds its word by binary search and its pair by the
// word's n-th set bit, so the stores coalesce and the work is spread over
// the block whatever the rows the candidates come from. (Each thread
// writing its own words' candidates serially was slower, its stores
// scattered; one warp per nonzero word slower still, as the candidates
// crowd into the first rows' warps.)
// Lexicographic order is word order, then bit order. Nothing goes to the
// host; the PyTorch ops that pack the mask are the stage's only other
// device work.
//
// Bound: bytes, and at that a fraction of a microsecond: the table (45 KB at
// 752x480), K * 9 B of keypoints and ~70 KB of outputs over 3.35 TB/s is
// ~0.04 us; the f32 operations (~8 per probed pair, ~16 per survivor) are
// fewer than 67 TFLOP/s would take 0.05 us for. So two launches' latency
// (~2 us each) is the floor in practice; the design keeps the stage to those
// two launches, where the plain version issues ~50 PyTorch ops.
//
// The table's bytes go through the read-only cache (45 KB sits in L1 after
// the first warps). A persistent grid that first copied it into each block's
// shared memory was ~2 us slower at 752x480 (PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "packed_mask.cuh"

namespace {

constexpr int kPhase2Cap = 16384;
constexpr int kCandCap = 4096;
constexpr int kMaxK = 512;
constexpr int kSelectThreads = 1024;
// words a select lane owns at K = kMaxK (512 * 16 / 1024), and a warp
constexpr int kRounds = kMaxK * (kMaxK / 32) / kSelectThreads;
constexpr int kWarpWords = 32 * kRounds;
constexpr int kProbeThreads = 256;

struct ProbeArgs {
  const uint8_t* table;
  const float* kp;
  const uint8_t* ok;
  uint32_t* pass1;  // (K, wpr) words: midpoint passed
  uint32_t* full;   // (K, wpr) words: all three probes passed
  int k, wpr, n_words, h, w, w8;
};

// Launch A: one warp per word g of the pair matrix, lane l probing pair
// (i, 32 (g mod wpr) + l).
__global__ void __launch_bounds__(kProbeThreads) probe_kernel(ProbeArgs a) {
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= a.n_words) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int i = g / a.wpr;
  const int j = (g - i * a.wpr) * 32 + lane;
  unsigned mid = 0, all3 = 0;
  if (j < a.k && i < j && a.ok[i] && a.ok[j]) {
    const float xi = a.kp[2 * i], yi = a.kp[2 * i + 1];
    const float xj = a.kp[2 * j], yj = a.kp[2 * j + 1];
    const float mx = __fadd_rn(__fmul_rn(xi, 0.5f), __fmul_rn(xj, 0.5f));
    const float my = __fadd_rn(__fmul_rn(yi, 0.5f), __fmul_rn(yj, 0.5f));
    mid = ppg::packed_bit(a.table, ppg::round_clip(my, a.h - 1),
                          ppg::round_clip(mx, a.w - 1), a.h, a.w8);
    if (mid) {
      const float x02 = __fadd_rn(__fmul_rn(xj, 0.2f), __fmul_rn(xi, 0.8f));
      const float y02 = __fadd_rn(__fmul_rn(yj, 0.2f), __fmul_rn(yi, 0.8f));
      const float x08 = __fadd_rn(__fmul_rn(xj, 0.8f), __fmul_rn(xi, 0.2f));
      const float y08 = __fadd_rn(__fmul_rn(yj, 0.8f), __fmul_rn(yi, 0.2f));
      all3 = ppg::packed_bit(a.table, ppg::round_clip(y02, a.h - 1),
                             ppg::round_clip(x02, a.w - 1), a.h, a.w8) &
             ppg::packed_bit(a.table, ppg::round_clip(y08, a.h - 1),
                             ppg::round_clip(x08, a.w - 1), a.h, a.w8);
    }
  }
  const unsigned w_mid = __ballot_sync(ppg::kFullWarp, mid);
  const unsigned w_all = __ballot_sync(ppg::kFullWarp, all3);
  if (lane == 0) {
    a.pass1[g] = w_mid;
    a.full[g] = w_all;
  }
}

// The lowest `r` set bits of `p` (0 <= r <= popc(p)).
__device__ __forceinline__ uint32_t lowest_set_bits(uint32_t p, int r) {
  uint32_t out = 0;
  for (; r > 0; --r) {
    const uint32_t lsb = p & (0u - p);
    out |= lsb;
    p ^= lsb;
  }
  return out;
}

// Launch B: both compactions in one block. Warp v owns the words
// [v * kWarpWords, (v + 1) * kWarpWords), lane l the words v * kWarpWords +
// 32 r + l (r < kRounds): neighbouring lanes load neighbouring words, and a
// word's rank is its warp's base (one block scan of the warps' totals) plus
// the warp's earlier rounds plus a warp scan within the round.
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const uint32_t* __restrict__ pass1, const uint32_t* __restrict__ full,
    int n_words, int wpr, int64_t* __restrict__ ci, int64_t* __restrict__ cj,
    bool* __restrict__ cand_valid, int64_t* __restrict__ n_cand,
    bool* __restrict__ saturated) {
  const int lane = threadIdx.x & 31;
  const int w_first = (threadIdx.x >> 5) * kWarpWords + lane;

  uint32_t mid[kRounds], kept[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {  // all loads issued before any is used
    const int w = w_first + 32 * r;
    mid[r] = w < n_words ? pass1[w] : 0u;
    kept[r] = w < n_words ? full[w] : 0u;
  }

  // rank of each word's first midpoint survivor; keep those below
  // PHASE2_CAP (inside the word at the cut, the lowest bits), intersected
  // with the pairs that passed all three probes
  int before[kRounds], warp_total = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int n = __popc(mid[r]);
    const int inc = ppg::warp_inclusive_scan(n);
    before[r] = warp_total + inc - n;
    warp_total += __shfl_sync(ppg::kFullWarp, inc, 31);
  }
  int total1;
  const int base1 = ppg::block_warp_base(warp_total, &total1);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int b = base1 + before[r];
    const int n = __popc(mid[r]);
    uint32_t keep = 0;
    if (b + n <= kPhase2Cap)
      keep = mid[r];
    else if (b < kPhase2Cap)
      keep = lowest_set_bits(mid[r], kPhase2Cap - b);
    kept[r] &= keep;
  }

  // ranks of the kept pairs
  warp_total = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int n = __popc(kept[r]);
    const int inc = ppg::warp_inclusive_scan(n);
    before[r] = warp_total + inc - n;
    warp_total += __shfl_sync(ppg::kFullWarp, inc, 31);
  }
  int total2;
  const int base2 = ppg::block_warp_base(warp_total, &total2);

  // the words holding candidates below CAND_CAP, in order, into shared
  // memory: (word, word index, rank of its first candidate)
  __shared__ uint32_t list_word[kCandCap];
  __shared__ uint16_t list_index[kCandCap], list_rank[kCandCap];
  int slot_total;
  {
    int warp_slots = 0;
    unsigned use[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      use[r] = __ballot_sync(ppg::kFullWarp,
                             kept[r] != 0 && base2 + before[r] < kCandCap);
      warp_slots += __popc(use[r]);
    }
    int pos = ppg::block_warp_base(warp_slots, &slot_total);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if ((use[r] >> lane) & 1u) {
        const int p = pos + __popc(use[r] & ppg::lanes_below());
        list_word[p] = kept[r];
        list_index[p] = static_cast<uint16_t>(w_first + 32 * r);
        list_rank[p] = static_cast<uint16_t>(base2 + before[r]);
      }
      pos += __popc(use[r]);
    }
  }
  __syncthreads();

  // each output slot finds its word (binary search on the first ranks) and
  // its bit: consecutive threads write consecutive slots
  const int n_out = min(total2, kCandCap);
  for (int s = threadIdx.x; s < n_out; s += blockDim.x) {
    int lo = 0, hi = slot_total - 1;  // last entry whose rank is <= s
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (list_rank[m] <= s)
        lo = m;
      else
        hi = m - 1;
    }
    uint32_t word = list_word[lo];
    for (int k = s - list_rank[lo]; k > 0; --k) word &= word - 1;
    const int w = list_index[lo];
    const int i = w / wpr;
    ci[s] = i;
    cj[s] = (w - i * wpr) * 32 + __ffs(word) - 1;
  }
  for (int s = threadIdx.x; s < kCandCap; s += blockDim.x) {
    cand_valid[s] = s < total2;
    if (s >= total2) {
      ci[s] = 0;
      cj[s] = 0;
    }
  }
  if (threadIdx.x == 0) {
    *n_cand = total2;
    *saturated = total1 > kPhase2Cap || total2 > kCandCap;
  }
}

}  // namespace

// table: (h, ceil(w/8)) uint8; kp: (k, 2) f32; ok: (k,) bool; scratch:
// 2 * k * ceil(k/32) uint32 words; ci, cj: (CAND_CAP,) int64; cand_valid:
// (CAND_CAP,) bool; n_cand: int64; saturated: bool. Returns the
// cudaGetLastError() code of the launches (cudaErrorInvalidValue for a k
// outside [0, 512]).
extern "C" int ppg_pair_probe(const void* table, const void* kp,
                              const void* ok, void* scratch, void* ci,
                              void* cj, void* cand_valid, void* n_cand,
                              void* saturated, int k, int h, int w,
                              void* stream) {
  if (k < 0 || k > kMaxK || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ProbeArgs a;
  a.table = static_cast<const uint8_t*>(table);
  a.kp = static_cast<const float*>(kp);
  a.ok = static_cast<const uint8_t*>(ok);
  a.k = k;
  a.wpr = (k + 31) / 32;
  a.n_words = k * a.wpr;
  a.pass1 = static_cast<uint32_t*>(scratch);
  a.full = a.pass1 + a.n_words;
  a.h = h;
  a.w = w;
  a.w8 = (w + 7) / 8;
  if (a.n_words > 0) {
    const int warps = kProbeThreads / 32;
    probe_kernel<<<(a.n_words + warps - 1) / warps, kProbeThreads, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  select_kernel<<<1, kSelectThreads, 0, s>>>(
      a.pass1, a.full, a.n_words, a.wpr, static_cast<int64_t*>(ci),
      static_cast<int64_t*>(cj), static_cast<bool*>(cand_valid),
      static_cast<int64_t*>(n_cand), static_cast<bool*>(saturated));
  return static_cast<int>(cudaGetLastError());
}
