// Sampled line validation of the pair candidates, fused, for Hopper
// (sm_90a).
//
// Replaces the device work of ops/pairs.py validate_candidates (JAX
// counterpart: ppg_slam_tpu/ops/pairs.py:197-283 validate_candidates), whose
// inlier rates sample the packed line mask through the TPU kernel
// ppg_slam_tpu/ops/sampling.py _nearest_binary_packed_kernel. Per candidate
// c (pair ci[c], cj[c], length dist[c]):
//   lvl = clamp(int((dist * inv_scale) * 4), 0, 3)
//   seg = cand_valid ? clamp(int(dist * INV_SAMPLE_GAP[lvl]), 0, 127) : 0
//   samples i = 1 .. seg-1 at ps * (i * step) + pe * ((seg - i) * step),
//   step = 1 / seg (ops/pairs.py _grid_positions), and
//   rate  = (# samples whose packed-mask bit of heat > 0.2 is set) / (seg-1)
//   score = (sum of the bilinear heat at the samples) / (seg-1)
//   midv  = bilinear heat at 0.5 * (ps + pe)            (for seg == 1)
// then every cap and flag of the plain version: the first LONG_CAP long
// candidates (seg > 32) get the long rate (`fits`), the first SCORE_S_CAP
// rate-passing shorts and the LONG_CAP rate-passing longs get a score
// (`fits_s`), `overflow`, and the slot-0 revert of ops/pairs.py
// _update_compacted (ROADMAP.md §3: candidate 0 keeps a compacted update
// only when every slot of that compaction is valid), then `good` and
// `lscore` = rate * score (midv where seg == 1).
//
// Design. Launch A runs one warp per candidate: the sample grid lives in
// registers (lane l takes samples l+1, l+33, ...: one round for shorts, four
// for longs), the rate is a __ballot_sync/__popc count, and the score, where
// the raw rate passes, a per-lane sum and a shuffle reduction. Computing the
// rate and score for every candidate and masking afterwards is exact: the
// caps only select. Launch B, one block of 1024 threads, applies the caps
// in candidate order: each warp owns 128 consecutive candidates, lane l
// every 32nd of them, so loads and stores coalesce (4 consecutive
// candidates a thread was slower: strided stores); ballots and a block
// scan of the warps' totals (longs;
// then rate-passing shorts and longs packed into one int) give each
// candidate its rank; it writes good, lscore, overflow and the final rate
// and score.
//
// Numerics: every sample position and bilinear weight is formed with the
// _rn intrinsics in the plain version's operation order, so the rate (an
// integer count over seg-1) and midv are bit-equal to it. The score sum runs
// in another order than PyTorch's reduction: lscore differs from the plain
// version by at most a few ulp (bound: 2 (seg-2) ulp of the sum, 252 ulp at
// seg 127, since every summand is >= 0), and `good` could differ only where
// the score lies that close to 0.2.
//
// Bound: bytes. The table (45 KB at 752x480), ci/cj/dist/cand_valid
// (21 B a candidate), the heat taps the scores need and the outputs come to
// ~0.2-0.3 MB a frame: ~0.1 us over 3.35 TB/s; the ~11 f32 operations a rate
// sample and ~26 a score sample are fewer still at 67 TFLOP/s. Two
// launches' latency is the floor in practice, where the plain version
// issues ~150 PyTorch ops.
//
// The table is read through the read-only cache. A persistent grid that
// first copied it into each block's shared memory was ~2 us slower at
// 752x480 (PERF.md §6).
//
// ci and cj index kp as PyTorch does (-k <= index < k, a negative one
// counting from the end); the plain version raises on any other index.
// Here such a candidate reads keypoint 0 and sets `index_error`, on which
// the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "packed_mask.cuh"

namespace {

constexpr int kShortS = 32;
constexpr int kMaxSeg = 127;
constexpr int kLongCap = 512;
constexpr int kScoreSCap = 2048;
constexpr int kMaxCand = 4096;
constexpr int kFinalThreads = 1024;
// candidates a finalise lane owns (4096 / 1024), and a warp
constexpr int kRounds = kMaxCand / kFinalThreads;
constexpr int kWarpCands = 32 * kRounds;
constexpr int kSampleThreads = 256;
// set in a candidate's seg scratch word when ci or cj is out of range
constexpr int kBadIndex = 1 << 30;

struct ValidateArgs {
  const uint8_t* table;  // packed mask of heat > LINE_HEATMAP_THRESH
  const float* heat;     // (h, w) f32
  const float* kp;       // (k, 2) f32
  const int64_t* ci;
  const int64_t* cj;
  const float* dist;
  const uint8_t* cand_valid;
  int* seg;      // (n,) scratch
  float* rate;   // (n,) raw, then final
  float* score;  // (n,) raw, then final
  float* midv;   // (n,) scratch
  int n, k, h, w, w8;
  float inv_scale;
};

// INV_SAMPLE_GAP as PyTorch holds it: each Python float cast to f32.
__device__ __forceinline__ float inv_sample_gap(int lvl) {
  switch (lvl) {
    case 0: return static_cast<float>(0.3333);
    case 1: return static_cast<float>(0.200);
    case 2: return static_cast<float>(0.1427);
    default: return static_cast<float>(0.1111);
  }
}

// ops/sampling.py bilinear_f32: zero padding, y taps mixed first.
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int h, int w, float y, float x) {
  const float y0f = floorf(y), x0f = floorf(x);
  const float fy = __fsub_rn(y, y0f), fx = __fsub_rn(x, x0f);
  const long long y0 = static_cast<long long>(y0f);
  const long long x0 = static_cast<long long>(x0f);
  const long long y1 = y0 + 1, x1 = x0 + 1;
  const bool iny0 = y0 >= 0 && y0 < h, iny1 = y1 >= 0 && y1 < h;
  const bool inx0 = x0 >= 0 && x0 < w, inx1 = x1 >= 0 && x1 < w;
  const float v00 = (iny0 && inx0) ? __ldg(img + y0 * w + x0) : 0.0f;
  const float v10 = (iny1 && inx0) ? __ldg(img + y1 * w + x0) : 0.0f;
  const float v01 = (iny0 && inx1) ? __ldg(img + y0 * w + x1) : 0.0f;
  const float v11 = (iny1 && inx1) ? __ldg(img + y1 * w + x1) : 0.0f;
  const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
  const float r0 = __fadd_rn(__fmul_rn(v00, gy), __fmul_rn(v10, fy));
  const float r1 = __fadd_rn(__fmul_rn(v01, gy), __fmul_rn(v11, fy));
  return __fadd_rn(__fmul_rn(r0, gx), __fmul_rn(r1, fx));
}

// Sample s (1-based) of the grid: ps * (s * step) + pe * ((segf - s) * step).
__device__ __forceinline__ float grid_coord(float p, float q, float sf,
                                            float segf, float step) {
  return __fadd_rn(__fmul_rn(p, __fmul_rn(sf, step)),
                   __fmul_rn(q, __fmul_rn(__fsub_rn(segf, sf), step)));
}

// Launch A: one warp per candidate.
__global__ void __launch_bounds__(kSampleThreads)
    sample_kernel(ValidateArgs a) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= a.n) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const bool valid = a.cand_valid[c] != 0;
  const float d = a.dist[c];
  const int lvl = min(max(__float2int_rz(__fmul_rn(__fmul_rn(d, a.inv_scale),
                                                   4.0f)), 0), 3);
  int seg = min(max(__float2int_rz(__fmul_rn(d, inv_sample_gap(lvl))), 0),
                kMaxSeg);
  if (!valid) seg = 0;
  int64_t ic = a.ci[c], jc = a.cj[c];
  if (ic < 0) ic += a.k;
  if (jc < 0) jc += a.k;
  const bool bad = ic < 0 || ic >= a.k || jc < 0 || jc >= a.k;
  if (bad) ic = jc = 0;
  const float psx = a.kp[2 * ic], psy = a.kp[2 * ic + 1];
  const float pex = a.kp[2 * jc], pey = a.kp[2 * jc + 1];
  const float segf = static_cast<float>(max(seg, 1));
  const float step = __fdiv_rn(1.0f, segf);
  const float denom = static_cast<float>(max(seg - 1, 1));
  const int rounds = seg > kShortS ? 4 : 1;

  int cnt = 0;
  for (int r = 0; r < rounds; ++r) {
    const int s = r * 32 + lane + 1;
    unsigned hit = 0;
    if (s <= seg - 1) {
      const float sf = static_cast<float>(s);
      const float px = grid_coord(psx, pex, sf, segf, step);
      const float py = grid_coord(psy, pey, sf, segf, step);
      hit = ppg::packed_bit(a.table, ppg::round_clip(py, a.h - 1),
                            ppg::round_clip(px, a.w - 1), a.h, a.w8);
    }
    cnt += __popc(__ballot_sync(ppg::kFullWarp, hit));
  }
  const float rate = __fdiv_rn(static_cast<float>(cnt), denom);

  float score = 0.0f;
  if (seg >= 2 && rate >= static_cast<float>(0.8)) {  // warp-uniform
    float part = 0.0f;
    for (int r = 0; r < rounds; ++r) {
      const int s = r * 32 + lane + 1;
      if (s <= seg - 1) {
        const float sf = static_cast<float>(s);
        part = __fadd_rn(part, bilinear(a.heat, a.h, a.w,
                                        grid_coord(psy, pey, sf, segf, step),
                                        grid_coord(psx, pex, sf, segf, step)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(ppg::kFullWarp, part, o));
    score = __fdiv_rn(part, denom);
  }
  if (lane == 0) {
    float mid = 0.0f;
    if (seg == 1)
      mid = bilinear(a.heat, a.h, a.w,
                     __fmul_rn(0.5f, __fadd_rn(psy, pey)),
                     __fmul_rn(0.5f, __fadd_rn(psx, pex)));
    a.seg[c] = bad ? seg | kBadIndex : seg;
    a.rate[c] = rate;
    a.score[c] = score;
    a.midv[c] = mid;
  }
}

// Launch B: the caps, flags and slot-0 reverts, in candidate order. Warp v
// owns the candidates [v * kWarpCands, (v + 1) * kWarpCands), lane l those
// at v * kWarpCands + 32 r + l (r < kRounds): loads and stores coalesce, and
// a candidate's rank among the flagged ones is its warp's base (one block
// scan of the warps' totals) plus the ballots of the warp's earlier rounds
// and lanes.
__global__ void __launch_bounds__(kFinalThreads) finalize_kernel(
    ValidateArgs a, bool* __restrict__ good, float* __restrict__ lscore,
    bool* __restrict__ overflow, bool* __restrict__ index_error) {
  const float kRate = static_cast<float>(0.8);
  const float kThresh = static_cast<float>(0.2);
  const unsigned below = ppg::lanes_below();
  const int c_first = (threadIdx.x >> 5) * kWarpCands + (threadIdx.x & 31);
  int seg[kRounds];
  bool valid[kRounds];
  float rate[kRounds], score[kRounds], midv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {  // all loads issued before any is used
    const int c = c_first + 32 * r;
    const bool in = c < a.n;
    seg[r] = in ? a.seg[c] : 0;
    valid[r] = in && a.cand_valid[c] != 0;
    rate[r] = in ? a.rate[c] : 0.0f;
    score[r] = in ? a.score[c] : 0.0f;
    midv[r] = in ? a.midv[c] : 0.0f;
  }
  bool bad = false;  // an index out of range anywhere in the block
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    bad |= (seg[r] & kBadIndex) != 0;
    seg[r] &= ~kBadIndex;
  }
  bad = __syncthreads_or(bad);

  // longs before each candidate
  unsigned long_bits[kRounds];
  int warp_longs = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    long_bits[r] = __ballot_sync(ppg::kFullWarp, seg[r] > kShortS);
    warp_longs += __popc(long_bits[r]);
  }
  int n_long;
  int longs_before = ppg::block_warp_base(warp_longs, &n_long);

  // rates: a long candidate has its long-grid rate when it is among the
  // first LONG_CAP longs (candidate 0 only when that compaction is full);
  // otherwise its short-grid rate, 0
  bool fits[kRounds];
  unsigned need_s[kRounds], need_l[kRounds];  // ballots
  int warp_s = 0, warp_l = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int c = c_first + 32 * r;
    const bool is_long = seg[r] > kShortS;
    const int lb = longs_before + __popc(long_bits[r] & below);
    longs_before += __popc(long_bits[r]);
    fits[r] = !is_long || lb < kLongCap;
    if (is_long && !(lb < kLongCap && (c != 0 || n_long >= kLongCap)))
      rate[r] = 0.0f;
    const bool need = valid[r] && fits[r] && seg[r] >= 2 && rate[r] >= kRate;
    need_s[r] = __ballot_sync(ppg::kFullWarp, need && !is_long);
    need_l[r] = __ballot_sync(ppg::kFullWarp, need && is_long);
    warp_s += __popc(need_s[r]);
    warp_l += __popc(need_l[r]);
  }
  // rate-passing shorts | rate-passing longs << 16 (each at most 4096)
  int total;
  const int before = ppg::block_warp_base(warp_s | warp_l << 16, &total);
  int s_before = before & 0xffff, l_before = before >> 16;
  const int n_need_s = total & 0xffff, n_need_l = total >> 16;

#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int c = c_first + 32 * r;
    const bool is_s = (need_s[r] >> (threadIdx.x & 31)) & 1u;
    const bool is_l = (need_l[r] >> (threadIdx.x & 31)) & 1u;
    const int sb = s_before + __popc(need_s[r] & below);
    const int lb = l_before + __popc(need_l[r] & below);
    s_before += __popc(need_s[r]);
    l_before += __popc(need_l[r]);
    float sc = 0.0f;
    if (is_s && sb < kScoreSCap && (c != 0 || n_need_s >= kScoreSCap))
      sc = score[r];
    if (is_l && lb < kLongCap && (c != 0 || n_need_l >= kLongCap))
      sc = score[r];
    const bool fits_s = !is_s || sb < kScoreSCap;
    const bool seg1 = seg[r] == 1;
    const bool g = valid[r] && fits[r] && fits_s &&
                   (seg1 || (seg[r] >= 2 && rate[r] >= kRate && sc >= kThresh));
    if (c < a.n) {
      good[c] = g;
      lscore[c] = g ? (seg1 ? midv[r] : __fmul_rn(rate[r], sc)) : 0.0f;
      a.rate[c] = rate[r];
      a.score[c] = sc;
    }
  }
  if (threadIdx.x == 0) {
    *overflow = n_long > kLongCap || n_need_s > kScoreSCap;
    *index_error = bad;
  }
}

}  // namespace

// table: (h, ceil(w/8)) uint8; heat: (h, w) f32; kp: (k, 2) f32; ci, cj:
// (n,) int64; dist: (n,) f32; cand_valid: (n,) bool; seg: (n,) int32
// scratch; rate, score, midv: (n,) f32 (rate and score end as the plain
// version's final values); good: (n,) bool; lscore: (n,) f32; overflow,
// index_error: bool. Returns the cudaGetLastError() code of the launches
// (cudaErrorInvalidValue for n outside [0, 4096] or k < 1).
extern "C" int ppg_line_validate(
    const void* table, const void* heat, const void* kp, const void* ci,
    const void* cj, const void* dist, const void* cand_valid, void* seg,
    void* rate, void* score, void* midv, void* good, void* lscore,
    void* overflow, void* index_error, int n, int k, int h, int w,
    float inv_scale, void* stream) {
  if (n < 0 || n > kMaxCand || k < 1 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ValidateArgs a;
  a.table = static_cast<const uint8_t*>(table);
  a.heat = static_cast<const float*>(heat);
  a.kp = static_cast<const float*>(kp);
  a.ci = static_cast<const int64_t*>(ci);
  a.cj = static_cast<const int64_t*>(cj);
  a.dist = static_cast<const float*>(dist);
  a.cand_valid = static_cast<const uint8_t*>(cand_valid);
  a.seg = static_cast<int*>(seg);
  a.rate = static_cast<float*>(rate);
  a.score = static_cast<float*>(score);
  a.midv = static_cast<float*>(midv);
  a.n = n;
  a.k = k;
  a.h = h;
  a.w = w;
  a.w8 = (w + 7) / 8;
  a.inv_scale = inv_scale;
  if (n > 0) {
    const int warps = kSampleThreads / 32;
    sample_kernel<<<(n + warps - 1) / warps, kSampleThreads, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_kernel<<<1, kFinalThreads, 0, s>>>(
      a, static_cast<bool*>(good), static_cast<float*>(lscore),
      static_cast<bool*>(overflow), static_cast<bool*>(index_error));
  return static_cast<int>(cudaGetLastError());
}
