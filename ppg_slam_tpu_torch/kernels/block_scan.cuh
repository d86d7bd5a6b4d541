// Warp and block prefix sums, for the single-block compaction passes of
// pair_probe.cu and line_validate.cu.

#pragma once

#include <cuda_runtime.h>

namespace ppg {

// Inclusive prefix sum of `v` over the lanes of a full warp.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Bits of the lanes below this one.
__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Exclusive prefix sum of `v` over the threads of the block, in thread
// order; `*total` receives the block's sum. Every thread of the block must
// call it. blockDim.x is a multiple of 32 and at most 1024.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    // inclusive sums of the warps' totals
    warp_sums[lane] =
        warp_inclusive_scan(lane < n_warps ? warp_sums[lane] : 0);
  }
  __syncthreads();
  const int base = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return base + inc - v;
}

// Sum of the block's earlier warps' `warp_total`s (each warp passes its
// total, the same on every lane); `*total` receives the block's sum.
__device__ __forceinline__ int block_warp_base(int warp_total, int* total) {
  return block_exclusive_scan((threadIdx.x & 31) == 31 ? warp_total : 0,
                              total);
}

}  // namespace ppg
