// Nearest-pixel sampling of a bit-packed binary mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel ppg_slam_tpu/ops/sampling.py
// _nearest_binary_packed_kernel / _nearest_binary_packed_pallas (:104-145).
// out[i] = bit (x & 7) of byte packed[y * w8 + (x >> 3)], with (y, x) the
// i-th integer sample (pre-clipped to the image by the caller) and `packed`
// the (H, ceil(W/8)) uint8 table of ops/sampling.py pack_binary_mask
// (LSB = lowest x).
//
// The TPU kernel picks each sample's table row with a one-hot MXU matmul and
// extracts the bit with exp2/floor arithmetic, because the TPU has no fast
// gather. Here each thread makes one direct byte load instead.
//
// Bound: memory. A sample reads 8 B of coordinates and writes 1 B; the table
// (45 KB at 752x480) stays resident in L1/L2, so the floor is N * 9 B over the
// HBM rate (~0.7 us at N = 262144 on an H100 SXM). At the main path's sizes
// (N <= 262144) the launch itself dominates. Loads are coalesced (neighbouring
// threads read neighbouring coordinates); the table reads go through the
// read-only cache.
//
// Out-of-range samples (y outside [0, h) or x >> 3 outside [0, w8)) read
// nothing and give 0. The bit lookup is packed_mask.cuh's `packed_bit`, which
// the fused kernels pair_probe.cu and line_validate.cu share. The main path
// launches those; this kernel stays as the TPU kernel's direct counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_mask.cuh"

namespace {

__global__ void nearest_binary_packed_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ ys,
    const int32_t* __restrict__ xs, uint8_t* __restrict__ out, int n, int h,
    int w8) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = ppg::packed_bit(packed, __ldg(ys + i), __ldg(xs + i), h, w8);
}

}  // namespace

extern "C" int ppg_nearest_binary_packed(const void* packed, const void* ys,
                                         const void* xs, void* out, int n,
                                         int h, int w8, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  nearest_binary_packed_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(ys),
      static_cast<const int32_t*>(xs), static_cast<uint8_t*>(out), n, h, w8);
  return static_cast<int>(cudaGetLastError());
}
