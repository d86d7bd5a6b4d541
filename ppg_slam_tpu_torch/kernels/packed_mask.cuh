// Device code shared by the kernels that sample the packed line mask
// (nearest_binary_packed.cu, pair_probe.cu, line_validate.cu), and the
// runtime-device query each of their libraries exports.
//
// `packed_bit` is the function of the TPU kernel
// ppg_slam_tpu/ops/sampling.py _nearest_binary_packed_kernel (:104-122):
// bit (x & 7) of byte table[y * w8 + (x >> 3)] of the (H, ceil(W/8)) uint8
// table of ops/sampling.py pack_binary_mask (LSB = lowest x). The three
// kernels share this one definition.
//
// Float steps are written with the _rn intrinsics, which nvcc never
// contracts into a fused multiply-add: the plain PyTorch version runs each
// multiply and add as its own rounded operation, and a contracted position
// can move a sample by one cell.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppg {

constexpr unsigned kFullWarp = 0xffffffffu;

// Bit of the packed mask at integer (y, x); 0 outside the table. The
// table lies in device memory and is read through the read-only cache.
__device__ __forceinline__ unsigned packed_bit(const uint8_t* table, int y,
                                               int x, int h, int w8) {
  const int xb = x >> 3;
  if ((unsigned)y >= (unsigned)h || (unsigned)xb >= (unsigned)w8) return 0u;
  return (__ldg(table + (size_t)y * w8 + xb) >> (x & 7)) & 1u;
}

// ops/pairs.py _round_clip: (v + 0.5) truncated toward zero (NaN gives 0,
// as PyTorch's float->int32 cast on the card), clamped to [0, lim].
__device__ __forceinline__ int round_clip(float v, int lim) {
  const int r = __float2int_rz(__fadd_rn(v, 0.5f));
  return min(max(r, 0), lim);
}

}  // namespace ppg

// The device that this library's CUDA runtime launches on. Every kernel
// library includes this header, and links its runtime statically, apart
// from PyTorch's: the Python wrappers hold this against the device of the
// tensors they pass before each launch (kernels/__init__.py check_device).
extern "C" int ppg_runtime_device(void) {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}
