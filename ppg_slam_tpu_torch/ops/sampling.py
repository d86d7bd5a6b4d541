"""Bulk image sampling: packed binary nearest, bilinear, and the heat remap.

Port of ppg_slam_tpu/ops/sampling.py. The reference expresses every gather as
a one-hot MXU matmul because the TPU has no fast gather; here they are direct
gathers. The values are the contract:

  * `nearest_binary_packed` (the reference's one Pallas kernel) runs the
    hand-written CUDA kernel kernels/nearest_binary_packed.cu on CUDA tensors
    and its plain PyTorch version `nearest_binary_packed_ref` on CPU tensors.
  * `bilinear_f32` and `remap_bilinear` are 4-tap gathers with zero padding,
    grouped in the same order as the reference's two one-hot contractions
    (bilinear_f32: y taps then x; remap_banded: x taps then y).
"""

from __future__ import annotations

import torch

from .. import kernels

SBLK = 2048  # the reference Pallas kernel's sample block (test shapes only)


def pack_binary_mask(mask_bool: torch.Tensor) -> torch.Tensor:
    """Pack a (H, W) boolean mask into (H, ceil(W/8)) uint8 bytes holding 8
    consecutive column bits each, LSB = lowest x."""
    h, w = mask_bool.shape
    w8 = (w + 7) // 8
    m = mask_bool.to(torch.int32)
    if w8 * 8 != w:
        m = torch.nn.functional.pad(m, (0, w8 * 8 - w))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=mask_bool.device)
    return (m.reshape(h, w8, 8) * weights).sum(dim=2).to(torch.uint8)


def nearest_binary_packed_ref(packed: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the nearest_binary_packed kernel: bit
    (x & 7) of packed[y, x >> 3] for integer samples pre-clipped to the
    image. Returns (N,) bool."""
    ys = ys.long()
    xs = xs.long()
    byte = packed[ys, xs >> 3].to(torch.int32)
    return ((byte >> (xs & 7).to(torch.int32)) & 1).bool()


def nearest_binary_packed(packed: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """nearest_binary against a pack_binary_mask table. CUDA tensors launch
    the CUDA kernel (or raise); CPU tensors run nearest_binary_packed_ref.

    packed: (H, W8) uint8; ys, xs: (N,) int32, pre-clipped. Returns (N,)
    bool."""
    if packed.device.type == "cpu":
        return nearest_binary_packed_ref(packed, ys, xs)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("packed must be a (H, W8) uint8 table")
    if ys.dtype != torch.int32 or xs.dtype != torch.int32:
        raise ValueError("ys and xs must be int32")
    if ys.shape != xs.shape or ys.dim() != 1:
        raise ValueError("ys and xs must be (N,) of one shape")
    if not (ys.device == xs.device == packed.device):
        raise ValueError("packed, ys and xs must be on one device")
    packed = packed.contiguous()
    ys = ys.contiguous()
    xs = xs.contiguous()
    n = ys.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=packed.device)
    if n == 0:
        return out
    h, w8 = packed.shape
    kernels.check_device("nearest_binary_packed", packed.device)
    launch = kernels.launcher("nearest_binary_packed")
    code = launch(packed.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                  out.data_ptr(), n, h, w8,
                  torch.cuda.current_stream(packed.device).cuda_stream)
    kernels.check_launch("nearest_binary_packed", code)
    nearest_binary_packed.launches += 1
    return out


nearest_binary_packed.launches = 0  # CUDA kernel launches, for chip_smoke.py


def nearest_binary(mask: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Sample a (H, W) 0/1 mask at integer (ys, xs), pre-clipped; (N,) bool."""
    return mask[ys.long(), xs.long()] > 0.5


def _taps(coord: torch.Tensor, size: int):
    """Floor index, clipped neighbour indices and in-range flags of the two
    linear-interpolation taps along one axis."""
    c0 = torch.floor(coord)
    f = coord - c0
    i0 = c0.to(torch.int64)
    i1 = i0 + 1
    in0 = (i0 >= 0) & (i0 < size)
    in1 = (i1 >= 0) & (i1 < size)
    return f, i0.clamp(0, size - 1), i1.clamp(0, size - 1), in0, in1


def bilinear_f32(img: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (H, W) f32 image at float (y, x), zero padding
    outside (ops.heatmap.bilinear_sample semantics); y taps mixed first."""
    h, w = img.shape
    fy, y0, y1, iny0, iny1 = _taps(y, h)
    fx, x0, x1, inx0, inx1 = _taps(x, w)
    zero = img.new_zeros(())

    def tap(yi, xi, ok):
        return torch.where(ok, img[yi, xi], zero)

    r0 = tap(y0, x0, iny0 & inx0) * (1.0 - fy) + tap(y1, x0, iny1 & inx0) * fy
    r1 = tap(y0, x1, iny0 & inx1) * (1.0 - fy) + tap(y1, x1, iny1 & inx1) * fy
    return r0 * (1.0 - fx) + r1 * fx


def remap_bilinear(heat: torch.Tensor, mapx: torch.Tensor,
                   mapy: torch.Tensor) -> torch.Tensor:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT 0): out[v, u] = bilinear
    sample of `heat` at (mapy[v, u], mapx[v, u]); x taps mixed first."""
    h, w = heat.shape
    fx, x0, x1, inx0, inx1 = _taps(mapx, w)
    fy, y0, y1, iny0, iny1 = _taps(mapy, h)
    zero = heat.new_zeros(())
    wx0 = torch.where(inx0, 1.0 - fx, zero)
    wx1 = torch.where(inx1, fx, zero)
    wy0 = torch.where(iny0, 1.0 - fy, zero)
    wy1 = torch.where(iny1, fy, zero)
    row0 = heat[y0, x0] * wx0 + heat[y0, x1] * wx1
    row1 = heat[y1, x0] * wx0 + heat[y1, x1] * wx1
    return row0 * wy0 + row1 * wy1
