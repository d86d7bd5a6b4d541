"""Line-heatmap post-processing: tile-adaptive refinement + bilinear sampling.

Port of ppg_slam_tpu/ops/heatmap.py (reference refineHeatMap,
PPGExtractor.cpp:540-578):
  * per 16x16 tile: collect values > 1e-2 (row-major); valCount = 0.3*K
    (int); if valCount < 1 the tile is left untouched; if K >= 0.9*256 AND
    the (0.9*K)-th above-threshold value *in scan order* > 0.1 the tile is
    zeroed (saturated); otherwise values > 1e-2 are divided by the mean of the
    top valCount values (clamped to 1) and values <= 1e-2 are zeroed.

All dataset resolutions divide by 16, so tiles are uniform: one vectorized
op over (nTiles, 256).
"""

from __future__ import annotations

import torch

LINE_VALID_THRESH = 1.0e-2  # PPGExtractor.cpp:48
LINE_VALID_RATIO = 0.3
HEATMAP_REFINE_SZ = 16


def refine_heatmap(heat: torch.Tensor) -> torch.Tensor:
    """Tile-adaptive normalization of a (H, W) f32 heat map."""
    h, w = heat.shape
    ts = HEATMAP_REFINE_SZ
    if h % ts or w % ts:
        raise ValueError("image dims must divide by 16")
    gy, gx = h // ts, w // ts
    n = ts * ts
    tiles = heat.reshape(gy, ts, gx, ts).permute(0, 2, 1, 3).reshape(-1, n)

    mask = tiles > LINE_VALID_THRESH
    k = mask.sum(dim=1).to(torch.float32)  # above-threshold count per tile
    val_count = (LINE_VALID_RATIO * k).to(torch.int64)

    # the saturation probe: the (0.9*K)-th above-threshold value in scan order
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    sat_idx = (0.9 * k).to(torch.int64)
    sat_val = torch.where(mask & (rank == sat_idx[:, None]), tiles,
                          tiles.new_zeros(())).sum(dim=1)
    saturated = (k >= int(0.9 * n)) & (sat_val > 0.1)

    # mean of the top valCount above-threshold values
    vals = torch.where(mask, tiles, tiles.new_zeros(()))
    sorted_vals = torch.sort(vals, dim=1, descending=True).values
    csum = torch.cumsum(sorted_vals, dim=1)
    vc = val_count.clamp(1, n)
    ave = torch.gather(csum, 1, (vc - 1)[:, None])[:, 0] / vc.to(torch.float32)

    zero = tiles.new_zeros(())
    refined = torch.where(mask, torch.clamp(tiles / ave[:, None], max=1.0),
                          zero)
    out = torch.where(saturated[:, None], zero, refined)
    out = torch.where((val_count < 1)[:, None], tiles, out)  # untouched tiles
    return out.reshape(gy, gx, ts, ts).permute(0, 2, 1, 3).reshape(h, w)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (H, W) image at float coords, zero padding
    outside (cv::remap BORDER_CONSTANT 0 semantics)."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    zero = img.new_zeros(())

    def tap(yi, xi):
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return torch.where(inb, v, zero)

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy)
            + tap(y0i, x0i + 1) * fx * (1 - fy)
            + tap(y0i + 1, x0i) * (1 - fx) * fy
            + tap(y0i + 1, x0i + 1) * fx * fy)


def remap_heatmap(heat: torch.Tensor, remap_xy: torch.Tensor) -> torch.Tensor:
    """cv::remap(INTER_LINEAR) equivalent: remap_xy is the (H, W, 2) map of
    source coordinates (the undistortion map,
    CameraModel.undistort_rectify_map). The extractor runs the same
    resampling as sampling.remap_bilinear."""
    return bilinear_sample(heat, remap_xy[..., 0], remap_xy[..., 1])
