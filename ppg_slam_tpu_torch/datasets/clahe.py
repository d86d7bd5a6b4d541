"""Contrast-limited adaptive histogram equalization of 8-bit images: a numpy
port of OpenCV's CLAHE (`cv2.createCLAHE(clip, grid).apply`, imgproc
clahe.cpp), which the vocabulary tool applies before extraction (the
reference trainBow.cpp uses createCLAHE(3.0, (8, 8))).

OpenCV's steps, in its arithmetic:
  * when either side is not a multiple of the grid, both sides are padded
    at the bottom and right by `grid - size % grid` (a whole extra tile row
    or column on a side that was a multiple) with BORDER_REFLECT_101, for
    the histograms only;
  * one 256-bin histogram per tile; clip limit max(1, int(clip * tile_area
    / 256)); the clipped excess is spread as excess // 256 on every bin,
    then one more on bins 0, step, 2 step, ... for the residual, with step
    max(256 // residual, 1);
  * LUT[i] = round_half_even(f32(cumsum[i]) * (255.f / tile_area));
  * each pixel blends the LUTs of its four neighbouring tiles bilinearly in
    f32, with weights from x * (1.f / tile_w) - 0.5f, and rounds half to
    even.
"""

from __future__ import annotations

import numpy as np

HIST = 256


def _tile_luts(img: np.ndarray, tiles_x: int, tiles_y: int, clip: float):
    """(tiles_y * tiles_x, 256) uint8 LUTs and the tile size (tw, th)."""
    h, w = img.shape
    if h % tiles_y or w % tiles_x:
        img = np.pad(img, ((0, tiles_y - h % tiles_y),
                           (0, tiles_x - w % tiles_x)), mode="reflect")
    th, tw = img.shape[0] // tiles_y, img.shape[1] // tiles_x
    area = th * tw
    tile = ((np.arange(tiles_y)[:, None, None, None] * tiles_x
             + np.arange(tiles_x)[None, None, :, None]))
    blocks = img.reshape(tiles_y, th, tiles_x, tw).astype(np.int64)
    idx = (tile * HIST + blocks).reshape(-1)
    hist = np.bincount(idx, minlength=tiles_y * tiles_x * HIST).reshape(
        -1, HIST)
    if clip > 0:
        limit = max(int(clip * area / HIST), 1)
        clipped = np.maximum(hist - limit, 0).sum(axis=1)
        hist = np.minimum(hist, limit) + (clipped // HIST)[:, None]
        residual = clipped % HIST
        step = np.maximum(HIST // np.maximum(residual, 1), 1)
        i = np.arange(HIST)[None, :]
        hist += ((i % step[:, None] == 0)
                 & (i // step[:, None] < residual[:, None]))
    scale = np.float32(HIST - 1) / np.float32(area)
    lut = np.rint(np.cumsum(hist, axis=1).astype(np.float32) * scale)
    return np.clip(lut, 0, 255).astype(np.uint8), tw, th


def _axis_weights(n: int, tile: int, n_tiles: int):
    """Per coordinate: the two neighbouring tiles and the second's weight,
    in OpenCV's f32 arithmetic."""
    f = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(tile)) \
        - np.float32(0.5)
    t1 = np.floor(f).astype(np.int64)
    a = (f - t1.astype(np.float32)).astype(np.float32)
    return np.maximum(t1, 0), np.minimum(t1 + 1, n_tiles - 1), a


def clahe(img: np.ndarray, clip: float = 40.0, grid=(8, 8)) -> np.ndarray:
    """`cv2.createCLAHE(clip, grid).apply(img)` for an (H, W) uint8 image;
    grid is (tiles_x, tiles_y) as OpenCV takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("clahe takes (H, W) uint8 images")
    tiles_x, tiles_y = grid
    lut, tw, th = _tile_luts(img, tiles_x, tiles_y, clip)
    lut = lut.reshape(tiles_y, tiles_x, HIST).astype(np.float32)
    h, w = img.shape
    x1, x2, xa = _axis_weights(w, tw, tiles_x)
    y1, y2, ya = _axis_weights(h, th, tiles_y)
    xa1 = np.float32(1.0) - xa
    ya1 = (np.float32(1.0) - ya)[:, None]
    ya = ya[:, None]
    v = img.astype(np.int64)

    def row_blend(ty):
        return (lut[ty[:, None], x1[None, :], v] * xa1
                + lut[ty[:, None], x2[None, :], v] * xa)

    res = row_blend(y1) * ya1 + row_blend(y2) * ya
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
