"""A PNG codec in the standard library and numpy (zlib + struct).

The reference reads frames with `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`;
the port has no OpenCV, so `read_gray` returns what that call returns
through OpenCV's libpng decoder:

  * 8-bit grey as stored;
  * 16-bit grey (TUM-VI) with the low byte dropped (libpng's
    `png_set_strip_16`: v >> 8, not a rounded v / 256);
  * 8-bit RGB and RGBA through libpng's `png_set_rgb_to_gray(1, 0.299,
    0.587)`: a pixel with R == G == B keeps R, any other becomes
    (9797 R + 19234 G + 3737 B) >> 15 (the coefficients are 0.299 and 0.587
    of 32768, truncated; blue takes the rest), alpha dropped;
  * 8-bit grey + alpha with the alpha dropped.

All five scanline filters are decoded. Any other PNG (interlaced, palette,
bit depth below 8, 16-bit colour) raises ValueError naming the file.

`write_png` writes 8-bit grey or RGB, unfiltered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for the types read_gray decodes
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's rgb_to_gray weights for (0.299, 0.587) in 1/32768
_RGB_TO_GRAY = (9797, 19234, 3737)


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row scanline filters of non-interlaced image data:
    (h, w, bpp) uint8. Without the average and Paeth filters a row is
    rebuilt at once from the row above. With them, each reconstructed byte
    depends on its left, upper and upper-left neighbours, so the image is
    rebuilt one anti-diagonal of pixels at a time (h + w - 1 vectorised
    steps): on the skewed layout S[d + 2, y + 1] = pixel (y, d - y) those
    neighbours are slices of the two previous diagonals, zero outside the
    image."""
    rows = raw.reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"filter type {ftype.max()}")
    if ftype.max(initial=0) <= 2:  # none / sub / up: a row at a time
        out = rows[:, 1:].reshape(h, w, bpp).copy()
        for y in np.nonzero(ftype)[0]:
            if ftype[y] == 1:
                np.cumsum(out[y], axis=0, dtype=np.uint8, out=out[y])
            elif y:
                out[y] += out[y - 1]
        return out
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew_f = np.zeros((h + w - 1, h, bpp), np.int32)
    skew_f[xs + ys, ys] = filt
    skew = np.zeros((h + w + 1, h + 1, bpp), np.int32)
    t_all = ftype[:, None]
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = skew[d + 1, y0 + 1:y1 + 1]
        b = skew[d + 1, y0:y1]
        c = skew[d, y0:y1]
        t = t_all[y0:y1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(t == 1, a, np.where(
            t == 2, b, np.where(t == 3, (a + b) >> 1,
                                np.where(t == 4, paeth, 0))))
        skew[d + 2, y0 + 1:y1 + 1] = (skew_f[d, y0:y1] + pred) & 255
    return skew[xs + ys + 2, ys + 1].astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """(H, W) uint8 as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` returns it
    (see the module docstring); ValueError naming the file for any PNG it
    does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and ctype != 0):
        raise ValueError(f"{path}: PNG color type {ctype} at bit depth "
                         f"{depth} is not supported (8-bit grey, grey+alpha, "
                         "RGB, RGBA and 16-bit grey are)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt image data: {exc}") from None
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (w * bpp + 1)}")
    try:
        px = _unfilter(raw, h, w, bpp)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    if depth == 16 or ctype in (0, 4):
        # grey (+ alpha); 16-bit samples are big-endian and libpng's
        # strip_16 keeps their high byte
        return np.ascontiguousarray(px[..., 0])
    r, g, b = (px[..., i].astype(np.int32) for i in range(3))
    wr, wg, wb = _RGB_TO_GRAY
    grey = (wr * r + wg * g + wb * b) >> 15
    return np.where((r == g) & (g == b), r, grey).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 image as a PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("write_png takes (H, W) or (H, W, 3) uint8 images, "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.zeros((h, 1 + img[0].size), np.uint8)  # filter byte 0: none
    rows[:, 1:] = img.reshape(h, -1)
    data = (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
