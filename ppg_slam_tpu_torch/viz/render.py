"""Minimal deterministic software 3-D renderer for the offline viewer: a
port of ppg_slam_tpu/viz/render.py that rasterizes in numpy (the port has
no PIL).

The reference viewer draws the map with OpenGL/Pangolin (Viewer.cpp:66-231).
This headless equivalent projects world geometry through a look-at view and
a pinhole projection (`look_at` and `Canvas3D.project` are copies of the
JAX package's) and rasterizes into an (H, W, 3) uint8 array: lines as DDA
samples between PIL's truncated endpoints, widened across the line, points
as filled discs in PIL's truncated boxes, alpha blended onto the white
background as `_blend` does, text from a 5x7 bitmap font. Same scene
content (points / lines / camera frusta) as the PIL renderer; the pixels
differ where the two rasterizers round (wide lines, ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..datasets.png import write_png

Color = Tuple[int, int, int]

BG = (255, 255, 255)  # reference: glClearColor(1,1,1,1), Viewer.cpp:190


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) mapping world -> view coords, view +z pointing at the target
    (same handedness as pangolin::ModelViewLookAt consumed by a pinhole
    projection with +z forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    n = np.linalg.norm(fwd)
    if n < 1e-12:
        fwd = np.array([0.0, 0.0, 1.0])
    else:
        fwd = fwd / n
    upn = np.asarray(up, np.float64)
    right = np.cross(fwd, upn)
    rn = np.linalg.norm(right)
    if rn < 1e-9:  # up parallel to forward: pick any orthogonal
        upn = np.array([0.0, -1.0, 0.0]) if abs(fwd[1]) < 0.9 \
            else np.array([1.0, 0.0, 0.0])
        right = np.cross(fwd, upn)
        rn = np.linalg.norm(right)
    right = right / rn
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: view axes in world coords
    t = -R @ eye
    return R.astype(np.float32), t.astype(np.float32)


def _blend(c: Color, alpha: float) -> Color:
    """Alpha-blend a color onto the white background (emulates
    glBlendFunc(SRC_ALPHA, ONE_MINUS_SRC_ALPHA) on the cleared canvas)."""
    a = float(min(max(alpha, 0.0), 1.0))
    return tuple(int(round(BG[i] * (1.0 - a) + c[i] * a)) for i in range(3))


def _colors(color: Color, alpha: Optional[np.ndarray], n: int) -> np.ndarray:
    """(n, 3) uint8: `color`, or `color` blended at each alpha."""
    if alpha is None:
        return np.tile(np.asarray(color, np.uint8), (n, 1))
    return np.asarray([_blend(color, float(a)) for a in alpha], np.uint8)


def _stamp(img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
           cols: np.ndarray) -> None:
    """Paint pixels (xs, ys) with cols, dropping those off the image; later
    entries win."""
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = cols[ok]


def draw_lines(img: np.ndarray, a: np.ndarray, b: np.ndarray,
               cols: np.ndarray, width: int = 1) -> None:
    """Segments a[i] -> b[i] ((N, 2) pixel coords) in cols[i], `width` px
    wide. As PIL does, the endpoints are truncated to integers; the pixels
    are DDA samples one pixel apart along the longer axis, each widened to
    `width` pixels across it."""
    a = np.trunc(np.asarray(a, np.float64).reshape(-1, 2))
    b = np.trunc(np.asarray(b, np.float64).reshape(-1, 2))
    if not len(a):
        return
    span = np.abs(b - a)
    n = span.max(axis=1).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(a)), n)
    k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    f = (k / np.maximum(n[seg] - 1, 1))[:, None]
    p = np.floor(a[seg] + (b[seg] - a[seg]) * f + 0.5).astype(np.int64)
    across = (span[:, 0] >= span[:, 1])[seg]  # widen along y, else x
    lo = -((width - 1) // 2)
    for o in range(lo, lo + width):
        _stamp(img, p[:, 0] + np.where(across, 0, o),
               p[:, 1] + np.where(across, o, 0), cols[seg])


def draw_discs(img: np.ndarray, centers: np.ndarray, r: float,
               cols: np.ndarray, outline: bool = False) -> None:
    """Filled discs (or 1-px rings) of radius r at (N, 2) pixel centres,
    drawn as PIL draws the ellipse in the box centre -+ r: the box is
    truncated to integers, and a pixel is in when its centre lies within
    the box's half sides + 0.25."""
    c = np.asarray(centers, np.float64).reshape(-1, 2)
    if not len(c):
        return
    lo, hi = np.trunc(c - r), np.trunc(c + r)
    mid, semi = (lo + hi) / 2.0, (hi - lo) / 2.0

    def inside(xs, ys, shrink):
        ax = np.maximum(semi - shrink, 0) + 0.25
        return (((xs - mid[:, 0]) / ax[:, 0]) ** 2
                + ((ys - mid[:, 1]) / ax[:, 1]) ** 2) <= 1.0

    ri = int(np.ceil(r)) + 1
    base = lo.astype(np.int64)
    for dy in range(2 * ri + 1):
        for dx in range(2 * ri + 1):
            xs, ys = base[:, 0] + dx, base[:, 1] + dy
            keep = inside(xs, ys, 0)
            if outline:
                keep &= ~inside(xs, ys, 1)
            _stamp(img, xs[keep], ys[keep], cols[keep])


class Canvas3D:
    """Rasterizes 3-D primitives through a fixed view into an RGB array."""

    def __init__(self, width: int = 1024, height: int = 768,
                 focal: float = 500.0, znear: float = 0.1):
        self.w, self.h = int(width), int(height)
        self.f = float(focal)
        self.cx, self.cy = self.w / 2.0, self.h / 2.0
        self.znear = float(znear)
        self.img = np.full((self.h, self.w, 3), BG, np.uint8)
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)

    def set_view(self, eye, target, up) -> None:
        self.R, self.t = look_at(eye, target, up)

    # ------------------------------------------------------------------
    def project(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(N,3) world -> (N,2) pixel coords + (N,) visibility mask."""
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        pv = pts @ self.R.T + self.t
        z = pv[:, 2]
        ok = z > self.znear
        zs = np.where(ok, z, 1.0)
        u = self.f * pv[:, 0] / zs + self.cx
        v = self.f * pv[:, 1] / zs + self.cy
        uv = np.stack([u, v], axis=1)
        ok &= (u > -4 * self.w) & (u < 5 * self.w) \
            & (v > -4 * self.h) & (v < 5 * self.h)
        return uv, ok

    # ------------------------------------------------------------------
    def points(self, pts: np.ndarray, color: Color, size: int = 2,
               alpha: Optional[np.ndarray] = None) -> None:
        uv, ok = self.project(pts)
        cols = _colors(color, alpha, len(uv))
        draw_discs(self.img, uv[ok], max(size // 2, 1), cols[ok])

    def lines(self, a: np.ndarray, b: np.ndarray, color: Color,
              width: int = 1, alpha: Optional[np.ndarray] = None) -> None:
        """Segments a[i] -> b[i], both (N,3) world coords."""
        ua, oka = self.project(a)
        ub, okb = self.project(b)
        ok = oka & okb
        cols = _colors(color, alpha, len(ua))
        draw_lines(self.img, ua[ok], ub[ok], cols[ok], width)

    def axes(self, Rwc: np.ndarray, Ow: np.ndarray, scale: float = 0.1,
             width: int = 1) -> None:
        """RGB coordinate axes of a pose (reference keyframe glyph,
        Viewer.cpp:651-676)."""
        Ow = np.asarray(Ow, np.float32)
        for k, col in enumerate([(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
            tip = Ow + scale * np.asarray(Rwc, np.float32)[:, k]
            self.lines(Ow[None], tip[None], col, width=width)

    def frustum(self, Rwc: np.ndarray, Ow: np.ndarray, color: Color,
                w: float = 0.08, width: int = 2) -> None:
        """Camera wireframe pyramid (reference DrawCurrentCamera,
        Viewer.cpp:749-797; w=0.4 scaled down for map scale)."""
        h, z = w * 0.75, w * 0.6
        corners_c = np.array([[w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
                             np.float32)
        Rwc = np.asarray(Rwc, np.float32)
        Ow = np.asarray(Ow, np.float32)
        corners = corners_c @ Rwc.T + Ow
        apex = np.repeat(Ow[None], 4, axis=0)
        self.lines(apex, corners, color, width=width)
        self.lines(corners, np.roll(corners, 1, axis=0), color, width=width)

    # ------------------------------------------------------------------
    def array(self) -> np.ndarray:
        return self.img.copy()

    def save(self, path: str) -> None:
        write_png(path, self.img)


# 5x7 bitmap font: seven rows of five bits (bit 4 = leftmost column).
# Lowercase letters draw as uppercase; other characters as '?'.
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 17, 31, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    ":": (0, 12, 12, 0, 12, 12, 0), ",": (0, 0, 0, 0, 12, 4, 8),
    ".": (0, 0, 0, 0, 0, 12, 12), "(": (2, 4, 8, 8, 8, 4, 2),
    ")": (8, 4, 2, 2, 2, 4, 8), "-": (0, 0, 0, 31, 0, 0, 0),
    "+": (0, 4, 4, 31, 4, 4, 0), "=": (0, 0, 31, 0, 31, 0, 0),
    "/": (0, 1, 2, 4, 8, 16, 0), "%": (24, 25, 2, 4, 8, 19, 3),
    "?": (14, 17, 1, 2, 4, 0, 4),
}


def draw_text(img: np.ndarray, x: int, y: int, text: str,
              color: Color = (255, 255, 255)) -> None:
    """Draw `text` with its top-left corner at (x, y), 6 px a character."""
    bits = np.array([[(row >> (4 - c)) & 1 for c in range(5)]
                     for ch in text
                     for row in _FONT.get(ch.upper(), _FONT["?"])],
                    bool).reshape(len(text), 7, 5)
    k, gy, gx = np.nonzero(bits)
    xs, ys = x + 6 * k + gx, y + gy
    _stamp(img, xs, ys, np.tile(np.asarray(color, np.uint8), (len(xs), 1)))


def draw_text_bar(image: np.ndarray, text: str, bar_h: int = 20
                  ) -> np.ndarray:
    """Append a black text bar below the image (reference DrawTextInfo,
    Viewer.cpp:370-408)."""
    h, w = image.shape[:2]
    out = np.zeros((h + bar_h, w, 3), np.uint8)
    out[:h] = image
    draw_text(out, 5, h + (bar_h - 7) // 2, text)
    return out
