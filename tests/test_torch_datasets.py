"""The port's dataset layer against the JAX package and OpenCV.

- `datasets/loaders.py`: image lists, stamps and IMU rows bit-equal to the
  JAX loaders' on EuRoC and UMA folders written here (and UMA's mav0/
  fallback).
- `datasets/png.py read_gray`: equal to `cv2.imread(path,
  cv2.IMREAD_GRAYSCALE)` (exact, every pixel) on PNGs that OpenCV writes
  (8- and 16-bit grey, RGB, RGBA, each scanline filter and the adaptive
  mix) and on grey+alpha PNGs written here with each filter; PNGs it does
  not decode raise ValueError naming the file. `write_png` round-trips
  through cv2 exactly.
- `datasets/clahe.py`: equal to `cv2.createCLAHE(clip, (8, 8)).apply`
  (exact) is in tests/test_torch_vocab_tools.py.
- `cli/evaluate.py`: the same output as the JAX CLI on the same files.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from ppg_slam_tpu.cli import evaluate as jevaluate
from ppg_slam_tpu.datasets import loaders as jloaders

from ppg_slam_tpu_torch.cli import evaluate as pevaluate
from ppg_slam_tpu_torch.datasets import loaders as ploaders
from ppg_slam_tpu_torch.datasets.png import read_gray, write_png

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}


def _asl_folder(root, prefix, n_img=7, n_imu=40, seed=0):
    """An ASL-layout folder under root/prefix: cam0/data.csv (+ comment and
    blank lines) and imu0/data.csv with nanosecond stamps."""
    rng = np.random.RandomState(seed)
    base = root / prefix if prefix else root
    (base / "cam0" / "data").mkdir(parents=True)
    (base / "imu0").mkdir(parents=True)
    stamps = 1403636579763555584 + np.arange(n_img) * 50000000
    (base / "cam0" / "data.csv").write_text(
        "#timestamp [ns],filename\n\n"
        + "".join(f"{s},{s}.png\n" for s in stamps))
    t = stamps[0] - 10000000 + np.arange(n_imu) * 5000000
    rows = rng.randn(n_imu, 6) * [0.1, 0.1, 0.1, 1.0, 1.0, 9.8]
    (base / "imu0" / "data.csv").write_text(
        "#timestamp [ns],w_RS_S_x [rad s^-1],...\n"
        + "".join(f"{s}," + ",".join(repr(float(v)) for v in r) + "\n"
                  for s, r in zip(t, rows)))
    return root


@pytest.mark.parametrize("kind,prefix", [("euroc", "mav0"),
                                         ("tumvi", "mav0"),
                                         ("uma", ""),
                                         ("uma", "mav0")])
def test_loaders_bit_equal(tmp_path, kind, prefix):
    folder = str(_asl_folder(tmp_path, prefix))
    got = getattr(ploaders, f"load_{kind}")(folder)
    ref = getattr(jloaders, f"load_{kind}")(folder)
    assert got[0] == ref[0] and len(got[0]) == 7
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (40, 7)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------
def _images():
    rng = np.random.RandomState(5)
    smooth = (np.add.outer(np.arange(45), np.arange(67)) * 2).astype(np.uint8)
    g8 = (smooth // 2 + rng.randint(0, 128, smooth.shape)).astype(np.uint8)
    return {
        "g8": g8,
        "g16": (rng.randint(0, 65536, (45, 67))
                | np.uint16(0x7F)).astype(np.uint16),
        "rgb": rng.randint(0, 256, (45, 67, 3)).astype(np.uint8),
        "rgb_greys": np.repeat(g8[..., None], 3, axis=2),
        "rgba": rng.randint(0, 256, (45, 67, 4)).astype(np.uint8),
    }


@pytest.mark.parametrize("flt", sorted(FILTERS))
@pytest.mark.parametrize("name", ["g8", "g16", "rgb", "rgb_greys", "rgba"])
def test_read_gray_equals_cv2(tmp_path, name, flt):
    path = str(tmp_path / f"{name}_{flt}.png")
    assert cv2.imwrite(path, _images()[name],
                       [cv2.IMWRITE_PNG_FILTER, FILTERS[flt]])
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    got = read_gray(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (45, 67)
    np.testing.assert_array_equal(got, ref)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(px, ctype, filters=(0,), interlace=0, palette=None):
    """An 8-bit PNG of (H, W, bpp) bytes with the given per-row filter
    types (cycled), written by hand; for the cases OpenCV does not
    write."""
    h, w, bpp = px.shape
    x = px.astype(np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        a = np.zeros_like(x[y])
        a[1:] = x[y][:-1]
        b = x[y - 1] if y else np.zeros_like(x[y])
        c = np.zeros_like(x[y])
        if y:
            c[1:] = x[y - 1][:-1]
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f]
        rows.append(bytes([f]) + ((x[y] - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette)
    return (out + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_read_gray_grey_alpha_equals_cv2(tmp_path, filters):
    rng = np.random.RandomState(9)
    px = rng.randint(0, 256, (33, 41, 2)).astype(np.uint8)
    path = str(tmp_path / "ga.png")
    with open(path, "wb") as f:
        f.write(_encode(px, 4, filters=filters))
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(read_gray(path), ref)
    np.testing.assert_array_equal(ref, px[..., 0])


@pytest.mark.parametrize("case", ["palette", "interlaced", "bilevel",
                                  "rgb16", "not_png"])
def test_read_gray_rejects_what_it_does_not_decode(tmp_path, case):
    path = str(tmp_path / f"{case}.png")
    px = np.random.RandomState(2).randint(0, 4, (8, 16, 1)).astype(np.uint8)
    if case == "palette":
        data = _encode(px, 3, palette=bytes(range(12)))
    elif case == "interlaced":
        data = _encode(px, 0, interlace=1)
    elif case == "bilevel":
        cv2.imwrite(path, (px[..., 0] > 1).astype(np.uint8) * 255,
                    [cv2.IMWRITE_PNG_BILEVEL, 1])
        data = None
    elif case == "rgb16":
        cv2.imwrite(path, np.zeros((8, 16, 3), np.uint16))
        data = None
    else:
        data = b"GIF89a" + bytes(20)
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=f"{case}.png"):
        read_gray(path)


@pytest.mark.parametrize("name", ["g8", "rgb"])
def test_write_png_round_trips_through_cv2(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / f"w_{name}.png")
    write_png(path, img)
    if img.ndim == 2:
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)
    else:
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], img)
    np.testing.assert_array_equal(read_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))


# --------------------------------------------------------------------------
# cli/evaluate.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tum_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("tum")
    rng = np.random.RandomState(3)
    t = 10.0 + np.arange(120) * 0.05
    gt = np.cumsum(rng.randn(120, 3) * 0.02, axis=0)
    est = 1.7 * gt + 0.01 * rng.randn(120, 3) + [0.3, -0.1, 2.0]
    q = np.tile([0.0, 0.0, 0.0, 1.0], (120, 1))
    for name, p, tt in (("est.txt", est, t + 0.003),
                        ("gt.txt", gt, t)):
        np.savetxt(str(d / name), np.column_stack([tt, p, q]), fmt="%.9f")
    return str(d / "est.txt"), str(d / "gt.txt")


@pytest.mark.parametrize("flags", [[], ["--json"], ["--no-scale"],
                                   ["--json", "--rpe", "1.0"],
                                   ["--rpe", "0.5", "--max-diff", "0.01"]])
def test_evaluate_cli_equals_reference(tum_pair, capsys, flags):
    out = {}
    for side, mod in (("jax", jevaluate), ("port", pevaluate)):
        assert mod.main(list(tum_pair) + flags) == 0
        out[side] = capsys.readouterr().out
    assert out["port"] == out["jax"] and out["port"]
    if "--json" in flags:
        assert json.loads(out["port"])["pairs"] == 120
