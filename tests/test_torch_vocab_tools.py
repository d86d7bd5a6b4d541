"""The port's offline tools against the JAX package's (and OpenCV's):

- `bow/train.py create_vocabulary` / `save_vocabulary`: bit-equal trees,
  weights and files;
- `datasets/clahe.py`: equal to `cv2.createCLAHE(clip, (8, 8)).apply`,
  every pixel (the padded sizes included);
- `cli/train_vocabulary.py` on a synthetic ASL folder on the CPU: its
  features equal the JAX tool's (same keypoint counts, descriptors within
  the extractor parity's 1e-5), and the file it writes is byte-equal to the
  JAX package's save_vocabulary of the JAX create_vocabulary of them;
- `models/convert_weights.py` on scripted stand-in modules carrying the
  reference's state-dict names: an .npz identical to the JAX converter's,
  which the port's load_params reads into a PPGNet that equals the JAX
  ppg_forward at 160x128 (tests/test_torch_ppg_net.py's tolerances);
- `ops/lines.py` against the JAX ops: the probe gate exactly, the
  validation's rates exactly and scores within 1e-6, the pair geometry
  within 1e-6.
"""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ppg_slam_tpu.bow import train as jtrain
from ppg_slam_tpu.cli import train_vocabulary as jtool
from ppg_slam_tpu.frontend import PPGExtractor as JExtractor
from ppg_slam_tpu.geometry.cameras import CameraModel as JCamera
from ppg_slam_tpu.models import convert_weights as jconvert
from ppg_slam_tpu.models import load_params as jload_params
from ppg_slam_tpu.models import ppg_forward
from ppg_slam_tpu.ops import lines as jlines

from ppg_slam_tpu_torch.bow import Vocabulary
from ppg_slam_tpu_torch.bow import train as ptrain
from ppg_slam_tpu_torch.cli import train_vocabulary as ptool
from ppg_slam_tpu_torch.datasets import write_png
from ppg_slam_tpu_torch.datasets.clahe import clahe
from ppg_slam_tpu_torch.frontend import PPGExtractor
from ppg_slam_tpu_torch.geometry.cameras import CAM_PINHOLE, CameraModel
from ppg_slam_tpu_torch.models import DEFAULT_WEIGHTS, load_net, load_params
from ppg_slam_tpu_torch.models import convert_weights as pconvert
from ppg_slam_tpu_torch.ops import lines as plines


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under a parallel test run, torch's intra-op pool only oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(n_images, n_clusters=24, per_image=40, seed=3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, 256).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    feats = []
    for _ in range(n_images):
        d = (centers[rng.randint(n_clusters, size=per_image)]
             + 0.05 * rng.randn(per_image, 256).astype(np.float32))
        feats.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    return feats


@pytest.mark.parametrize("k,L,seed", [(4, 3, 0), (3, 2, 7), (9, 2, 1)])
def test_create_vocabulary_bit_equal(tmp_path, k, L, seed):
    feats = _clustered(12)
    got = ptrain.create_vocabulary(feats, k=k, L=L, seed=seed)
    ref = jtrain.create_vocabulary(feats, k=k, L=L, seed=seed)
    for name in ("node_parent", "node_desc", "node_weight", "children",
                 "node_word"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    paths = [str(tmp_path / f"{s}.bin") for s in ("port", "jax")]
    ptrain.save_vocabulary(got, paths[0])
    jtrain.save_vocabulary(ref, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shape", [(480, 752), (61, 77), (128, 160),
                                   (100, 37), (64, 72)])
@pytest.mark.parametrize("clip", [3.0, 40.0, 0.5, 0.0])
def test_clahe_equals_cv2(shape, clip):
    rng = np.random.RandomState(shape[0] + shape[1])
    img = (rng.rand(*shape) ** 2 * 200
           + np.linspace(0, 55, shape[1])[None]).astype(np.uint8)
    ref = cv2.createCLAHE(clip, (8, 8)).apply(img)
    np.testing.assert_array_equal(clahe(img, clip, (8, 8)), ref)


# --------------------------------------------------------------------------
# cli/train_vocabulary.py
# --------------------------------------------------------------------------
SETTINGS = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 120.0
Camera.fy: 120.0
Camera.cx: 80.0
Camera.cy: 64.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 160
Camera.height: 128
Camera.fps: 20.0
"""
CAM = dict(kind=CAM_PINHOLE, fx=120.0, fy=120.0, cx=80.0, cy=64.0,
           dist=(0.0, 0.0, 0.0, 0.0), width=160, height=128)


@pytest.fixture(scope="module")
def asl_folder(tmp_path_factory):
    """12 frames of bars and a grid at 160x128 (every 4th one is used)."""
    root = tmp_path_factory.mktemp("asl")
    data = root / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    (root / "mav0" / "imu0").mkdir()
    (root / "mav0" / "imu0" / "data.csv").write_text("#t\n")
    rng = np.random.RandomState(11)
    base = np.full((128, 220), 100, np.int32)
    for k in range(1, 10):
        base[:, 19 * k + (k * k) % 7] = 40 + 20 * (k % 3)
    for k in range(1, 6):
        base[22 * k, :] = 235
    rows = []
    for i in range(12):
        img = base[:, 5 * i:5 * i + 160] + rng.randint(-10, 10, (128, 160))
        ns = 1000000000 + i * 50000000
        write_png(str(data / f"{ns}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))
        rows.append(f"{ns},{ns}.png")
    (root / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows) + "\n")
    (root / "settings.yaml").write_text(SETTINGS)
    return root


def test_train_vocabulary_equals_reference(asl_folder, tmp_path):
    from ppg_slam_tpu.datasets import load_euroc

    images, _, _ = load_euroc(str(asl_folder))
    got = ptool.collect_features(
        PPGExtractor(CameraModel(**CAM), device="cpu"), images)
    ref = jtool.collect_features(JExtractor(JCamera(**CAM)), images)
    assert [len(f) for f in got] == [len(f) for f in ref]
    assert len(got) == 3 and min(len(f) for f in got) > 10
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    out = str(tmp_path / "voc.bin")
    ptool.main([str(asl_folder / "settings.yaml"), "", str(asl_folder), out,
                "--k", "4", "--L", "2", "--device", "cpu"])
    jpath = str(tmp_path / "voc_jax.bin")
    jtrain.save_vocabulary(jtrain.create_vocabulary(got, k=4, L=2), jpath)
    with open(out, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    voc = Vocabulary.load(out)
    assert voc.k == 4 and voc.L == 2 and voc.n_words > 4
    bow, _ = voc.transform(got[0])
    assert bow and voc.score(bow, bow) == pytest.approx(1.0, abs=1e-6)


# --------------------------------------------------------------------------
# models/convert_weights.py
# --------------------------------------------------------------------------
class _Stand(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _conv(w_hwio, b):
    kh, kw, cin, cout = w_hwio.shape
    c = torch.nn.Conv2d(cin, cout, (kh, kw), padding=kh // 2)
    with torch.no_grad():
        c.weight.copy_(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1)))
        c.bias.copy_(torch.from_numpy(b))
    return c


@pytest.fixture(scope="module")
def net_dir(tmp_path_factory):
    """The four TorchScript nets with the reference's state-dict names
    (convert_weights.py:35-70), holding the repository's weights with
    seeded noise."""
    d = tmp_path_factory.mktemp("net")
    rng = np.random.RandomState(21)
    with np.load(DEFAULT_WEIGHTS) as f:
        flat = {k: (f[k] * (1 + 0.05 * np.abs(rng.randn(*f[k].shape))))
                .astype(np.float32) for k in f.files}
    mods = {"Backbone": ("backbone", ["conv1a", "conv1b", "conv2a", "conv2b",
                                      "conv3a", "conv3b", "conv4a",
                                      "conv4b"]),
            "PointHeatmap": ("junction", ["convPa", "convPb"]),
            "Descriptor": ("descriptor", ["convDa", "convDb"])}
    for name, (head, layers) in mods.items():
        m = _Stand()
        for layer in layers:
            setattr(m, layer, _conv(flat[f"{head}/{layer}/w"],
                                    flat[f"{head}/{layer}/b"]))
        torch.jit.script(m).save(str(d / f"{name}.pt"))
    blocks = []
    for blk in range(3):
        p = f"heatmap/block{blk}/"
        bn = torch.nn.BatchNorm2d(flat[p + "b"].shape[0])
        with torch.no_grad():
            for stat, attr in (("gamma", "weight"), ("beta", "bias"),
                               ("mean", "running_mean"),
                               ("var", "running_var")):
                getattr(bn, attr).copy_(torch.from_numpy(flat[p + "bn_"
                                                              + stat]))
        blocks.append(torch.nn.Sequential(_conv(flat[p + "w"], flat[p + "b"]),
                                          bn))
    blocks.append(_conv(flat["heatmap/final/w"], flat["heatmap/final/b"]))
    eh = _Stand()
    eh.conv_block_lst = torch.nn.ModuleList(blocks)
    torch.jit.script(eh).save(str(d / "EdgeHeatmap.pt"))
    return str(d)


def test_convert_weights_equals_reference(net_dir, tmp_path):
    got, ref = pconvert.convert(net_dir), jconvert.convert(net_dir)
    assert sorted(got) == sorted(ref) and len(got) == 44
    for key in got:
        assert got[key].dtype == ref[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    path = str(tmp_path / "w.npz")
    np.savez(path, **got)

    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[0:128, 0:160]
    img = np.clip(rng.rand(128, 160) * 0.5 + 0.3 * np.sin(xx / 7.0)
                  * np.cos(yy / 9.0) + 0.2, 0, 1).astype(np.float32)
    oracle = ppg_forward(jload_params(path), jnp.asarray(img[None, :, :,
                                                             None]))
    net = load_net(path, device="cpu")
    sd = load_params(path)
    assert all(torch.equal(net.state_dict()[k], v) for k, v in sd.items())
    with torch.inference_mode():
        out = net(torch.from_numpy(img)[None, None])
    np.testing.assert_allclose(out["junc_prob"][0].numpy(),
                               np.asarray(oracle["junc_prob"])[0], atol=1e-5)
    np.testing.assert_allclose(out["heat"][0].numpy(),
                               np.asarray(oracle["heat"])[0], atol=1e-5)
    np.testing.assert_allclose(out["desc"][0].permute(1, 2, 0).numpy(),
                               np.asarray(oracle["desc"])[0], atol=1e-3,
                               rtol=1e-3)


# --------------------------------------------------------------------------
# ops/lines.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def line_inputs():
    rng = np.random.RandomState(13)
    h, w = 96, 128
    heat = (rng.rand(h, w) * 0.15).astype(np.float32)
    for y0, x0, y1, x1 in ((10, 5, 80, 100), (50, 10, 52, 120),
                           (5, 60, 90, 64)):
        n = 400
        ys = np.linspace(y0, y1, n).round().astype(int)
        xs = np.linspace(x0, x1, n).round().astype(int)
        heat[ys, xs] = 0.9
    kp = np.concatenate([
        np.array([[5, 10], [100, 80], [10, 50], [120, 52], [60, 5],
                  [64, 90], [32, 30], [82, 51]], np.float32),
        rng.rand(24, 2).astype(np.float32) * [w - 1, h - 1]])
    ok = rng.rand(len(kp)) > 0.1
    ok[:8] = True
    return heat, kp, ok


def test_pair_probe_mask_equals_reference(line_inputs):
    heat, kp, ok = line_inputs
    got = plines.pair_probe_mask(torch.from_numpy(heat), torch.from_numpy(kp),
                                 torch.from_numpy(ok)).numpy()
    ref = np.asarray(jlines.pair_probe_mask(jnp.asarray(heat),
                                            jnp.asarray(kp), jnp.asarray(ok)))
    np.testing.assert_array_equal(got, ref)
    assert 4 <= got.sum() < got.size // 4


def test_validate_edges_equals_reference(line_inputs):
    heat, kp, ok = line_inputs
    i, j = np.triu_indices(len(kp), 1)
    cand_ok = ok[i] & ok[j]
    args = (heat, kp[i], kp[j], cand_ok)
    rate, score = plines.validate_edges(*(torch.from_numpy(a) for a in args))
    jrate, jscore = jlines.validate_edges(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(rate.numpy(), np.asarray(jrate))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), atol=1e-6,
                               rtol=0)
    assert (rate.numpy() >= 0.8).sum() >= 3


def test_pair_geometry_equals_reference(line_inputs):
    _, kp, _ = line_inputs
    dist, ang = plines.pair_geometry(torch.from_numpy(kp))
    jdist, jang = jlines.pair_geometry(jnp.asarray(kp))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), atol=1e-6,
                               rtol=0)
