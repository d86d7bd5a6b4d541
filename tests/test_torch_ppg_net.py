"""Port parity: ppg_slam_tpu_torch.models.PPGNet against the JAX ppg_forward
(the TorchScript goldens of tests/test_ppg_net.py are not bundled, so the
JAX model is the oracle), with that file's tolerances."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ppg_slam_tpu.models import load_params as jax_load_params
from ppg_slam_tpu.models import ppg_forward

from ppg_slam_tpu_torch.models import (DEFAULT_WEIGHTS, PPGNet, load_net,
                                       load_params, params_from_jax)


@pytest.fixture(scope="module")
def jax_params():
    return jax_load_params()


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(7)
    h, w = 128, 160
    img = rng.rand(h, w).astype(np.float32) * 0.5
    yy, xx = np.mgrid[0:h, 0:w]
    img += 0.3 * np.sin(xx / 7.0) * np.cos(yy / 9.0) + 0.2
    return np.clip(img, 0, 1).astype(np.float32)


def _forward(net, img):
    with torch.inference_mode():
        out = net(torch.from_numpy(img)[None, None])
    return {"junc_prob": out["junc_prob"][0].numpy(),
            "heat": out["heat"][0].numpy(),
            "desc": out["desc"][0].permute(1, 2, 0).numpy()}


def test_params_from_jax_round_trip():
    with np.load(DEFAULT_WEIGHTS) as f:
        flat = {k: f[k] for k in f.files}
    assert len(flat) == 44
    sd = params_from_jax(flat)
    net = PPGNet()
    net.load_state_dict(sd)  # strict: every module parameter is mapped
    state = net.state_dict()
    for key, arr in flat.items():
        head, layer, leaf = key.split("/")
        if head == "heatmap" and layer != "final":
            name = {"w": "conv.weight", "b": "conv.bias", "bn_gamma": "bn.weight",
                    "bn_beta": "bn.bias", "bn_mean": "bn.running_mean",
                    "bn_var": "bn.running_var"}[leaf]
        else:
            name = {"w": "weight", "b": "bias"}[leaf]
        back = state[f"{head}.{layer}.{name}"].numpy()
        if leaf == "w":
            back = back.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        np.testing.assert_array_equal(back, arr, err_msg=key)
    lp = load_params()
    assert sorted(lp) == sorted(sd)


def test_forward_matches_jax(jax_params, image):
    ref = ppg_forward(jax_params, jnp.asarray(image[None, :, :, None]))
    got = _forward(load_net(device="cpu"), image)
    np.testing.assert_allclose(got["junc_prob"], np.asarray(ref["junc_prob"])[0],
                               atol=1e-5)
    np.testing.assert_allclose(got["heat"], np.asarray(ref["heat"])[0], atol=1e-5)
    np.testing.assert_allclose(got["desc"], np.asarray(ref["desc"])[0],
                               atol=1e-3, rtol=1e-3)


def test_forward_shapes():
    net = load_net(device="cpu")
    with torch.inference_mode():
        out = net(torch.zeros(1, 1, 480, 752))
    assert out["junc_prob"].shape == (1, 480, 752)
    assert out["heat"].shape == (1, 480, 752)
    assert out["desc"].shape == (1, 256, 60, 94)
    assert all(v.dtype == torch.float32 for v in out.values())


def test_bf16_forward_matches_jax_bf16(jax_params, image):
    """bf16 weights and activations round at other places than the
    reference's (PyTorch rounds each conv output to bf16 before the f32
    bias; the reference keeps its f32 accumulator), so the two bf16 nets
    differ by as much as bf16 differs from f32 (measured on this image:
    junc 4.9e-4, heat 1.0e-2, desc 1.4% of its largest value; the
    reference's own bf16 - f32: 3.9e-4, 8.0e-3, 1.6%). Bounds: junc 2e-3,
    heat 4e-2, desc 4% of max |desc| (1% in the mean)."""
    ref = ppg_forward(jax_params, jnp.asarray(image[None, :, :, None]),
                      dtype=jnp.bfloat16)
    ref32 = ppg_forward(jax_params, jnp.asarray(image[None, :, :, None]))
    net = load_net(compute_dtype="bf16", device="cpu")
    assert net.backbone["conv1a"].weight.dtype == torch.bfloat16
    got = _forward(net, image)
    for oracle in (ref, ref32):
        np.testing.assert_allclose(got["junc_prob"],
                                   np.asarray(oracle["junc_prob"])[0], atol=2e-3)
        np.testing.assert_allclose(got["heat"], np.asarray(oracle["heat"])[0],
                                   atol=4e-2)
        d_ref = np.asarray(oracle["desc"])[0]
        err = np.abs(got["desc"] - d_ref)
        scale = np.abs(d_ref).max()
        assert err.max() < 0.04 * scale, err.max() / scale
        assert err.mean() < 0.01 * scale, err.mean() / scale


def test_load_net_defaults_to_cuda():
    """load_net, like PPGExtractor, runs on CUDA unless the caller names a
    device, and raises where there is none."""
    if torch.cuda.is_available():
        assert next(load_net().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_net()
    assert next(load_net(device="cpu").parameters()).device.type == "cpu"
