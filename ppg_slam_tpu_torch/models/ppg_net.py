"""The PPG front-end CNNs as one NCHW PyTorch module.

Port of ppg_slam_tpu/models/ppg_net.py: the shared VGG backbone runs once and
feeds three heads.

  * junction: convPa(3x3,128->256)+ReLU, convPb(1x1,256->65); decoded as
    softmax(channel)[:64] then pixel_shuffle(8) -> full-res junction prob.
  * heatmap: 3x [conv3x3 + BN + ReLU -> pixel_shuffle(2)] + 1x1 conv(4->2);
    decoded as softmax(channel)[1] -> full-res line heat.
  * descriptor: convDa(3x3,128->256)+ReLU, convDb(1x1,256->256) -> raw
    semi-dense 256-d descriptors at 1/8 resolution.

compute_dtype="bf16" stores conv weights and inter-layer activations in bf16
(the serving configuration); biases, batch norm and the head outputs stay f32,
as in the reference's `_conv`/`_act`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

BN_EPS = 1e-5  # torch BatchNorm2d default

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "ppg_weights.npz",
)

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def _conv1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


class _HeatBlock(nn.Module):
    """conv3x3 + eval-mode batch norm (the weight file's bn_* statistics)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv3(cin, cout)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)


class PPGNet(nn.Module):
    """Backbone + junction / heatmap / descriptor heads, NCHW.

    forward(image) takes (N, 1, H, W) f32 in [0, 1] with H, W multiples of 8
    and returns dict(junc_prob (N, H, W), heat (N, H, W),
    desc (N, 256, H/8, W/8)), all f32."""

    def __init__(self, compute_dtype: str = "f32"):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        self.dtype = _DTYPES[compute_dtype]
        self.backbone = nn.ModuleDict({
            "conv1a": _conv3(1, 64), "conv1b": _conv3(64, 64),
            "conv2a": _conv3(64, 64), "conv2b": _conv3(64, 64),
            "conv3a": _conv3(64, 128), "conv3b": _conv3(128, 128),
            "conv4a": _conv3(128, 128), "conv4b": _conv3(128, 128),
        })
        self.junction = nn.ModuleDict({
            "convPa": _conv3(128, 256), "convPb": _conv1(256, 65)})
        self.descriptor = nn.ModuleDict({
            "convDa": _conv3(128, 256), "convDb": _conv1(256, 256)})
        self.heatmap = nn.ModuleDict({
            "block0": _HeatBlock(128, 256), "block1": _HeatBlock(64, 64),
            "block2": _HeatBlock(16, 16), "final": _conv1(4, 2)})
        self.eval()
        if self.dtype != torch.float32:
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.data = m.weight.data.to(self.dtype)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """Conv with an f32 result; in bf16 the bias is added in f32 after
        the bf16 conv (the reference adds it to the f32 accumulator)."""
        if self.dtype == torch.float32:
            return F.conv2d(x, conv.weight, conv.bias, padding=conv.padding)
        y = F.conv2d(x.to(self.dtype), conv.weight, None, padding=conv.padding)
        return y.float() + conv.bias[:, None, None]

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x).to(self.dtype)

    def backbone_features(self, x: torch.Tensor) -> torch.Tensor:
        b = self.backbone
        x = x.to(self.dtype)
        for stage in ("1", "2", "3", "4"):
            x = self._act(self._conv(b[f"conv{stage}a"], x))
            x = self._act(self._conv(b[f"conv{stage}b"], x))
            if stage != "4":
                x = F.max_pool2d(x, 2)
        return x

    def junction_logits(self, feat: torch.Tensor) -> torch.Tensor:
        j = self.junction
        return self._conv(j["convPb"], self._act(self._conv(j["convPa"], feat)))

    def descriptor_map(self, feat: torch.Tensor) -> torch.Tensor:
        d = self.descriptor
        return self._conv(d["convDb"], self._act(self._conv(d["convDa"], feat)))

    def heat_logits(self, feat: torch.Tensor) -> torch.Tensor:
        x = feat
        for name in ("block0", "block1", "block2"):
            blk = self.heatmap[name]
            x = self._act(blk.bn(self._conv(blk.conv, x)))
            x = F.pixel_shuffle(x, 2)
        return self._conv(self.heatmap["final"], x)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.backbone_features(image)
        junc = torch.softmax(self.junction_logits(feat), dim=1)
        junc_prob = F.pixel_shuffle(junc[:, :64], 8)[:, 0]
        heat = torch.softmax(self.heat_logits(feat), dim=1)[:, 1]
        return {"junc_prob": junc_prob, "heat": heat,
                "desc": self.descriptor_map(feat)}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map the JAX parameter file's flat keys ("backbone/conv1a/w", ...) to a
    PPGNet state_dict. Conv weights go HWIO -> OIHW."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        head, layer, leaf = key.split("/")
        arr = np.asarray(arr, np.float32)
        if head == "heatmap" and layer != "final":
            prefix = f"heatmap.{layer}"
            name = {"w": "conv.weight", "b": "conv.bias",
                    "bn_gamma": "bn.weight", "bn_beta": "bn.bias",
                    "bn_mean": "bn.running_mean",
                    "bn_var": "bn.running_var"}[leaf]
        else:
            prefix = f"{head}.{layer}"
            name = {"w": "weight", "b": "bias"}[leaf]
        if leaf == "w":
            arr = arr.transpose(3, 2, 0, 1)
        sd[f"{prefix}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    for blk in ("block0", "block1", "block2"):
        sd[f"heatmap.{blk}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def load_params(path: str = DEFAULT_WEIGHTS) -> Dict[str, torch.Tensor]:
    """Read the npz weight file into a PPGNet state_dict."""
    with np.load(path) as flat:
        return params_from_jax({k: flat[k] for k in flat.files})


def load_net(path: str = DEFAULT_WEIGHTS, compute_dtype: str = "f32",
             device=None) -> PPGNet:
    """A PPGNet with the weight file's parameters, on `device` (default
    CUDA; raises where no CUDA device is present)."""
    dev = resolve_device(device)
    net = PPGNet(compute_dtype)
    net.load_state_dict(load_params(path))
    return net.to(dev)
