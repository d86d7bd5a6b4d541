"""Convert the reference TorchScript PPG nets into a single .npz weight file
(a copy of ppg_slam_tpu/models/convert_weights.py).

The four TorchScript modules (net/{Backbone,PointHeatmap,
EdgeHeatmap,Descriptor}.pt — see SURVEY.md §2.1) are model *assets*; this tool
extracts their state dicts into the .npz layout both packages read
(the port's models/ppg_net.py load_params turns it back into a PPGNet
state_dict).

Layout conversions:
  * conv weights: torch OIHW -> HWIO
  * batch-norm (EdgeHeatmap blocks): kept as (gamma, beta, mean, var)

Usage:
    python -m ppg_slam_tpu_torch.models.convert_weights \
        --net-dir NET_DIR --out assets/ppg_weights.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _conv(sd, key):
    w = sd[f"{key}.weight"].numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    b = sd[f"{key}.bias"].numpy()
    return w.astype(np.float32), b.astype(np.float32)


def convert(net_dir: str) -> dict:
    import torch  # local import: offline tool only

    out: dict[str, np.ndarray] = {}

    bb = torch.jit.load(os.path.join(net_dir, "Backbone.pt"), map_location="cpu")
    sd = bb.state_dict()
    for name in ("conv1a", "conv1b", "conv2a", "conv2b",
                 "conv3a", "conv3b", "conv4a", "conv4b"):
        w, b = _conv(sd, name)
        out[f"backbone/{name}/w"] = w
        out[f"backbone/{name}/b"] = b

    ph = torch.jit.load(os.path.join(net_dir, "PointHeatmap.pt"), map_location="cpu")
    sd = ph.state_dict()
    for name in ("convPa", "convPb"):
        w, b = _conv(sd, name)
        out[f"junction/{name}/w"] = w
        out[f"junction/{name}/b"] = b

    ds = torch.jit.load(os.path.join(net_dir, "Descriptor.pt"), map_location="cpu")
    sd = ds.state_dict()
    for name in ("convDa", "convDb"):
        w, b = _conv(sd, name)
        out[f"descriptor/{name}/w"] = w
        out[f"descriptor/{name}/b"] = b

    eh = torch.jit.load(os.path.join(net_dir, "EdgeHeatmap.pt"), map_location="cpu")
    sd = eh.state_dict()
    for blk in range(3):
        w, b = _conv(sd, f"conv_block_lst.{blk}.0")
        out[f"heatmap/block{blk}/w"] = w
        out[f"heatmap/block{blk}/b"] = b
        for stat, suffix in (("gamma", "weight"), ("beta", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            out[f"heatmap/block{blk}/bn_{stat}"] = (
                sd[f"conv_block_lst.{blk}.1.{suffix}"].numpy().astype(np.float32)
            )
    w, b = _conv(sd, "conv_block_lst.3")
    out["heatmap/final/w"] = w
    out["heatmap/final/b"] = b
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net-dir", required=True,
                    help="folder of the reference's TorchScript nets")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "assets", "ppg_weights.npz"))
    args = ap.parse_args()
    weights = convert(args.net_dir)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **weights)
    n_params = sum(int(v.size) for v in weights.values())
    print(f"wrote {args.out}: {len(weights)} arrays, {n_params/1e3:.0f}k params")


if __name__ == "__main__":
    main()
