"""The plain reference of the front-end, and the numbers that judge it.

The PPG nets (a VGG backbone, then the junction and descriptor heads; the
line-heat head is not judged) written out with plain torch.nn.functional
calls from the weight file
`assets/ppg_weights.npz` (flat keys "backbone/conv1a/w", HWIO conv weights),
computed in float32 with TF32 off; the keypoints by the reference's greedy
NMS as a sequential scan (PPGExtractor.cpp:158-206: every junction pixel at
or above 1/128 and 4 px inside the border, by score then flat index,
accepted unless within 4 px of one accepted before, at most 500); the
descriptors by grid_sample at the keypoints, L2-normalized
(PPGExtractor.cpp:515-538).

`int8=True` computes the same nets with every conv's weights (per output
channel) and input (per tensor) rounded to symmetric int8: the precision
below the bf16 the configurations serve the nets in, and the control that
the comparison has to fail (slam_bench/tests/test_control.py).

Imports neither jax, ppg_slam_tpu nor anything of ppg_slam_tpu_torch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

JUNCTION_THRESH = 1.0 / 128.0
NMS_RADIUS = 4
MAX_KEYPOINTS = 500
MATCH_PX = 0.05  # a program keypoint is the reference's within this


def load_weights(path: str, device) -> dict:
    """The weight file as {key: f32 tensor}, conv weights OIHW."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.endswith("/w"):
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def _q8(x: torch.Tensor, dims) -> torch.Tensor:
    """Symmetric int8 rounding of x, one scale over `dims`."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12)
    scale = amax / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


class Nets:
    def __init__(self, weights: dict, int8: bool = False):
        self.w = weights
        self.int8 = int8

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.w[name + "/w"], self.w[name + "/b"]
        if self.int8:
            w = _q8(w, (1, 2, 3))
            x = _q8(x, (0, 1, 2, 3))
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def forward(self, image_u8: torch.Tensor) -> dict:
        """(H, W) uint8 -> junc (H, W), desc (256, H/8, W/8)."""
        prev_mm = torch.backends.cuda.matmul.allow_tf32
        prev_dnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return self._forward(image_u8)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev_mm
            torch.backends.cudnn.allow_tf32 = prev_dnn

    def _forward(self, image_u8):
        x = image_u8.to(torch.float32)[None, None] / 255.0
        for stage in "1234":
            x = F.relu(self.conv(f"backbone/conv{stage}a", x))
            x = F.relu(self.conv(f"backbone/conv{stage}b", x))
            if stage != "4":
                x = F.max_pool2d(x, 2)
        feat = x
        j = self.conv("junction/convPb",
                      F.relu(self.conv("junction/convPa", feat)))
        junc = F.pixel_shuffle(torch.softmax(j, 1)[:, :64], 8)[0, 0]
        desc = self.conv("descriptor/convDb",
                         F.relu(self.conv("descriptor/convDa", feat)))[0]
        return {"junc": junc, "desc": desc}


def greedy_nms(junc: np.ndarray) -> np.ndarray:
    """(K, 2) int (x, y) keypoints of a junction map, in acceptance order."""
    h, w = junc.shape
    r = NMS_RADIUS
    ys, xs = np.nonzero(junc >= JUNCTION_THRESH)
    inside = (xs >= r) & (xs <= w - r - 1) & (ys >= r) & (ys <= h - r - 1)
    ys, xs = ys[inside], xs[inside]
    flat = ys * w + xs
    order = np.lexsort((flat, -junc[ys, xs].astype(np.float64)))
    taken = np.zeros((h + 2 * r, w + 2 * r), bool)
    out = []
    for i in order:
        x, y = int(xs[i]), int(ys[i])
        if taken[y + r, x + r]:
            continue
        out.append((x, y))
        if len(out) == MAX_KEYPOINTS:
            break
        taken[y:y + 2 * r + 1, x:x + 2 * r + 1] = True
    return np.asarray(out, np.int64).reshape(-1, 2)


def sample_descriptors(desc: torch.Tensor, xy: np.ndarray, width: int,
                       height: int) -> torch.Tensor:
    """(K, 256) L2-normalized descriptors at full-image pixels xy."""
    g = torch.as_tensor(xy, dtype=torch.float32, device=desc.device)
    grid = torch.stack([g[:, 0] / width * 2.0 - 1.0,
                        g[:, 1] / height * 2.0 - 1.0], -1)[None, None]
    d = F.grid_sample(desc[None], grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)[0, :, 0].T
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp(
        min=1e-12)


def compare(ref: dict, ref_xy: np.ndarray, ref_pos: np.ndarray,
            pos: np.ndarray, score: np.ndarray, desc: torch.Tensor) -> dict:
    """One frame held against the reference: the junction scores of the
    reference's keypoints (weight) and which of them the judged side has a
    keypoint at (hit), and over the keypoints both have, the absolute
    differences of junction score and the L2 distances of descriptors.
    ref_pos: the reference's keypoints where the judged side reports
    positions (undistorted on a radtan camera); pos, score, desc: the judged
    side's keypoints, scores and descriptors (a tensor). `pooled` turns a
    sample of these into the numbers compared."""
    junc = ref["junc"].cpu().numpy()
    weight = junc[ref_xy[:, 1], ref_xy[:, 0]].astype(np.float64)
    out = dict(weight=weight, hit=np.zeros(len(ref_xy), bool),
               score_diff=np.zeros(0), desc_dist=np.zeros(0))
    if len(ref_xy) == 0 or len(pos) == 0:
        return out
    d = np.abs(ref_pos[:, None, :].astype(np.float64)
               - pos[None, :, :].astype(np.float64)).max(-1)
    j = d.argmin(1)
    hit = d[np.arange(len(ref_xy)), j] < MATCH_PX
    out["hit"] = hit
    if hit.any():
        ri, pj = np.nonzero(hit)[0], j[hit]
        out["score_diff"] = np.abs(score[pj].astype(np.float64) - weight[ri])
        h, w = junc.shape
        rd = sample_descriptors(ref["desc"], ref_xy[ri], w, h)
        pd = desc[torch.as_tensor(pj, device=desc.device)].to(rd.device,
                                                              torch.float32)
        out["desc_dist"] = torch.linalg.vector_norm(
            pd - rd, dim=-1).double().cpu().numpy()
    return out


def pooled(frames: list) -> dict:
    """The front-end numbers over a sample of frames (each `compare`'s
    output). kp_miss: the reference's keypoints that the judged side has
    no keypoint at, as a share of all of them weighted by their junction
    scores (a swap of two weak keypoints at the 500 cap or the threshold
    weighs little); score_gap and desc_gap: the mean absolute score
    difference and the mean descriptor distance over every keypoint both
    have (inf where there is none)."""
    w = np.concatenate([f["weight"] for f in frames]) if frames else \
        np.zeros(0)
    hit = np.concatenate([f["hit"] for f in frames]) if frames else \
        np.zeros(0, bool)
    sd = np.concatenate([f["score_diff"] for f in frames]) if frames else \
        np.zeros(0)
    dd = np.concatenate([f["desc_dist"] for f in frames]) if frames else \
        np.zeros(0)
    return dict(
        kp_miss=float((w * ~hit).sum() / w.sum()) if w.sum() > 0 else 0.0,
        score_gap=float(sd.mean()) if len(sd) else float("inf"),
        desc_gap=float(dd.mean()) if len(dd) else float("inf"))


def control_side(ref8: dict, undistort) -> tuple:
    """The int8 control in the program's place: its keypoints (positions as
    the program reports them), scores and descriptors."""
    xy = greedy_nms(ref8["junc"].cpu().numpy())
    h, w = ref8["junc"].shape
    pos = undistort(xy)
    score = ref8["junc"].cpu().numpy()[xy[:, 1], xy[:, 0]] if len(xy) \
        else np.zeros(0, np.float32)
    desc = sample_descriptors(ref8["desc"], xy, w, h)
    return pos, score, desc
