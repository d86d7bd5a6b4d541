"""train_vocabulary — offline DBoW3-compatible vocabulary builder, a port of
ppg_slam_tpu/cli/train_vocabulary.py.

The reference tool (trainBow.cpp:12-99) runs the PPG extractor over a
EuRoC-layout dataset (every 4th frame, CLAHE-equalized), collects per-image
descriptor matrices, and creates a DBoW3::Vocabulary(k, L, TF_IDF, L2_NORM)
saved as binary. Images are read with datasets/png.py and equalized with
datasets/clahe.py (OpenCV's CLAHE in numpy); the extractor runs on
`--device` (CUDA unless told otherwise).

Usage:
    python -m ppg_slam_tpu_torch.cli.train_vocabulary SETTINGS WEIGHTS \
        DATASET OUT [--k 9] [--L 3] [--every 4] [--max-images N] [--device D]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def collect_features(extractor, image_paths, every: int = 4,
                     max_images: int = 0) -> list:
    """Per-image descriptor matrices (trainBow.cpp getFeatures: every 4th
    frame, CLAHE 3.0/(8,8))."""
    from ..datasets import read_gray
    from ..datasets.clahe import clahe

    feats = []
    for i, path in enumerate(image_paths):
        if i % every != 0:
            continue
        if max_images and len(feats) >= max_images:
            break
        if not os.path.exists(path):  # cv2.imread's None: skipped
            continue
        img = clahe(read_gray(path), 3.0, (8, 8))
        f = extractor.extract(img)
        if f.n_kp:
            feats.append(np.asarray(f.descriptors, np.float32))
        print(f"{path}: {f.n_kp} keypoints", file=sys.stderr)
    return feats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="ppg_slam_tpu_torch.cli.train_vocabulary")
    ap.add_argument("settings")
    ap.add_argument("weights")
    ap.add_argument("dataset")
    ap.add_argument("out")
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--L", type=int, default=3)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the extractor on "
                         "(default cuda)")
    a = ap.parse_args(argv)

    from ..bow.train import create_vocabulary, save_vocabulary
    from ..datasets import load_euroc
    from ..frontend import PPGExtractor
    from ..pipeline.system import camera_from_settings, load_settings

    cam = camera_from_settings(load_settings(a.settings))
    extractor = PPGExtractor(cam, a.weights or None, device=a.device)
    images, _, _ = load_euroc(a.dataset)
    feats = collect_features(extractor, images, a.every, a.max_images)
    print(f"{len(feats)} images, "
          f"{sum(len(f) for f in feats)} descriptors", file=sys.stderr)
    voc = create_vocabulary(feats, k=a.k, L=a.L)
    save_vocabulary(voc, a.out)
    print(f"saved vocabulary with {voc.n_words} words to {a.out}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
