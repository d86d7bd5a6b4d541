"""DBoW3-compatible vocabulary: binary .gz loading, transform, scoring
(a copy of ppg_slam_tpu/bow/vocabulary.py).

Reads the reference's shipped vocabularies (Vocabulary/voc_*_9x3.gz — DBoW3
binary format: magic 88877711233, u32 node count, u32 chunk count, QuickLZ
chunks; node records = (id u32, parent u32, weight f64, cv::Mat hdr
(cols,rows,type), 256 f32) in DFS order; trailer = u32 n_words + (word_id,
node_id) pairs).

Vocabulary parameters of the shipped files: k=9, L=3, TF_IDF weighting,
L2_NORM scoring (matches trainBow.cpp:89). The reference transforms with
levelsup=4 > L (Frame.cpp:338), which makes every FeatureVector degenerate to
{root: all indices} — BoW-guided matching is effectively exhaustive; we
reproduce that exactly.

The per-frame transform is vectorized: tree descent for all descriptors at
once as three argmin-of-distance steps (MXU matmuls when run on device; tiny
numpy here).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from . import quicklz

MAGIC = 88877711233


class Vocabulary:
    def __init__(self, node_parent, node_weight, node_desc, children,
                 node_word, k: int, L: int, scoring: int, weighting: int):
        self.k = k
        self.L = L
        self.scoring = scoring      # 1 = L2_NORM
        self.weighting = weighting  # 0 = TF_IDF
        self.node_parent = node_parent
        self.node_weight = node_weight      # (n_nodes,) idf weights
        self.node_desc = node_desc          # (n_nodes, 256) float32
        self.children = children            # (n_nodes, k) int32, -1 = none
        self.node_word = node_word          # (n_nodes,) word id or -1
        self.n_words = int((node_word >= 0).sum())

    # ------------------------------------------------------------------
    def save_npz(self, path: str) -> None:
        """Write the converted-vocabulary asset format (self-contained
        runtime: assets/*.npz, like the net weights)."""
        np.savez_compressed(
            path, parent=self.node_parent, weight=self.node_weight,
            desc=self.node_desc, children=self.children,
            word=self.node_word,
            meta=np.asarray([self.k, self.L, self.scoring, self.weighting],
                            np.int32))

    @staticmethod
    def load(path: str) -> "Vocabulary":
        raw = open(path, "rb").read()
        if raw[:2] == b"PK":  # npz (zip) — the converted asset format
            z = np.load(path)
            k, L, scoring, weighting = (int(v) for v in z["meta"])
            return Vocabulary(z["parent"], z["weight"],
                              z["desc"].astype(np.float32),
                              z["children"], z["word"], k, L, scoring,
                              weighting)
        sig, = struct.unpack_from("<Q", raw, 0)
        if sig != MAGIC:
            raise ValueError(f"not a DBoW3 binary vocabulary: {path}")
        compressed = raw[8]
        nnodes, = struct.unpack_from("<I", raw, 9)
        off = 13
        if compressed:
            nchunks, = struct.unpack_from("<I", raw, off)
            off += 4
            chunks = []
            for _ in range(nchunks):
                csz = quicklz.size_compressed(raw[off:off + 9])
                chunks.append(quicklz.decompress(raw[off:off + csz]))
                off += csz
            data = b"".join(chunks)
        else:
            data = raw[off:]

        k, L, scoring, weighting = struct.unpack_from("<iiii", data, 0)
        p = 16
        parent = np.zeros(nnodes, np.int32)
        weight = np.zeros(nnodes, np.float64)
        desc = np.zeros((nnodes, 256), np.float32)
        for _ in range(nnodes - 1):
            nid, par = struct.unpack_from("<II", data, p)
            p += 8
            w, = struct.unpack_from("<d", data, p)
            p += 8
            cols, rows, typ = struct.unpack_from("<iii", data, p)
            p += 12
            assert cols == 256 and rows == 1 and typ == 5, (cols, rows, typ)
            desc[nid] = np.frombuffer(data, np.float32, 256, p)
            p += 1024
            parent[nid] = par
            weight[nid] = w
        n_words, = struct.unpack_from("<I", data, p)
        p += 4
        node_word = np.full(nnodes, -1, np.int32)
        for _ in range(n_words):
            wid, nid = struct.unpack_from("<II", data, p)
            p += 8
            node_word[nid] = wid

        children = np.full((nnodes, k), -1, np.int32)
        counts = np.zeros(nnodes, np.int32)
        for nid in range(1, nnodes):
            par = parent[nid]
            children[par, counts[par]] = nid
            counts[par] += 1
        return Vocabulary(parent, weight, desc, children, node_word,
                          k, L, scoring, weighting)

    # ------------------------------------------------------------------
    def transform(self, descriptors: np.ndarray, levelsup: int = 4
                  ) -> Tuple[Dict[int, float], Dict[int, List[int]]]:
        """(BowVector, FeatureVector) for (N, 256) float descriptors.

        BowVector: word -> TF-IDF value, L2-normalized (DBoW3 TF_IDF +
        L2 scoring norm). FeatureVector: node-at-level(L - levelsup) ->
        keypoint indices (root when levelsup >= L, matching the reference)."""
        n = len(descriptors)
        if n == 0:
            return {}, {}
        nid_level = self.L - levelsup
        node = np.zeros(n, np.int64)
        fv_node = np.zeros(n, np.int64)  # level <= 0 -> root
        for level in range(1, self.L + 1):
            cand = self.children[node]                      # (N, k)
            valid = cand >= 0
            cd = self.node_desc[np.where(valid, cand, 0)]   # (N, k, 256)
            d2 = np.sum(
                (cd - descriptors[:, None, :].astype(np.float32)) ** 2, -1)
            d2 = np.where(valid, d2, np.inf)
            node = cand[np.arange(n), np.argmin(d2, axis=1)]
            if level == nid_level:
                fv_node = node.copy()

        words = self.node_word[node]
        weights = self.node_weight[node]
        bow: Dict[int, float] = {}
        fv: Dict[int, List[int]] = {}
        for i in range(n):
            w = int(words[i])
            if w >= 0 and weights[i] > 0:
                bow[w] = bow.get(w, 0.0) + float(weights[i])
            fv.setdefault(int(fv_node[i]), []).append(i)
        # L2 normalization (DBoW3 must_normalize for L2_NORM scoring)
        norm = np.sqrt(sum(v * v for v in bow.values()))
        if norm > 0:
            bow = {k_: v / norm for k_, v in bow.items()}
        return bow, fv

    def score(self, bv1: Dict[int, float], bv2: Dict[int, float]) -> float:
        """DBoW3 L2Scoring: 1 - sqrt(1 - dot) for L2-normalized vectors."""
        dot = 0.0
        if len(bv2) < len(bv1):
            bv1, bv2 = bv2, bv1
        for w, v in bv1.items():
            v2 = bv2.get(w)
            if v2 is not None:
                dot += v * v2
        if dot >= 1.0:
            return 1.0
        return 1.0 - np.sqrt(1.0 - dot)
