"""DBoW3-compatible vocabulary creation (the reference train_vocabulary tool);
a copy of ppg_slam_tpu/bow/train.py.

The reference builds vocabularies offline with
``DBoW3::Vocabulary(k, L, TF_IDF, L2_NORM).create(features)``
(trainBow.cpp:89-98): hierarchical k-means over float
descriptors (k-means++ seeding, L2 distance), words = childless nodes,
IDF node weights from the training set, then ``save(...)`` in the binary
format that `bow/vocabulary.py` parses.

This module reproduces that pipeline in vectorized numpy:

  * ``create_vocabulary(features, k, L)``  — DBoW3 Vocabulary::create:
    HKmeansStep recursion (TemplatedVocabulary.h semantics: nodes created
    children-first per cluster, recursing into each child), k-means++
    initialization, mean-of-cluster centroids.
  * word assignment                        — createWords: every leaf
    (childless node) becomes a word, word ids in node-id order.
  * ``set_node_weights``                   — TF_IDF/IDF: w_i = ln(N / N_i)
    with N = #documents (images) and N_i = #documents whose transform
    touches word i.
  * ``save_vocabulary(voc, path)``         — binary writer (magic
    88877711233, uncompressed payload flag=0; the loader handles both
    compressed and uncompressed streams).

Determinism: seeded RandomState; identical inputs give identical trees.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .vocabulary import MAGIC, Vocabulary

DESC_DIM = 256


def _kmeanspp_init(desc: np.ndarray, k: int, rng: np.random.RandomState
                   ) -> np.ndarray:
    """k-means++ seeding (DBoW3 initiateClustersKMpp)."""
    n = len(desc)
    centers = [desc[rng.randint(n)]]
    d2 = np.sum((desc - centers[0]) ** 2, axis=1)
    while len(centers) < k:
        s = d2.sum()
        if s <= 0:
            break
        probs = d2 / s
        idx = rng.choice(n, p=probs)
        centers.append(desc[idx])
        d2 = np.minimum(d2, np.sum((desc - desc[idx]) ** 2, axis=1))
    return np.stack(centers)


def _kmeans(desc: np.ndarray, k: int, rng: np.random.RandomState,
            max_iters: int = 100) -> tuple:
    """Lloyd k-means with k-means++ init; returns (centroids, labels)."""
    centers = _kmeanspp_init(desc, k, rng)
    labels = np.zeros(len(desc), np.int64)
    for _ in range(max_iters):
        d2 = np.sum((desc[:, None, :] - centers[None]) ** 2, axis=2)
        new_labels = np.argmin(d2, axis=1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for c in range(len(centers)):
            mask = labels == c
            if mask.any():
                centers[c] = desc[mask].mean(axis=0)
    # drop empty clusters
    used = np.unique(labels)
    centers = centers[used]
    remap = {int(c): i for i, c in enumerate(used)}
    labels = np.asarray([remap[int(c)] for c in labels], np.int64)
    return centers, labels


class _TreeBuilder:
    def __init__(self, k: int, L: int, seed: int):
        self.k = k
        self.L = L
        self.rng = np.random.RandomState(seed)
        self.parent = [0]
        self.desc = [np.zeros(DESC_DIM, np.float32)]
        self.level = [0]

    def hkmeans(self, node: int, desc: np.ndarray, level: int) -> None:
        """DBoW3 HKmeansStep: cluster, create the k children, recurse."""
        if len(desc) == 0 or level > self.L:
            return
        if len(desc) <= self.k:
            centers = desc.copy()
            labels = np.arange(len(desc))
        else:
            centers, labels = _kmeans(desc, self.k, self.rng)
        child_ids = []
        for c in range(len(centers)):
            nid = len(self.parent)
            self.parent.append(node)
            self.desc.append(centers[c].astype(np.float32))
            self.level.append(level)
            child_ids.append(nid)
        if level < self.L:
            for c, nid in enumerate(child_ids):
                self.hkmeans(nid, desc[labels == c], level + 1)


def create_vocabulary(features: List[np.ndarray], k: int = 9, L: int = 3,
                      seed: int = 0, weighting: int = 0, scoring: int = 1
                      ) -> Vocabulary:
    """Build a vocabulary from per-image descriptor matrices
    (list of (Ni, 256) float32), like DBoW3 Vocabulary::create."""
    all_desc = np.concatenate([f for f in features if len(f)], axis=0) \
        .astype(np.float32)
    tb = _TreeBuilder(k, L, seed)
    tb.hkmeans(0, all_desc, 1)

    nnodes = len(tb.parent)
    parent = np.asarray(tb.parent, np.int32)
    desc = np.stack(tb.desc).astype(np.float32)

    children = np.full((nnodes, k), -1, np.int32)
    counts = np.zeros(nnodes, np.int32)
    for nid in range(1, nnodes):
        p = parent[nid]
        children[p, counts[p]] = nid
        counts[p] += 1

    # words: childless nodes in node-id order (DBoW3 createWords)
    node_word = np.full(nnodes, -1, np.int32)
    wid = 0
    for nid in range(1, nnodes):
        if counts[nid] == 0:
            node_word[nid] = wid
            wid += 1

    voc = Vocabulary(parent, np.ones(nnodes, np.float64), desc, children,
                     node_word, k, L, scoring, weighting)
    _set_node_weights(voc, features)
    return voc


def _set_node_weights(voc: Vocabulary, features: List[np.ndarray]) -> None:
    """IDF weights from the training set (DBoW3 setNodeWeights for
    TF_IDF/IDF): w_i = ln(N_docs / N_docs_containing_word_i)."""
    if voc.weighting not in (0, 2):  # TF_IDF or IDF
        return
    n_docs = sum(1 for f in features if len(f))
    counts = np.zeros(voc.n_words, np.int64)
    word_of_node = voc.node_word
    for f in features:
        if not len(f):
            continue
        leaves = _descend(voc, np.asarray(f, np.float32))
        words = np.unique(word_of_node[leaves])
        words = words[words >= 0]
        counts[words] += 1
    weights = np.zeros_like(voc.node_weight)
    for nid in range(len(word_of_node)):
        w = word_of_node[nid]
        if w >= 0:
            ni = max(int(counts[w]), 1)
            weights[nid] = np.log(n_docs / ni)
    voc.node_weight = weights


def _descend(voc: Vocabulary, desc: np.ndarray) -> np.ndarray:
    """Leaf node id for each descriptor (vectorized tree descent)."""
    n = len(desc)
    node = np.zeros(n, np.int64)
    for _ in range(voc.L):
        cand = voc.children[node]
        valid = cand >= 0
        if not valid.any():
            break
        cd = voc.node_desc[np.where(valid, cand, 0)]
        d2 = np.sum((cd - desc[:, None, :]) ** 2, axis=-1)
        d2 = np.where(valid, d2, np.inf)
        nxt = cand[np.arange(n), np.argmin(d2, axis=1)]
        node = np.where(valid.any(axis=1), nxt, node)
    return node


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """Write the DBoW3 binary format (uncompressed payload; loadable by
    bow/vocabulary.py and by DBoW3's own fromStream)."""
    out = bytearray()
    out += struct.pack("<Q", MAGIC)
    out += struct.pack("<B", 0)  # compressed flag = 0
    nnodes = len(voc.node_parent)
    out += struct.pack("<I", nnodes)

    data = bytearray()
    data += struct.pack("<iiii", voc.k, voc.L, voc.scoring, voc.weighting)
    for nid in range(1, nnodes):
        data += struct.pack("<II", nid, int(voc.node_parent[nid]))
        data += struct.pack("<d", float(voc.node_weight[nid]))
        data += struct.pack("<iii", DESC_DIM, 1, 5)  # cols, rows, CV_32F
        data += voc.node_desc[nid].astype("<f4").tobytes()
    word_nodes = np.nonzero(voc.node_word >= 0)[0]
    data += struct.pack("<I", len(word_nodes))
    for nid in word_nodes:
        data += struct.pack("<II", int(voc.node_word[nid]), int(nid))
    out += data
    with open(path, "wb") as f:
        f.write(bytes(out))
