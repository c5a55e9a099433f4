"""Hierarchical binary bag-of-words vocabulary (port of
tpuslam/place/vocab.py; ref: Thirdparty/DBoW2 TemplatedVocabulary — a
k-branching depth-L tree of 256-bit ORB descriptors, L1 scoring, trained
by recursive k-majority clustering).

The tree is dense per-level arrays (the children of node n at level l are
rows n*k .. n*k+k-1 of level_descs[l]); `transform` descends all query
descriptors at once, one gather + Hamming argmin per level, on the
caller's device. Hamming distances are |a| + |b| - 2 a.b over {0,1}
vectors in f32, exact for 256 bits. Training keeps tpuslam's
numpy.RandomState(seed), so the same descriptors give the same tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import DEFAULT_DEVICE, resolve_device


def _hamming01(a, b):
    """Hamming distance between {0,1} rows: a [N,256], b [M,256] -> [N,M]
    (or batched b [N,k,256] -> [N,k]) int32."""
    af = a.float()
    bf = b.float()
    if b.dim() == 3:
        ab = torch.einsum("nd,nkd->nk", af, bf)
        return (af.sum(-1)[:, None] + bf.sum(-1) - 2 * ab).to(torch.int32)
    return (af.sum(-1)[:, None] + bf.sum(-1)[None, :] - 2 * af @ bf.T).to(torch.int32)


def _assign(descs, centers, device):
    d = _hamming01(torch.as_tensor(descs, device=device), torch.as_tensor(centers, device=device))
    return torch.argmin(d, dim=-1).cpu().numpy()


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8, device=DEFAULT_DEVICE):
    """k-majority clustering of binary descriptors (DBoW2's meanValue =
    bitwise majority). Returns (centers [k,256], assign [M])."""
    M = len(descs)
    if M <= k:
        centers = np.zeros((k, 256), np.uint8)
        centers[:M] = descs
        return centers, np.arange(M) % k
    centers = descs[rng.choice(M, k, replace=False)].copy()
    for _ in range(iters):
        assign = _assign(descs, centers, device)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel) == 0:
                centers[c] = descs[rng.randint(M)]  # re-seed an empty cluster
            else:
                centers[c] = (sel.mean(0) > 0.5).astype(np.uint8)
    return centers, _assign(descs, centers, device)


@dataclass
class BinaryVocabulary:
    k: int                      # branching factor
    L: int                      # depth (words = k^L leaves)
    level_descs: list           # per level l: [k^(l+1), 256] u8 node descriptors
    word_weight: np.ndarray     # [n_words] idf, indexed by word id
    node_level: int             # level whose ids feed node-aligned matching
    leaf_word: np.ndarray = None  # [k^L] bottom slot -> word id (or -1);
                                  # None = identity (complete trained tree)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_words(self):
        return len(self.word_weight)

    def word_of(self, pos: int) -> int:
        """Word id of bottom-level positional slot `pos`."""
        return int(self.leaf_word[pos]) if self.leaf_word is not None else pos

    def _levels(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = [torch.as_tensor(np.asarray(d, np.uint8), device=device)
                              for d in self.level_descs]
        return self._dev[key]

    def transform(self, bits: np.ndarray, valid: np.ndarray, device=DEFAULT_DEVICE):
        """bits [N,256] u8 -> (word_ids [N], node_ids [N], bow dict), the
        descent on `device`. word = leaf index; node = the ancestor at
        node_level (for node-aligned matching, ref ORBmatcher.cc:289-297).
        Invalid rows get -1."""
        device = resolve_device(device)
        levels = self._levels(device)
        q = torch.as_tensor(np.asarray(bits, np.uint8), device=device)
        ids = torch.zeros(q.shape[0], dtype=torch.int64, device=device)
        out = []
        ar = torch.arange(self.k, device=device)
        for descs in levels:
            base = ids * self.k
            children = descs[base[:, None] + ar[None, :]]      # [N,k,256]
            ids = base + torch.argmin(_hamming01(q, children), dim=-1)
            out.append(ids)
        ids = torch.stack(out).cpu().numpy()
        word = np.where(valid, ids[self.L - 1], -1)
        if self.leaf_word is not None:  # irregular (reference-file) tree
            word = np.where(word >= 0, self.leaf_word[word], -1)
        node = np.where(valid, ids[self.node_level], -1)
        bow: dict[int, float] = {}
        for w in word[word >= 0]:
            bow[int(w)] = bow.get(int(w), 0.0) + float(self.word_weight[w])
        norm = sum(bow.values())
        if norm > 0:
            bow = {w: v / norm for w, v in bow.items()}
        return word, node, bow

    @staticmethod
    def score(bow1: dict, bow2: dict) -> float:
        """L1 score of L1-normalized BoW vectors, in [0, 1] (ref DBoW2
        L1Scoring)."""
        s = 0.0
        for w, v in bow1.items():
            u = bow2.get(w)
            if u is not None:
                s += abs(v) + abs(u) - abs(v - u)
        return 0.5 * s


def train_vocabulary(descs: np.ndarray, k: int = 10, L: int = 3, seed: int = 0,
                     node_levels_up: int = 2, iters: int = 8,
                     device=DEFAULT_DEVICE) -> BinaryVocabulary:
    """Recursive k-majority training (ref TemplatedVocabulary::create).
    descs: [M,256] {0,1} u8 training descriptors; node level =
    L - 1 - node_levels_up. The assignments run on `device`."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    level_descs = []
    groups = {(): descs}
    for l in range(L):
        descs_l = np.zeros((k ** (l + 1), 256), np.uint8)
        next_groups = {}
        for path, sub in groups.items():
            base = 0
            for d in path:
                base = base * k + d
            centers, assign = _kmajority(sub, k, rng, iters, device)
            descs_l[base * k:(base + 1) * k] = centers
            for c in range(k):
                next_groups[path + (c,)] = sub[assign == c]
        level_descs.append(descs_l)
        groups = next_groups
    # idf weights from the training term frequencies
    counts = np.zeros(k ** L, np.int64)
    for path, sub in groups.items():
        w = 0
        for d in path:
            w = w * k + d
        counts[w] = len(sub)
    weight = np.log(max(len(descs), 1) / np.maximum(counts, 1)).astype(np.float64)
    weight[counts == 0] = 0.0
    return BinaryVocabulary(k=k, L=L, level_descs=level_descs, word_weight=weight,
                            node_level=max(L - 1 - node_levels_up, 0))


def vocab_from_numpy(k, L, level_descs, word_weight, node_level, leaf_word=None):
    """Carry a vocabulary's arrays across (e.g. from a tpuslam
    BinaryVocabulary's fields, or a saved npz)."""
    return BinaryVocabulary(
        k=int(k), L=int(L), level_descs=[np.asarray(d, np.uint8) for d in level_descs],
        word_weight=np.asarray(word_weight, np.float64), node_level=int(node_level),
        leaf_word=None if leaf_word is None else np.asarray(leaf_word, np.int64))
