"""Reference-format ORB vocabulary IO (DBoW2 TemplatedVocabulary files;
port of tpuslam/place/orbvoc.py, numpy only).

Reads/writes the exact on-disk formats of the reference so its shipped
ORBvoc can be used drop-in, and vocabularies trained here can be consumed
by the reference:

- text  (ORBvoc.txt):  TemplatedVocabulary.h:1350 loadFromTextFile /
  :1400 saveToTextFile — line 1 "k L scoring weighting"; one line per
  node (ids implicit, in file order, root omitted):
  "parent is_leaf b0 .. b31 weight". Words numbered by leaf file order.
- binary (ORBvoc.bin): TemplatedVocabulary.h:1466 loadFromBinaryFile /
  :1517 saveToBinaryFile (the Mac fork's loader, System.cc:85) — header
  u32 nb_nodes, u32 size_node, i32 k, i32 L, i32 scoring, i32 weighting;
  then nb_nodes-1 records of [i32 parent | 32B descriptor | f32 weight |
  u8 is_leaf].

DBoW2 trees are irregular: interior nodes may have < k children (pruned
empty clusters) and leaves can occur above the bottom level (clusters
that ran out of descriptors). Our batched descent (vocab._descend) wants
a dense complete k-ary tree, so loading *densifies*: missing child slots
duplicate their first real sibling's descriptor (exact Hamming ties
resolve to the lower index, so argmin never enters a duplicate), and an
early leaf's descriptor is propagated down to the bottom level so the
fixed-depth descent terminates on it. A leaf_word table maps bottom-level
slot -> reference word id, preserving the reference's word numbering (so
BoW vectors/scores are comparable across implementations).
"""

from __future__ import annotations

import struct

import numpy as np

from .vocab import BinaryVocabulary

_DESC_BYTES = 32  # FORB::L — 256-bit ORB


def _bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="big")


def _bytes_to_bits(by: np.ndarray) -> np.ndarray:
    return np.unpackbits(by.astype(np.uint8), axis=-1, bitorder="big")


class _Nodes:
    """Parsed node soup: id 0 is the (descriptor-less) root."""

    def __init__(self, n: int):
        self.parent = np.zeros(n, np.int64)
        self.is_leaf = np.zeros(n, bool)
        self.desc = np.zeros((n, _DESC_BYTES), np.uint8)
        self.weight = np.zeros(n, np.float64)
        self.children: list[list[int]] = [[] for _ in range(n)]
        self.word_id = np.full(n, -1, np.int64)


def _parse_text(path: str):
    with open(path) as f:
        head = f.readline().split()
        k, L = int(head[0]), int(head[1])
        lines = [ln for ln in f if ln.strip()]
    nodes = _Nodes(len(lines) + 1)
    n_words = 0
    for nid, ln in enumerate(lines, start=1):
        tok = ln.split()
        pid = int(tok[0])
        nodes.parent[nid] = pid
        nodes.children[pid].append(nid)
        nodes.is_leaf[nid] = int(tok[1]) > 0
        nodes.desc[nid] = np.array(tok[2:2 + _DESC_BYTES], np.uint8)
        nodes.weight[nid] = float(tok[2 + _DESC_BYTES])
        if nodes.is_leaf[nid]:
            nodes.word_id[nid] = n_words
            n_words += 1
    return nodes, k, L, n_words


def _parse_binary(path: str):
    with open(path, "rb") as f:
        hdr = f.read(24)
        nb_nodes, size_node, k, L, _scoring, _weighting = struct.unpack(
            "<IIiiii", hdr)
        body = f.read()
    rec = np.frombuffer(
        body[: (nb_nodes - 1) * size_node], np.uint8
    ).reshape(nb_nodes - 1, size_node)
    nodes = _Nodes(nb_nodes)
    nodes.parent[1:] = rec[:, :4].copy().view("<i4")[:, 0]
    nodes.desc[1:] = rec[:, 4:4 + _DESC_BYTES]
    nodes.weight[1:] = rec[:, 4 + _DESC_BYTES:8 + _DESC_BYTES].copy().view(
        "<f4")[:, 0]
    nodes.is_leaf[1:] = rec[:, 8 + _DESC_BYTES] != 0
    n_words = 0
    for nid in range(1, nb_nodes):
        nodes.children[nodes.parent[nid]].append(nid)
        if nodes.is_leaf[nid]:
            nodes.word_id[nid] = n_words
            n_words += 1
    return nodes, k, L, n_words


def _densify(nodes: _Nodes, k: int, L: int, n_words: int,
             node_levels_up: int = 4) -> BinaryVocabulary:
    """Irregular DBoW2 tree -> dense complete k-ary per-level arrays."""
    level_descs = []
    # slot -> node id at the previous level; -1 = dead subtree
    slot_node = np.array([0], np.int64)
    slot_desc = np.zeros((1, 256), np.uint8)  # descriptor carried by slot
    for lvl in range(L):
        n_slots = k ** (lvl + 1)
        descs = np.zeros((n_slots, 256), np.uint8)
        nxt = np.full(n_slots, -1, np.int64)
        for p in range(len(slot_node)):
            base = p * k
            nid = slot_node[p]
            if nid < 0:
                # dead: propagate the parent's descriptor so ties keep
                # resolving away from this subtree
                descs[base:base + k] = slot_desc[p]
                continue
            kids = nodes.children[nid]
            if nodes.is_leaf[nid] or not kids:
                # early leaf: carry it straight down; slot 0 stays live
                bits = _bytes_to_bits(nodes.desc[nid]) if nid else 0
                descs[base:base + k] = bits
                nxt[base] = nid
                continue
            first_bits = None
            for c, cid in enumerate(kids[:k]):
                bits = _bytes_to_bits(nodes.desc[cid])
                descs[base + c] = bits
                nxt[base + c] = cid
                if first_bits is None:
                    first_bits = bits
            for c in range(len(kids), k):  # pruned slots: dup first child
                descs[base + c] = first_bits
        level_descs.append(descs)
        slot_node, slot_desc = nxt, descs
    leaf_word = np.full(k ** L, -1, np.int64)
    live = slot_node >= 0
    leaf_word[live] = nodes.word_id[slot_node[live]]
    word_weight = np.zeros(max(n_words, 1), np.float64)
    leaf_ids = np.nonzero(nodes.word_id >= 0)[0]
    word_weight[nodes.word_id[leaf_ids]] = nodes.weight[leaf_ids]
    return BinaryVocabulary(
        k=k, L=L, level_descs=level_descs, word_weight=word_weight,
        node_level=max(L - 1 - node_levels_up, 0), leaf_word=leaf_word,
    )


def load_orbvoc(path: str, node_levels_up: int = 4) -> BinaryVocabulary:
    """Load a reference ORBvoc.{txt,bin} (format auto-detected).

    node_levels_up mirrors the reference's transform(..., 4)
    (Frame.cc:729): FeatureVector nodes are recorded 4 levels above the
    leaves for node-aligned matching.
    """
    with open(path, "rb") as f:
        head = f.read(64)
    try:
        is_text = head.decode("ascii").split("\n")[0].replace(
            " ", "").replace(".", "").isdigit()
    except UnicodeDecodeError:
        is_text = False
    parse = _parse_text if is_text else _parse_binary
    nodes, k, L, n_words = parse(path)
    return _densify(nodes, k, L, n_words, node_levels_up)


def save_orbvoc_text(vocab: BinaryVocabulary, path: str,
                     scoring: int = 0, weighting: int = 3):
    """Write a vocabulary in the reference's text format (L1 scoring,
    TF-IDF weighting by default — DBoW2 enum values)."""
    with open(path, "w") as f:
        f.write(f"{vocab.k} {vocab.L}  {scoring} {weighting}\n")
        for pid, nid, bits, is_leaf, w in _walk_complete(vocab):
            by = _bits_to_bytes(bits)
            f.write(f"{pid} {int(is_leaf)} "
                    + " ".join(str(int(b)) for b in by)
                    + f" {w}\n")


def save_orbvoc_binary(vocab: BinaryVocabulary, path: str,
                       scoring: int = 0, weighting: int = 3):
    rows = list(_walk_complete(vocab))
    size_node = 4 + _DESC_BYTES + 4 + 1
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiiii", len(rows) + 1, size_node,
                            vocab.k, vocab.L, scoring, weighting))
        for pid, nid, bits, is_leaf, w in rows:
            f.write(struct.pack("<i", pid))
            f.write(_bits_to_bytes(bits).tobytes())
            f.write(struct.pack("<f?", w, is_leaf))


def _walk_complete(vocab: BinaryVocabulary):
    """Enumerate a (complete) trained vocabulary's nodes in the file's
    node-id order: BFS level by level, parents before children. Yields
    (parent_file_id, file_id, bits, is_leaf, weight)."""
    k, L = vocab.k, vocab.L
    # file id of node at (level, pos): levels are stored contiguously
    def fid(lvl, pos):
        off = 1
        for l in range(lvl):
            off += k ** (l + 1)
        return off + pos

    for lvl in range(L):
        descs = vocab.level_descs[lvl]
        for pos in range(descs.shape[0]):
            pid = 0 if lvl == 0 else fid(lvl - 1, pos // k)
            is_leaf = lvl == L - 1
            if is_leaf:
                wid = vocab.word_of(pos)
                w = vocab.word_weight[wid] if wid >= 0 else 0.0
            else:
                w = 0.0
            yield pid, fid(lvl, pos), descs[pos], is_leaf, float(w)
