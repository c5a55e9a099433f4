"""Vocabulary persistence: one npz with per-level node descriptors (port
of tpuslam/place/store.py; the same keys and dtypes).

Replaces the reference's vocabulary files (ORBvoc.txt/.bin loaded by
TemplatedVocabulary::loadFromTextFile/loadFromBinaryFile,
Thirdparty/DBoW2 TemplatedVocabulary.h:1350/1466 — the Mac fork's binary
loader System.cc:85). Our tree is dense arrays, so save/load is one npz.
"""

from __future__ import annotations

import numpy as np

from .vocab import BinaryVocabulary


def save_vocabulary(vocab: BinaryVocabulary, path: str):
    arrays = {f"level_{i}": d for i, d in enumerate(vocab.level_descs)}
    arrays["word_weight"] = vocab.word_weight
    arrays["meta"] = np.array([vocab.k, vocab.L, vocab.node_level])
    if vocab.leaf_word is not None:
        arrays["leaf_word"] = vocab.leaf_word
    np.savez_compressed(path, **arrays)


def load_vocabulary(path: str) -> BinaryVocabulary:
    data = np.load(path)
    k, L, node_level = (int(v) for v in data["meta"])
    return BinaryVocabulary(
        k=k, L=L,
        level_descs=[data[f"level_{i}"].copy() for i in range(L)],
        word_weight=data["word_weight"].copy(),
        node_level=node_level,
        leaf_word=data["leaf_word"].copy() if "leaf_word" in data else None,
    )
