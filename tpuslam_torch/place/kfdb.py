"""Keyframe database: inverted BoW index + candidate detection (port of
tpuslam/place/kfdb.py; ref: src/KeyFrameDatabase.cc — add :39, shared-word
counting with the 0.8 * max cutoff, covisibility-group score accumulation,
DetectNBestCandidates :612, DetectRelocalizationCandidates :783).

The inverted file, shared-word histogram and L1 scoring run in the port's
native C++ core (tpuslam_torch/native, a copy of tpuslam's) when g++ can
build it, a pure-Python structure otherwise; the candidate policy is host
control flow.
"""

from __future__ import annotations

import numpy as np

from ..native import NativeInvIndex, available

from .vocab import BinaryVocabulary


class KeyFrameDatabase:
    def __init__(self, vocab: BinaryVocabulary):
        self.vocab = vocab
        self.kf_bow: dict[int, dict] = {}
        self.kf_words: dict[int, np.ndarray] = {}
        self._native = NativeInvIndex(vocab.n_words) if available() else None
        if self._native is None:
            self.inverted: list[list[int]] = [[] for _ in range(vocab.n_words)]

    def add(self, kf: int, word_ids: np.ndarray, bow: dict):
        words = np.unique(word_ids[word_ids >= 0])
        self.kf_bow[kf] = bow
        self.kf_words[kf] = words
        if self._native is not None:
            ws, vs = self._sorted(bow)
            self._native.add(kf, ws, vs)
        else:
            for w in words:
                self.inverted[int(w)].append(kf)

    def erase(self, kf: int):
        words = self.kf_words.pop(kf, None)
        if words is None:
            return
        self.kf_bow.pop(kf, None)
        if self._native is not None:
            self._native.erase(kf)
        else:
            for w in words:
                lst = self.inverted[int(w)]
                if kf in lst:
                    lst.remove(kf)

    # ------------------------------------------------------------- queries
    @staticmethod
    def _sorted(bow: dict):
        ws = np.sort(np.fromiter(bow.keys(), np.int32, len(bow)))
        return ws, np.array([bow[int(w)] for w in ws], np.float32)

    def _shared_words(self, bow: dict, exclude: set):
        if self._native is not None:
            q = np.fromiter(bow.keys(), np.int32, len(bow))
            x = np.fromiter(exclude, np.int64, len(exclude))
            kfs, cts = self._native.shared(q, x)
            return dict(zip(kfs.tolist(), cts.tolist()))
        counts: dict[int, int] = {}
        for w in bow:
            for kf in self.inverted[w]:
                if kf not in exclude:
                    counts[kf] = counts.get(kf, 0) + 1
        return counts

    def _score(self, bow: dict, kf: int) -> float:
        if self._native is not None:
            return self._native.score(kf, *self._sorted(bow))
        return BinaryVocabulary.score(bow, self.kf_bow[kf])

    def detect_candidates(self, bow: dict, covis_of, exclude: set, n_best: int = 3,
                          min_common_ratio: float = 0.8):
        """Top-N candidate KFs by accumulated covisibility-group score
        (ref DetectNBestCandidates). covis_of: kf -> covisible KFs.
        Returns [(kf, group_score)] best first."""
        counts = self._shared_words(bow, exclude)
        if not counts:
            return []
        th = max(int(max(counts.values()) * min_common_ratio), 1)
        cands = [kf for kf, c in counts.items() if c >= th]
        if not cands:
            return []
        scores = {kf: self._score(bow, kf) for kf in cands}
        # accumulate over covisibility groups; keep the best member
        acc = []
        for kf in cands:
            group = set([kf] + [o for o in covis_of(kf) if o in scores])
            acc.append((max(group, key=lambda g: scores[g]), sum(scores[g] for g in group)))
        acc.sort(key=lambda kv: -kv[1])
        out = []
        seen = set()
        for kf, sc in acc:
            if kf in seen:
                continue
            seen.add(kf)
            out.append((kf, sc))
            if len(out) >= n_best:
                break
        return out

    def detect_relocalization_candidates(self, bow: dict, covis_of, n_best: int = 5):
        """ref DetectRelocalizationCandidates (:783): the same scheme, no
        exclusion set, a 0.75 * best-score cutoff."""
        cands = self.detect_candidates(bow, covis_of, exclude=set(),
                                       n_best=max(n_best * 2, 8), min_common_ratio=0.8)
        if not cands:
            return []
        best = cands[0][1]
        return [(kf, s) for kf, s in cands if s >= 0.75 * best][:n_best]
