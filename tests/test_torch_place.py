"""The port's place recognition vs tpuslam's, on the CPU: vocabulary
training, the BoW transform, and the keyframe database's candidates.

Descriptors are made with numpy from a seed, clustered around shared
prototypes as ORB patches are. Training keeps tpuslam's
numpy.RandomState(seed) and the Hamming argmins are exact integer
arithmetic on both sides, so the trees, words, nodes and BoW vectors must
be EQUAL (BoW weights to 1e-12), and the database's candidates and scores
equal (scores to 1e-6: the native index scores in f32 on both sides).
"""

import numpy as np
import pytest
import torch

from tpuslam.place import KeyFrameDatabase as JKeyFrameDatabase
from tpuslam.place import train_vocabulary as j_train_vocabulary
from tpuslam_torch.place import BinaryVocabulary, KeyFrameDatabase, train_vocabulary
from tpuslam_torch.place import vocab_from_numpy

torch.set_num_threads(2)
_PROTOS = np.random.RandomState(99).rand(1024, 256) > 0.5


def _descs(rng, n):
    proto = _PROTOS[rng.randint(0, len(_PROTOS), n)]
    return (proto ^ (rng.rand(n, 256) < 0.12)).astype(np.uint8)


def _perturb(rng, descs, n_flip):
    out = descs.copy()
    for i in range(len(out)):
        out[i, rng.choice(256, n_flip, replace=False)] ^= 1
    return out


@pytest.fixture(scope="module")
def vocabs():
    train = _descs(np.random.RandomState(0), 4000)
    return (train_vocabulary(train, k=8, L=3, iters=5, device="cpu"),
            j_train_vocabulary(train, k=8, L=3, iters=5))


def test_training_gives_the_same_tree(vocabs):
    tv, jv = vocabs
    assert (tv.k, tv.L, tv.node_level) == (jv.k, jv.L, jv.node_level)
    for a, b in zip(tv.level_descs, jv.level_descs):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(tv.word_weight, jv.word_weight, atol=1e-12)
    assert tv.n_words == jv.n_words == 512


@pytest.mark.parametrize("carried", [False, True])
def test_transform_matches_tpuslam(vocabs, carried):
    """Same words, nodes and BoW, from the port's own tree or from a
    tpuslam tree carried across with vocab_from_numpy."""
    tv, jv = vocabs
    if carried:
        tv = vocab_from_numpy(jv.k, jv.L, jv.level_descs, jv.word_weight, jv.node_level)
    d = _descs(np.random.RandomState(1), 300)
    valid = np.ones(300, bool)
    valid[-10:] = False
    tw, tn, tb = tv.transform(d, valid, device="cpu")
    jw, jn, jb = jv.transform(d, valid)
    assert np.array_equal(tw, jw) and np.array_equal(tn, jn)
    assert (tw[-10:] == -1).all() and (tw[:290] >= 0).all()
    depth = tv.L - 1 - tv.node_level
    assert np.array_equal(tw[:290] // tv.k ** depth, tn[:290])
    assert sorted(tb) == sorted(jb)
    np.testing.assert_allclose([tb[w] for w in sorted(tb)], [jb[w] for w in sorted(jb)],
                               atol=1e-12)
    assert abs(sum(tb.values()) - 1.0) < 1e-9


def test_similar_images_score_higher(vocabs):
    tv, jv = vocabs
    rng = np.random.RandomState(2)
    a = _descs(rng, 300)
    b = _descs(rng, 300)
    valid = np.ones(300, bool)
    bow = [tv.transform(x, valid, device="cpu")[2] for x in (a, _perturb(rng, a, 12), b)]
    s_same = BinaryVocabulary.score(bow[0], bow[1])
    assert s_same > 1.5 * BinaryVocabulary.score(bow[0], bow[2])
    assert s_same == pytest.approx(type(jv).score(bow[0], bow[1]), abs=1e-15)


def _fill(vocab, db_cls, rng, n_kf, n):
    db = db_cls(vocab)
    valid = np.ones(n, bool)
    descs = []
    for kf in range(n_kf):
        d = _descs(rng, n)
        descs.append(d)
        port = isinstance(vocab, BinaryVocabulary)
        word, _, bow = vocab.transform(d, valid, **({"device": "cpu"} if port else {}))
        db.add(kf, word, bow)
    return db, descs, valid


def test_kfdb_candidates_match_tpuslam(vocabs):
    """Retrieval of a noisy query, exclusion, erase, and a covisibility
    grouping: the same candidates with the same group scores."""
    tv, jv = vocabs
    tdb, descs, valid = _fill(tv, KeyFrameDatabase, np.random.RandomState(3), 12, 200)
    jdb, _, _ = _fill(jv, JKeyFrameDatabase, np.random.RandomState(3), 12, 200)
    q = _perturb(np.random.RandomState(4), descs[7], 10)
    _, _, bow_q = tv.transform(q, valid, device="cpu")
    covis = {k: [(k + 1) % 12, (k + 5) % 12] for k in range(12)}
    for exclude, covis_of in ((set(), lambda k: []), ({7}, lambda k: []),
                              (set(), lambda k: covis[k])):
        tc = tdb.detect_candidates(bow_q, covis_of, exclude=exclude, n_best=3)
        jc = jdb.detect_candidates(bow_q, covis_of, exclude=exclude, n_best=3)
        assert [k for k, _ in tc] == [k for k, _ in jc]
        np.testing.assert_allclose([s for _, s in tc], [s for _, s in jc], atol=1e-6)
    assert tdb.detect_candidates(bow_q, lambda k: [], exclude=set())[0][0] == 7
    tdb.erase(7)
    jdb.erase(7)
    tc = tdb.detect_candidates(bow_q, lambda k: [], exclude=set(), n_best=3)
    assert 7 not in [k for k, _ in tc]
    assert [k for k, _ in tc] == [k for k, _ in jdb.detect_candidates(bow_q, lambda k: [],
                                                                      exclude=set(), n_best=3)]


def test_reloc_candidates_match_tpuslam(vocabs):
    tv, jv = vocabs
    tdb, descs, valid = _fill(tv, KeyFrameDatabase, np.random.RandomState(5), 8, 150)
    jdb, _, _ = _fill(jv, JKeyFrameDatabase, np.random.RandomState(5), 8, 150)
    _, _, bow_q = tv.transform(_perturb(np.random.RandomState(6), descs[2], 8), valid,
                                 device="cpu")
    tc = tdb.detect_relocalization_candidates(bow_q, lambda kf: [])
    jc = jdb.detect_relocalization_candidates(bow_q, lambda kf: [])
    assert tc and tc[0][0] == 2
    assert [k for k, _ in tc] == [k for k, _ in jc]
