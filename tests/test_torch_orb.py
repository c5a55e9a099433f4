"""ORB extraction and the synthetic renderer: PyTorch port vs tpuslam.

Extraction runs on a rendered 376x240 frame (500 features). Level-0
keypoints must be identical (FAST scores there are exact integers);
overall keypoint overlap (xy and octave) >= 0.98, because pyramid levels
>= 1 differ by a few 1e-3; descriptor bits on shared keypoints agree
>= 0.99, because the f32 sums of the LUT matmul run in another order and
bits whose sum is near 0 can flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.io.synthetic import SyntheticSequence as JSeq
from tpuslam.ops import orb as j_orb
from tpuslam_torch.engine.config import OrbConfig
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.ops import orb

torch.set_num_threads(2)
f32 = np.float32
SEQ = dict(n_frames=4, fps=20, speed=0.5, baseline=0.11)


@pytest.fixture(scope="module")
def frame():
    im = SyntheticSequence(**SEQ).frame(1)
    return np.clip(np.round(im), 0, 255).astype(f32)


@pytest.fixture(scope="module")
def extracted(frame):
    jf = jax.jit(lambda im: j_orb._extract_impl(im, j_orb.OrbConfig(n_features=500), 20.0, 7.0))(
        jnp.asarray(frame, jnp.float32))
    tf = orb.OrbExtractor(OrbConfig(n_features=500), "cpu")(torch.tensor(frame))
    return ({k: np.asarray(v) for k, v in jf.items()}, {k: v.numpy() for k, v in tf.items()})


@pytest.mark.parametrize("idx", [(0, False), (3, True), (2, False)])
def test_renderer_bitwise(idx):
    i, right = idx
    a = JSeq(**SEQ).frame(i, right=right)
    b = SyntheticSequence(**SEQ).frame(i, right=right)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_renderer_gt_and_other_sizes():
    kw = dict(n_frames=3, fps=20, speed=0.5, baseline=0.11, height=48, width=64, fx=40.0, fy=40.0)
    js, ts = JSeq(seed=3, **kw), SyntheticSequence(seed=3, **kw)
    assert np.array_equal(js.frame(2, right=True), ts.frame(2, right=True))
    for t in (0.0, 0.35):
        for a, b in zip(js.gt_pose_cw(t), ts.gt_pose_cw(t)):
            assert np.array_equal(a, b)


def test_extract_fields(extracted):
    jf, tf = extracted
    assert set(jf) == set(tf)
    for k in jf:
        assert jf[k].shape == tf[k].shape and jf[k].dtype == tf[k].dtype, k


def test_level0_keypoints_identical(extracted):
    jf, tf = extracted
    o0 = jf["octave"] == 0
    assert np.array_equal(jf["octave"], tf["octave"])
    assert np.array_equal(jf["xy"][o0], tf["xy"][o0])
    assert np.array_equal(jf["resp"][o0], tf["resp"][o0])
    assert np.array_equal(jf["valid"][o0], tf["valid"][o0])


def _kp_key(f):
    v = f["valid"]
    return {(float(x), float(y), int(o)): i for i, (x, y, o) in
            enumerate(zip(f["xy"][v, 0], f["xy"][v, 1], f["octave"][v]))}


def test_keypoint_overlap_and_descriptors(extracted):
    jf, tf = extracted
    kj, kt = _kp_key(jf), _kp_key(tf)
    shared = kj.keys() & kt.keys()
    assert len(kj) > 300
    assert len(shared) / max(len(kj), len(kt)) >= 0.98
    ij = np.array([np.flatnonzero(jf["valid"])[kj[k]] for k in shared])
    it = np.array([np.flatnonzero(tf["valid"])[kt[k]] for k in shared])
    assert np.mean(jf["bits"][ij] == tf["bits"][it]) >= 0.99
    np.testing.assert_allclose(tf["angle"][it], jf["angle"][ij], atol=1e-3)
    # the packed words are the bits of the port itself
    assert np.array_equal(tf["packed"], np.asarray(j_orb.pack_bits(jnp.asarray(tf["bits"]))))


def test_select_level_keypoints_ties(rng):
    score = rng.randint(0, 4, (70, 90)).astype(f32)       # integer scores: many ties
    for budget in (10, 40):
        jxy, jr = j_orb._select_level_keypoints(jnp.asarray(score), budget, 16)
        txy, tr = orb._select_level_keypoints(torch.tensor(score), budget, 16)
        assert np.array_equal(txy.numpy(), np.asarray(jxy))
        assert np.array_equal(tr.numpy(), np.asarray(jr))


def test_ic_angles_and_descriptors_from_patches(rng):
    p = (rng.rand(64, 37, 37) * 255).astype(f32)
    ja = np.asarray(j_orb._ic_angles_from_patches(jnp.asarray(p)))
    ex = orb.OrbExtractor(OrbConfig(n_features=64), "cpu")
    ta = orb._ic_angles_from_patches(torch.tensor(p), ex.ic_x, ex.ic_y)
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5)
    flat = p.reshape(64, -1)
    jb = np.asarray(j_orb._descriptors_from_patches(jnp.asarray(flat), jnp.asarray(ja)))
    tb = orb._descriptors_from_patches(torch.tensor(flat), torch.tensor(ja), ex.desc_lut)
    assert tb.dtype == torch.uint8
    assert np.mean(tb.numpy() == jb) >= 0.99
