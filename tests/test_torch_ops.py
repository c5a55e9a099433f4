"""Parity of the PyTorch port's constants, config and frontend ops with
tpuslam (JAX on the CPU).

Inputs are made with numpy from a seed and fed to both sides; JAX gets f32
explicitly because the suite enables x64. Tolerances: exact where both
sides do the same integer or copy arithmetic; 1e-4 for the blur (f32
sums); 5e-3 for pyramid levels >= 1 (torch's antialiased bilinear filter
vs jax.image.resize, measured 2.2e-3..2.7e-3 on 752x480).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.core import robust as j_robust
from tpuslam.engine import config as j_config
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.ops import fast as j_fast
from tpuslam.ops import hamming as j_ham
from tpuslam.ops import image as j_image
from tpuslam.ops import match as j_match
from tpuslam.ops import orb as j_orb
from tpuslam.ops import stereo as j_stereo
from tpuslam.ops.patch_pallas import MAX_SIZE, _extract_patches_tpu, _extract_patches_xla
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.core import robust
from tpuslam_torch.engine import config
from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
from tpuslam_torch.ops import fast, hamming, image, match, orb, patch_cuda, stereo

torch.set_num_threads(2)
f32 = np.float32


def _img(rng, h=120, w=200, integer=False):
    im = rng.rand(h, w) * 255.0
    return (np.round(im) if integer else im).astype(f32)


# ------------------------------------------------------------ constants


@pytest.mark.parametrize("name", ["PATTERN", "_DESC_LUT", "_CIRC_MASK", "_IC_X", "_IC_Y"])
def test_orb_constants_bitwise(name):
    a, b = getattr(j_orb, name), getattr(orb, name)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_extractor_buffers_match_constants():
    ex = orb.OrbExtractor(OrbConfig(n_features=64), "cpu")
    assert np.array_equal(ex.gauss_taps.numpy(), j_image.gaussian_kernel1d())
    assert np.array_equal(ex.ic_x.numpy(), j_orb._IC_X)
    assert np.array_equal(ex.ic_y.numpy(), j_orb._IC_Y)
    lut_bf16 = np.asarray(jnp.asarray(j_orb._DESC_LUT, jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(ex.desc_lut.numpy(), lut_bf16)


@pytest.mark.parametrize("pair", ["orb", "tracking", "MappingConfig", "InertialConfig",
                                  "LoopConfig", "SlamConfig"])
def test_config_fields_and_defaults(pair):
    jcls, tcls = {"orb": (j_orb.OrbConfig, OrbConfig),
                  "tracking": (JTrackingConfig, TrackingConfig)}.get(
        pair, (getattr(j_config, pair, None), getattr(config, pair, None)))
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    assert jf == tf
    # default instances (SlamConfig's nested configs come from factories)
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())


@pytest.mark.parametrize("n", [500, 1000, 1024])
def test_level_budgets(n):
    assert OrbConfig(n_features=n).level_budgets() == j_orb.OrbConfig(n_features=n).level_budgets()
    assert OrbConfig().level_scales() == j_orb.OrbConfig().level_scales()


# ------------------------------------------------------------ robust, camera


def test_huber(rng):
    chi2 = (rng.rand(200) * 20).astype(f32)
    for d2 in (j_robust.CHI2_MONO, j_robust.CHI2_STEREO):
        np.testing.assert_allclose(
            robust.huber_weight(torch.tensor(chi2), d2).numpy(),
            np.asarray(j_robust.huber_weight(jnp.asarray(chi2), jnp.float32(d2))), rtol=1e-6)
        np.testing.assert_allclose(
            robust.huber_cost(torch.tensor(chi2), d2).numpy(),
            np.asarray(j_robust.huber_cost(jnp.asarray(chi2), jnp.float32(d2))), rtol=1e-6)
    assert (robust.CHI2_MONO, robust.CHI2_STEREO) == (j_robust.CHI2_MONO, j_robust.CHI2_STEREO)


@pytest.mark.parametrize("dist", [None, [-0.28, 0.07, 2e-4, 2e-5]])
def test_pinhole(rng, dist):
    params = [458.0, 457.0, 367.2, 248.4]
    jc, tc = JPinhole(params, 752, 480, dist), Pinhole(params, 752, 480, dist)
    X = np.stack([rng.randn(100), rng.randn(100), rng.rand(100) * 4 + 1], 1).astype(f32)
    np.testing.assert_allclose(tc.project(torch.tensor(X)).numpy(),
                               np.asarray(jc.project(jnp.asarray(X))), rtol=1e-6)
    np.testing.assert_allclose(tc.project_np(X), jc.project_np(X))
    uv = (rng.rand(100, 2) * [752, 480]).astype(f32)
    np.testing.assert_allclose(tc.unproject(torch.tensor(uv)).numpy(),
                               np.asarray(jc.unproject(jnp.asarray(uv))), rtol=1e-6)
    assert tc.has_distortion() == jc.has_distortion()
    np.testing.assert_allclose(tc.undistort_points(torch.tensor(uv)).numpy(),
                               np.asarray(jc.undistort_points(jnp.asarray(uv))), atol=1e-3)


# ------------------------------------------------------------ image, FAST


def test_gaussian_blur(rng):
    im = _img(rng)
    taps = torch.tensor(image.gaussian_kernel1d())
    got = image.gaussian_blur(torch.tensor(im), taps).numpy()
    np.testing.assert_allclose(got, np.asarray(j_image.gaussian_blur(jnp.asarray(im))), atol=1e-4)


def test_pyramid(rng):
    im = _img(rng, 240, 376)
    got = image.build_pyramid(torch.tensor(im), 8, 1.2)
    ref = j_image.build_pyramid(jnp.asarray(im), 8, 1.2)
    assert image.pyramid_shapes(240, 376, 8, 1.2) == j_image.pyramid_shapes(240, 376, 8, 1.2)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-3)


def test_fast_nms_gate_exact_level0(rng):
    im = _img(rng, integer=True)
    ti, ji = torch.tensor(im), jnp.asarray(im)
    s_t, s_j = fast.fast_score(ti), j_fast.fast_score(ji)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j))
    g_t = fast.cell_threshold_gate(s_t, 20.0, 7.0, cell=32)
    g_j = j_fast.cell_threshold_gate(s_j, 20.0, 7.0, cell=32)
    assert np.array_equal(g_t.numpy(), np.asarray(g_j))
    assert np.array_equal(fast.nms3x3(g_t).numpy(), np.asarray(j_fast.nms3x3(g_j)))
    assert (fast.nms3x3(g_t) > 0).sum() > 50


def test_nms_plateau_tie_break():
    s = np.zeros((12, 14), f32)
    s[3:6, 4:8] = 9.0       # the f32 epsilon is below 9.0's ulp: ties stay
    s[1:3, 1:3] = 0.25      # resolvable: only the first pixel survives
    s[9, 10] = 3.0
    got = fast.nms3x3(torch.tensor(s)).numpy()
    assert np.array_equal(got, np.asarray(j_fast.nms3x3(jnp.asarray(s))))
    assert got[9, 10] == 3.0 and got[3, 4] == 9.0
    assert np.count_nonzero(got[1:3, 1:3]) == 1 and got[1, 1] == 0.25


# ------------------------------------------------------------ patch gather


@pytest.mark.parametrize("size", [5, 31, 37, MAX_SIZE])
def test_patch_plain_matches_xla_and_tpu_interpret(rng, size):
    h, w = 480, 752
    img = (rng.rand(h, w) * 255.0).astype(f32)
    k = 64
    yx = np.stack([rng.randint(0, h - size, k), rng.randint(0, w - size, k)], -1).astype(np.int32)
    got = patch_cuda.extract_patches(torch.tensor(img), torch.tensor(yx), size).numpy()
    assert np.array_equal(got, np.asarray(_extract_patches_xla(jnp.asarray(img), jnp.asarray(yx), size)))
    assert np.array_equal(got, np.asarray(
        _extract_patches_tpu(jnp.asarray(img), jnp.asarray(yx), size, interpret=True)))


def test_patch_plain_edge_keypoints(rng):
    h, w, size = 96, 200, 37
    img = rng.rand(h, w).astype(f32)
    yx = np.array([(0, 0), (0, w - size), (h - size, 0), (h - size, w - size),
                   (7, 127), (8, 128)], np.int32)
    got = patch_cuda.extract_patches(torch.tensor(img), torch.tensor(yx), size).numpy()
    assert np.array_equal(got, np.asarray(_extract_patches_xla(jnp.asarray(img), jnp.asarray(yx), size)))
    assert np.array_equal(got, np.asarray(
        _extract_patches_tpu(jnp.asarray(img), jnp.asarray(yx), size, interpret=True)))


def test_patch_wrapper_uses_plain_on_cpu_and_rejects_other_devices():
    img = torch.zeros(50, 60)
    yx = torch.zeros(3, 2, dtype=torch.int32)
    before = patch_cuda.counter.launches
    assert patch_cuda.extract_patches(img, yx, 37).shape == (3, 37, 37)
    assert patch_cuda.counter.launches == before
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img.to("meta"), yx.to("meta"), 37)


@pytest.mark.parametrize("sizes,counts", [([(480, 752), (400, 627), (333, 522)], [64, 0, 40]),
                                          ([(96, 200)], [6]),
                                          ([(518, 790), (190, 302)], [0, 9])])
def test_patch_levels_plain_is_the_per_level_gathers(rng, sizes, counts):
    """The multi-level gather: bitwise the per-level plain gathers,
    concatenated, and tpuslam's XLA gather level by level (a level may
    have no keypoints)."""
    size = 37
    imgs = [torch.tensor((rng.rand(h, w) * 255.0).astype(f32)) for h, w in sizes]
    yx = [np.stack([rng.randint(0, h - size + 1, n), rng.randint(0, w - size + 1, n)], -1)
          for (h, w), n in zip(sizes, counts)]
    if counts[0]:
        h, w = sizes[0]
        yx[0][:2] = [(0, 0), (h - size, w - size)]
    yx_all = torch.tensor(np.concatenate(yx).astype(np.int32))
    got = patch_cuda.extract_patches_levels(imgs, yx_all, counts, size)
    assert got.shape == (sum(counts), size, size)
    k = 0
    for img, c, q in zip(imgs, counts, yx):
        ref = patch_cuda.extract_patches_plain(img, torch.tensor(q.astype(np.int32)), size)
        assert torch.equal(got[k:k + c], ref)
        xla = _extract_patches_xla(jnp.asarray(img.numpy()), jnp.asarray(q.astype(np.int32)), size)
        assert np.array_equal(got[k:k + c].numpy(), np.asarray(xla))
        k += c


def test_patch_levels_wrapper_dispatch():
    """CPU tensors take the plain version (no launch); a level or corner
    tensor off the CPU and off the card is refused, also when mixed."""
    imgs = [torch.zeros(50, 60), torch.zeros(40, 50)]
    yx = torch.zeros(5, 2, dtype=torch.int32)
    before = patch_cuda.counter.launches
    assert patch_cuda.extract_patches_levels(imgs, yx, [3, 2], 37).shape == (5, 37, 37)
    assert patch_cuda.counter.launches == before
    with pytest.raises(ValueError):
        patch_cuda.extract_patches_levels(imgs, yx.to("meta"), [3, 2], 37)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches_levels([imgs[0].to("meta"), imgs[1]], yx, [3, 2], 37)


# ------------------------------------------------------------ matching


def _bits(rng, n):
    return (rng.rand(n, 256) > 0.5).astype(np.uint8)


def test_hamming_matrix_and_packed(rng):
    a, b = _bits(rng, 40), _bits(rng, 70)
    ref = np.asarray(j_ham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = hamming.hamming_matrix(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)
    pa, pb = orb.pack_bits(torch.tensor(a)), orb.pack_bits(torch.tensor(b))
    assert pa.dtype == torch.uint32
    assert np.array_equal(pa.numpy(), np.asarray(j_orb.pack_bits(jnp.asarray(a))))
    ref_p = np.asarray(j_ham.hamming_packed(jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy())))
    assert np.array_equal(hamming.hamming_packed(pa, pb).numpy(), ref_p)
    assert np.array_equal(ref_p, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_best2_with_ties(seed):
    rng = np.random.RandomState(seed)
    dist = rng.randint(0, 6, (50, 40)).astype(np.int32)   # many ties
    mask = rng.rand(50, 40) > 0.3
    mask[0] = False                                       # an empty row
    jd, jm = jnp.asarray(dist), jnp.asarray(mask)
    td, tm = torch.tensor(dist), torch.tensor(mask)
    for got, ref in zip(match.masked_best2(td, tm), j_match.masked_best2(jd, jm)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(match.masked_best2_idx(td, tm), j_match.masked_best2_idx(jd, jm)):
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rotation_consistency_with_ties(seed):
    rng = np.random.RandomState(seed)
    n = 60
    # few distinct angle offsets -> tied histogram bins
    a = (rng.randint(0, 6, n) * (2 * np.pi / 30) + 0.01).astype(f32)
    b = np.zeros(n, f32)
    valid = rng.rand(n) > 0.2
    ref = np.asarray(j_match.rotation_consistency(jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid)))
    got = match.rotation_consistency(torch.tensor(a), torch.tensor(b), torch.tensor(valid))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_duplicates(seed):
    rng = np.random.RandomState(seed)
    n, m = 80, 30
    idx = rng.randint(0, m, n).astype(np.int32)
    best = rng.randint(0, 5, n).astype(np.int32)          # equal-distance duplicates
    valid = rng.rand(n) > 0.2
    ref = j_match.resolve_duplicates(jnp.asarray(idx), jnp.asarray(best), jnp.asarray(valid), m)
    got = match.resolve_duplicates(torch.tensor(idx), torch.tensor(best), torch.tensor(valid), m)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_window_and_level_masks(rng):
    a = (rng.rand(30, 2) * 100).astype(f32)
    b = (rng.rand(50, 2) * 100).astype(f32)
    r = (rng.rand(30) * 20).astype(f32)
    assert np.array_equal(match.window_mask(torch.tensor(a), torch.tensor(b), torch.tensor(r)).numpy(),
                          np.asarray(j_match.window_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(r))))
    pl, ob = rng.randint(0, 8, 30).astype(np.int32), rng.randint(0, 8, 50).astype(np.int32)
    assert np.array_equal(match.level_mask(torch.tensor(pl), torch.tensor(ob), 1, 0).numpy(),
                          np.asarray(j_match.level_mask(jnp.asarray(pl), jnp.asarray(ob), 1, 0)))


# ------------------------------------------------------------ stereo


def _stereo_feats(rng, n=120, h=240, w=376, octave0=False):
    xy_l = np.stack([rng.randint(40, w - 40, n), rng.randint(20, h - 20, n)], 1).astype(f32)
    disp = rng.randint(2, 30, n).astype(f32)
    xy_r = xy_l - np.stack([disp, np.zeros(n, f32)], 1)
    oct_ = np.zeros(n, np.int32) if octave0 else rng.randint(0, 3, n).astype(np.int32)
    bits_l = _bits(rng, n)
    bits_r = bits_l.copy()
    flip = rng.rand(n, 256) < 0.1
    bits_r[flip] ^= 1
    return bits_l, bits_r, xy_l, xy_r, oct_


def test_stereo_match_exact(rng):
    bits_l, bits_r, xy_l, xy_r, oct_ = _stereo_feats(rng)
    valid = np.ones(len(oct_), bool)
    sf = (1.2 ** np.arange(8)).astype(f32)
    ref = j_stereo.stereo_match(*map(jnp.asarray, (bits_l, bits_r, xy_l, xy_r, oct_, oct_, valid, valid, sf)),
                                0.3, 200.0)
    got = stereo.stereo_match(*map(torch.tensor, (bits_l, bits_r, xy_l, xy_r, oct_, oct_, valid, valid, sf)),
                              0.3, 200.0)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert got[2].sum() > 50


def test_sad_refine_pyramid(rng):
    """Exact at octave 0 (level 0 is bitwise equal and the SADs are sums of
    integers); other octaves read pyramid levels that agree to 5e-3."""
    h, w = 240, 376
    img_l = np.round(j_image.gaussian_blur(jnp.asarray(_img(rng, h, w))))
    img_l = np.asarray(img_l, f32)
    img_r = np.roll(img_l, -7, axis=1)
    for octave0 in (True, False):
        _, _, xy_l, _, oct_ = _stereo_feats(rng, octave0=octave0)
        u_r0 = (xy_l[:, 0] - 7 + rng.randint(-2, 3, len(oct_))).astype(f32)
        ok = np.ones(len(oct_), bool)
        ref = j_stereo.sad_refine_pyramid(*map(jnp.asarray, (img_l, img_r, xy_l, oct_, u_r0, ok)))
        got = stereo.sad_refine_pyramid(*map(torch.tensor, (img_l, img_r, xy_l, oct_, u_r0, ok)))
        if octave0:
            for g, r in zip(got, ref):
                assert np.array_equal(g.numpy(), np.asarray(r))
        else:
            assert np.mean(got[2].numpy() == np.asarray(ref[2])) >= 0.95
            both = got[2].numpy() & np.asarray(ref[2])
            np.testing.assert_allclose(got[0].numpy()[both], np.asarray(ref[0])[both], atol=0.05)
