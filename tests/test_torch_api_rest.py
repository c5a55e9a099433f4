"""The last public functions of tpuslam: the PyTorch port against tpuslam
(JAX on the CPU), inputs made with numpy from a seed.

Tolerances:
  * sad_refine on the cases of tests/test_stereo_subpixel.py: u_r within
    1e-4 px, `good` equal, the best SAD within 1e-4 relative (f32 sums in
    another order);
  * the fused step with fused_sad="level0" against make_fused_step(...,
    sad="level0") on rendered frames, as
    tests/test_torch_track_step.py::test_fused_step_matches_jax_on_rendered_frames:
    rotation 5e-4, translation 5e-3, depth 1e-3;
  * OrbExtractor.extract_pair: bits, xy and octave bitwise;
  * the helpers, in f64: 1e-9 where both sides do the same arithmetic,
    1e-6 through an SVD or Cholesky (LAPACK on one side, XLA's on the
    other); masks and integer distances exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

import tpuslam.engine.track_device as j_td
from tpuslam.cameras import KannalaBrandt8 as JKB8
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.core import lie as j_lie
from tpuslam.core import linalg as j_linalg
from tpuslam.core import robust as j_robust
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.ops import hamming as j_ham
from tpuslam.ops import match as j_match
from tpuslam.ops import orb as j_orb
from tpuslam.ops import stereo as j_stereo
from tpuslam.solve.pose_opt_pallas import pose_optimize_fused
from tpuslam_torch.cameras import KannalaBrandt8, Pinhole
from tpuslam_torch.core import lie, linalg, robust
from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.local_map import stereo_local_map
from tpuslam_torch.ops import hamming, match, orb, stereo

torch.set_num_threads(2)
f32 = np.float32
T = torch.tensor
# tests/test_cameras.py's EuRoC cam0 (rad-tan) and TUM-VI 512 (KB8)
EUROC = ([458.654, 457.296, 367.215, 248.375], 752, 480,
         [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
TUMVI = ([190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
          0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
          0.00020293673591811182], 512, 512)


# ----------------------------------------------------------- sad_refine


def _bandlimited(xs, yy, f_hi):
    img = np.zeros_like(xs)
    st = np.random.RandomState(3)
    for _ in range(25):
        fx_, fy_ = st.uniform(0.05, f_hi, 2)
        ph = st.uniform(0, 2 * np.pi)
        a = st.uniform(5, 20)
        img += a * np.cos(fx_ * xs + fy_ * yy + ph)
    return img.astype(f32)


def _sad_case(name, rng):
    """The inputs of tests/test_stereo_subpixel.py's level-0 cases:
    (img_l, img_r, xy, u_r0, ok)."""
    if name == "junk":               # uncorrelated images, near-border rows
        H, W, N = 60, 80, 10
        img_l, img_r = rng.rand(H, W).astype(f32), rng.rand(H, W).astype(f32)
        xy = np.stack([rng.uniform(10, W - 10, N), rng.uniform(10, H - 10, N)], 1)
        return img_l, img_r, xy.astype(f32), (xy[:, 0] - 5.0).astype(f32), np.ones(N, bool)
    H, W = 120, 200
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    disp, f_hi, N, margin = (7.38, 0.5, 40, 20) if name == "subpixel" else (6.7, 0.4, 30, 30)
    img_l, img_r = _bandlimited(xx, yy, f_hi), _bandlimited(xx + disp, yy, f_hi)
    xy = np.stack([rng.uniform(margin, W - margin, N), rng.uniform(margin, H - margin, N)], 1)
    return img_l, img_r, xy.astype(f32), np.round(xy[:, 0] - disp).astype(f32), np.ones(N, bool)


@pytest.mark.parametrize("case", ["subpixel", "junk", "octave0"])
def test_sad_refine_matches_tpuslam(rng, case):
    args = _sad_case(case, rng)
    ju, jsad, jgood = (np.asarray(a) for a in j_stereo.sad_refine(*map(jnp.asarray, args)))
    u, sad, good = (a.numpy() for a in stereo.sad_refine(*map(T, args)))
    assert np.array_equal(good, jgood)
    np.testing.assert_allclose(u, ju, atol=1e-4)
    np.testing.assert_allclose(sad, jsad, rtol=1e-4)
    np.testing.assert_array_equal(u[~good], args[3][~good])     # a reject keeps u_r0
    if case == "subpixel":           # the parabola beats the integer match
        err = np.abs((args[2][:, 0] - u)[good] - 7.38)
        assert good.sum() > 0.8 * len(good) and np.median(err) < 0.25
    if case == "octave0":            # the pyramid variant at octave 0 is this kernel
        pu, _, pgood = stereo.sad_refine_pyramid(*map(T, args[:3]), torch.zeros(len(u)),
                                                 *map(T, args[3:]), n_levels=4, scale=1.2)
        np.testing.assert_allclose(pu.numpy(), u, atol=1e-4)
        assert np.array_equal(pgood.numpy(), good)


# ---------------------------------------------------- the level-0 fused step

H, W, N, P_BASE = 240, 376, 500, 512


def _u8(im):
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


def test_level0_fused_step_matches_tpuslam(monkeypatch):
    """TrackingConfig(fused_sad="level0") through FusedTrackStep against
    make_fused_step(..., sad="level0") on frames 1 and 2 of a rendered
    stereo sequence, both from the same local map of frame 0, the pose
    chained from tpuslam's."""
    monkeypatch.setattr(j_td, "_pose_solver",
                        lambda: functools.partial(pose_optimize_fused, interpret=True))
    seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
    frames = [np.stack([_u8(seq.frame(i)), _u8(seq.frame(i, right=True))]) for i in range(3)]
    bf = seq.fx * seq.baseline
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H)
    step = FusedTrackStep(cam, OrbConfig(n_features=N), TrackingConfig(fused_sad="level0"), 8,
                          1.2, bf, True, device="cpu")
    f0 = step.extract(torch.tensor(frames[0]))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.numpy() for k, v in f0.items()}, seq.fx, seq.fy, seq.cx,
                             seq.cy, step.sf.numpy(), p_base=P_BASE)
    jstep = j_td.make_fused_step(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H),
                                 j_orb.OrbConfig(n_features=N), JTrackingConfig(), 8, 1.2, bf,
                                 True, sad="level0")
    pose = np.concatenate([np.eye(3).ravel(), np.zeros(4)]).astype(f32)
    for i in (1, 2):
        args = (frames[i], *local, pose, f32([60.0]))
        jo = jstep(*[jnp.asarray(a) for a in args])
        to = step(*step_inputs_from_numpy(*args, device="cpu"))
        jp, tp = np.asarray(jo["pose"]), to["pose"].numpy()
        np.testing.assert_allclose(tp[:9], jp[:9], atol=5e-4)
        np.testing.assert_allclose(tp[9:12], jp[9:12], atol=5e-3)
        assert np.mean(to["assoc"].numpy() == np.asarray(jo["assoc"])) >= 0.95
        assert np.mean(to["rowflags"].numpy() == np.asarray(jo["rowflags"])) >= 0.98
        np.testing.assert_allclose(to["feats"]["depth"].numpy(),
                                   np.asarray(jo["feats"]["depth"]), atol=1e-3)
        assert int(tp[12]) >= 100
        pose = jp


def test_unknown_fused_sad_is_refused():
    cam = Pinhole([200.0, 200.0, 188.0, 120.0], W, H)
    with pytest.raises(ValueError, match="fused_sad"):
        FusedTrackStep(cam, OrbConfig(n_features=64), TrackingConfig(fused_sad="level1"), 8,
                       1.2, 20.0, True, device="cpu")


# ----------------------------------------------------- OrbExtractor's calls


def test_extract_pair_matches_tpuslam():
    """extract_pair at per-call FAST thresholds, against tpuslam's batched
    call, and against two single calls of the port; other thresholds give
    other keypoints."""
    seq = SyntheticSequence(n_frames=4, fps=20, speed=0.5, baseline=0.11)
    left, right = (_u8(seq.frame(1, right=r)).astype(f32) for r in (False, True))
    got = orb.OrbExtractor(OrbConfig(n_features=N), "cpu").extract_pair(
        T(left), T(right), 12.0, 5.0)
    want = j_orb.OrbExtractor(H, W, j_orb.OrbConfig(n_features=N)).extract_pair(
        left, right, 12.0, 5.0)
    ext = orb.OrbExtractor(OrbConfig(n_features=N), "cpu")
    for img, g, w in zip((left, right), got, want):
        for k in ("bits", "xy", "octave"):
            assert np.array_equal(g[k].numpy(), np.asarray(w[k])), k
        one = ext(T(img), 12.0, 5.0)
        assert all(torch.equal(one[k], g[k]) for k in g)
    default = ext(T(left))
    assert not torch.equal(default["xy"], got[0]["xy"])


# ------------------------------------------------------------- the helpers


def _rot(rng, n):
    return ScipyRot.from_rotvec(rng.randn(n, 3)).as_matrix()


def _spd(rng, n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


def _lie_case(name, rng):
    """(port function, tpuslam function, inputs, atol) of one helper of
    core/lie.py (tests/test_lie.py:45-122)."""
    if name == "so3_right_jacobian_inv":
        w = rng.randn(16, 3)
        w[0] = 1e-6                                      # the Taylor branch
        return lie.so3_right_jacobian_inv, j_lie.so3_right_jacobian_inv, (w,), 1e-9
    if name == "normalize_rotation":
        R = _rot(rng, 8) + rng.randn(8, 3, 3) * 1e-3
        return lie.normalize_rotation, j_lie.normalize_rotation, (R,), 1e-6
    if name == "se3_apply":
        return lie.se3_apply, j_lie.se3_apply, (_rot(rng, 8), rng.randn(8, 3),
                                                rng.randn(8, 3)), 1e-9
    if name == "se3_matrix":
        return lie.se3_matrix, j_lie.se3_matrix, (_rot(rng, 8), rng.randn(8, 3)), 0.0
    if name == "se3_from_matrix":
        Tm = np.tile(np.eye(4), (8, 1, 1))
        Tm[:, :3, :3], Tm[:, :3, 3] = _rot(rng, 8), rng.randn(8, 3)
        return lie.se3_from_matrix, j_lie.se3_from_matrix, (Tm,), 0.0
    q = rng.randn(64, 4)                                 # quat_to_rot: q need not be unit
    return lie.quat_to_rot, j_lie.quat_to_rot, (q,), 1e-9


@pytest.mark.parametrize("name", ["so3_right_jacobian_inv", "normalize_rotation", "se3_apply",
                                  "se3_matrix", "se3_from_matrix", "quat_to_rot"])
def test_lie_helper_matches_tpuslam(rng, name):
    fn, jfn, args, atol = _lie_case(name, rng)
    got = fn(*map(T, args))
    want = jfn(*map(jnp.asarray, args))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)
    out = got[0].numpy()
    if name == "so3_right_jacobian_inv":
        J = lie.so3_right_jacobian(T(args[0])).numpy()
        np.testing.assert_allclose(J @ out, np.broadcast_to(np.eye(3), J.shape), atol=1e-6)
    if name == "normalize_rotation":
        np.testing.assert_allclose(out @ out.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(3), out.shape), atol=1e-9)
        np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-9)
    if name == "quat_to_rot":
        np.testing.assert_allclose(out, ScipyRot.from_quat(args[0]).as_matrix(), atol=1e-9)
    if name == "se3_matrix":
        R, t = lie.se3_from_matrix(got[0])
        assert torch.equal(R, T(args[0])) and torch.equal(t, T(args[1]))


def _camera_pair(kind):
    if kind == "kb8":
        params, w, h = TUMVI
        return KannalaBrandt8(params, w, h), JKB8(params, w, h)
    params, w, h, dist = EUROC
    return Pinhole(params, w, h, dist=dist), JPinhole(params, w, h, dist=dist)


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
def test_project_jac_matches_tpuslam_and_autodiff(rng, kind):
    """tests/test_cameras.py:49-56,110-116: the analytic Jacobian against
    tpuslam's and against torch.func's of the port's own project."""
    cam, jcam = _camera_pair(kind)
    X = rng.randn(32, 3)
    X[:, 2] = np.abs(X[:, 2]) + (0.3 if kind == "kb8" else 0.5)
    J = cam.project_jac(T(X)).numpy()
    np.testing.assert_allclose(J, np.asarray(jcam.project_jac(jnp.asarray(X))), atol=1e-9)
    auto = torch.vmap(torch.func.jacfwd(cam.project))(T(X)).numpy()
    np.testing.assert_allclose(J, auto, atol=1e-6)


def test_distort_points_matches_tpuslam(rng):
    """tests/test_cameras.py:58-85: ideal -> distorted pixels, and the
    round trip through undistort_points."""
    cam, jcam = _camera_pair("pinhole")
    uv = np.stack([rng.uniform(100, cam.width - 100, 200),
                   rng.uniform(100, cam.height - 100, 200)], -1)
    got = cam.distort_points(T(uv)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcam.distort_points(jnp.asarray(uv))), atol=1e-9)
    back = cam.distort_points(cam.undistort_points(T(uv))).numpy()
    np.testing.assert_allclose(back, uv, atol=1e-2)
    uv_t = T(uv)
    assert Pinhole(EUROC[0], 752, 480).distort_points(uv_t) is uv_t    # no distortion


@pytest.mark.parametrize("damping", [0.0, 1e-2])
def test_masked_spd_solve_matches_tpuslam(rng, damping):
    """tests/test_linalg.py:71: fixed rows get dx = 0, the free block is
    the sub-system's solution."""
    H = np.stack([_spd(rng, 8) for _ in range(3)])
    b = rng.randn(3, 8)
    free = np.ones((3, 8), bool)
    free[:, [1, 6]] = False
    free[2, 3] = False
    got = linalg.masked_spd_solve(T(H), T(b), T(free), damping=damping).numpy()
    want = np.asarray(j_linalg.masked_spd_solve(jnp.asarray(H), jnp.asarray(b),
                                                jnp.asarray(free), damping=damping))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert (got[~free] == 0).all()
    if damping == 0.0:
        for i in range(3):
            idx = np.nonzero(free[i])[0]
            np.testing.assert_allclose(got[i, idx], np.linalg.solve(H[i][np.ix_(idx, idx)],
                                                                    b[i, idx]), rtol=1e-6)


def test_hamming_pairs_matches_tpuslam(rng):
    """tests/test_match.py:39."""
    a, b = ((rng.rand(20, 256) > 0.5).astype(np.uint8) for _ in range(2))
    got = hamming.hamming_pairs(T(a), T(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (a != b).sum(-1))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ham.hamming_pairs(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("mask", ["epipolar_mask", "epipolar_mask_np", "node_mask"])
def test_match_masks_match_tpuslam(rng, mask):
    if mask == "node_mask":
        a, b = rng.randint(0, 6, 30), rng.randint(0, 6, 40)
        got = match.node_mask(T(a), T(b)).numpy()
        want = np.asarray(j_match.node_mask(jnp.asarray(a), jnp.asarray(b)))
    else:
        lines = rng.randn(30, 3)
        lines[:, 2] *= 100
        xy = rng.uniform(0, 300, (40, 2))
        octave = rng.randint(0, 8, 40)
        sigma2 = 1.2 ** (2 * np.arange(8))
        want = np.asarray(getattr(j_match, mask)(jnp.asarray(xy), jnp.asarray(lines),
                                                 jnp.asarray(octave), sigma2))
        got = (match.epipolar_mask_np(xy, lines, octave, sigma2) if mask == "epipolar_mask_np"
               else match.epipolar_mask(T(xy), T(lines), T(octave), sigma2).numpy())
    assert got.dtype == bool and got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


def test_cauchy_weight_matches_tpuslam(rng):
    chi2 = rng.rand(100) * 20
    np.testing.assert_allclose(robust.cauchy_weight(T(chi2), 5.991).numpy(),
                               np.asarray(j_robust.cauchy_weight(jnp.asarray(chi2), 5.991)),
                               atol=1e-12)
