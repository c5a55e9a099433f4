"""The port's Kannala-Brandt (KB8) fisheye camera and the solvers that
project through it, against tpuslam's, on the CPU.

Inputs are made with numpy from a seed and go through both sides. f64
cases compare like with like (the suite runs JAX with x64); every part
also gets an f32 case.
  * The camera: kb8_project / kb8_jac / kb8_unproject within 1e-9 (f64),
    f32 within 1e-3 px, 1e-5 relative on the Jacobian, 1e-6 on rays; the
    f32 rounding of the parameters and the spec as tpuslam's.
  * cam_uv_jac / cam_residual of a kb8 rig: left rows, right-camera rows
    through Trl (is_right) and the bf/z row of stereo rows; 1e-9 (f64),
    1e-5 relative (f32).
  * pose_optimize through the KB8 model (tests/test_kb8_solvers.py:52,83)
    and its dispatcher: the same R, t within 1e-8 (f64) or 2e-4 / 2e-3
    (f32), equal inliers, no pose-LM kernel route; BA with left and rig
    right-camera observations (1e-6, f64; 2e-4 / 2e-3 for f32 against
    tpuslam's f64). pose_inertial_solve and vi_ba_solve with a kb8 spec:
    tests/test_torch_vi_solve.py.
  * Sim3 RANSAC (JAX's own sample indices) and optimize_sim3 through the
    KB8 projection, to 1e-9; two-view reconstruction and PnP fed
    KB8-unprojected rays (camera-agnostic) recover the pose.
  * The normalized-coordinate epipolar gate of the triangulation matcher
    (f64 and f32) and a fisheye mapper's new-point creation on the same
    map: equal matches and equal map states.
  * The fisheye renderer: within 1e-6 of tpuslam's frames (f64
    unprojection on both sides, different libraries); eval/ate equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import KannalaBrandt8 as JKB8
from tpuslam.cameras import kb8 as JK
from tpuslam.engine import local_mapping as j_lm
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.map_device import make_tri_kernel
from tpuslam.eval import ate as j_ate
from tpuslam.io.synthetic import SyntheticSequence as JSyntheticSequence
from tpuslam.map.store import FrameFeatures as JFrameFeatures
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.solve import ba as j_ba
from tpuslam.solve import reproj as j_reproj
from tpuslam.solve import sim3 as JS
from tpuslam.solve.pose_opt import pose_optimize as j_pose_optimize
from tpuslam_torch.cameras import KannalaBrandt8
from tpuslam_torch.cameras import kb8 as K
from tpuslam_torch.engine.config import SlamConfig
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.map_device import tri_candidates, unpack_desc
from tpuslam_torch.eval import ate
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.store import FrameFeatures, SlamMap
from tpuslam_torch.ops import twoview as TV
from tpuslam_torch.solve import ba, pnp, pose_opt_cuda, reproj, sim3
from tpuslam_torch.solve.pose_opt import pose_optimize
from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

from test_kb8_solvers import KB_PARAMS, _rot, _scene
from test_torch_map import _assert_same_state
from test_torch_vi_solve import close

torch.set_num_threads(2)
W = H = 512
# tests/test_kb8_solvers.py's right camera of the TUM-VI 512 rig
KB_R = [190.44236969414825, 190.4344384721956, 252.59949716835982, 254.91723064636983,
        0.0034003170790442797, 0.001766278153469831, -0.00266312569781606,
        0.0003299517423931039]
DT = {"f64": (np.float64, torch.float64, jnp.float64), "f32": (np.float32, torch.float32,
                                                               jnp.float32)}


def Tt(a, dtype=torch.float64):
    a = np.asarray(a)
    return torch.tensor(a) if a.dtype == bool else torch.tensor(a, dtype=dtype)


def _rig():
    Trl = np.eye(4)
    Trl[:3, :3] = _rot([0.0, 1.0, 0.0], 0.02)
    Trl[:3, 3] = [-0.101, 0.0018, -0.0014]
    return Trl


def _points(rng, n):
    X = rng.randn(n, 3)
    X[:, 2] = np.abs(X[:, 2]) + 0.3
    X[0] = [0.0, 0.0, 2.0]                 # on the optical axis (r = 0)
    X[1] = [1.0, 0.0, 0.3]                 # ~73 degrees off axis
    return X


# ----------------------------------------------------------------- camera


@pytest.mark.parametrize("dt", list(DT))
def test_kb8_camera_matches_tpuslam(rng, dt):
    npd, td, jd = DT[dt]
    cam, jcam = KannalaBrandt8(KB_PARAMS, W, H, lapping=(0, 511)), JKB8(KB_PARAMS, W, H,
                                                                         lapping=(0, 511))
    assert cam.full_params == jcam.full_params and cam.lapping == jcam.lapping == (0, 511)
    assert cam.spec == reproj.CamSpec(kind="kb8", k=jcam.spec.k) and cam.spec.k == jcam.spec.k
    assert cam.full_params[0] == float(np.float32(KB_PARAMS[0]))   # f32 rounding as tpuslam
    X = _points(rng, 256).astype(npd)
    p, jp = cam.full_params, jcam.full_params
    uv = K.kb8_project(p, Tt(X, td))
    juv = np.asarray(JK.kb8_project(jp, jnp.asarray(X, jd)))
    J = K.kb8_jac(p, Tt(X, td))
    jJ = np.asarray(JK.kb8_jac(jp, jnp.asarray(X, jd)))
    ang = rng.uniform(0, 2 * np.pi, 256)
    rad = rng.uniform(0, 240, 256)
    px = np.stack([cam.cx + rad * np.cos(ang), cam.cy + rad * np.sin(ang)], -1).astype(npd)
    px[0] = [cam.cx, cam.cy]
    rays = K.kb8_unproject(p, Tt(px, td))
    jrays = np.asarray(JK.kb8_unproject(jp, jnp.asarray(px, jd)))
    assert uv.dtype == J.dtype == rays.dtype == td
    if dt == "f64":
        np.testing.assert_allclose(uv.numpy(), juv, atol=1e-9, rtol=0)
        np.testing.assert_allclose(J.numpy(), jJ, atol=1e-9, rtol=0)
        np.testing.assert_allclose(rays.numpy(), jrays, atol=1e-9, rtol=0)
        np.testing.assert_allclose(cam.project_np(X), juv, atol=1e-9, rtol=0)
        np.testing.assert_allclose(cam.project(rays).numpy()[1:], px[1:], atol=1e-6)
    else:
        np.testing.assert_allclose(uv.numpy(), juv, atol=1e-3, rtol=0)
        np.testing.assert_allclose(J.numpy(), jJ, atol=1e-5 * np.abs(jJ).max(), rtol=0)
        np.testing.assert_allclose(rays.numpy(), jrays, atol=1e-6, rtol=0)


# ------------------------------------------------------------- residuals


@pytest.mark.parametrize("case", [("left", "f64"), ("rig", "f64"), ("rig", "f32")])
def test_kb8_cam_uv_jac_matches_tpuslam(rng, case):
    """Left rows, right-camera rows through Trl and the bf/z row of stereo
    rows, through project_residuals (pose and point Jacobians too)."""
    kind, dt = case
    npd, td, jd = DT[dt]
    cam, cam2 = JKB8(KB_PARAMS, W, H), JKB8(KB_R, W, H)
    Trl = _rig() if kind == "rig" else None
    spec = j_reproj.make_kb8_spec(cam, cam2 if Trl is not None else None, Trl)
    tspec = reproj.make_kb8_spec(KannalaBrandt8(KB_PARAMS, W, H),
                                 KannalaBrandt8(KB_R, W, H) if Trl is not None else None, Trl)
    assert tspec == reproj.CamSpec(spec.kind, spec.k, spec.k2, spec.Trl)
    n = 200
    X = _scene(rng, n).astype(npd)
    st = rng.rand(n) < 0.5
    right = rng.rand(n) < 0.5 if Trl is not None else None
    uvr = np.concatenate([rng.uniform(0, W, (n, 2)), rng.uniform(0, 60, (n, 1))], 1).astype(npd)
    bf = 0.1 * cam.fx
    Rj, tj = np.asarray(_rot([0.2, 1.0, 0.1], 0.05), npd), np.array([0.1, -0.05, 0.08], npd)
    got = reproj.project_residuals(Tt(Rj, td), Tt(tj, td), Tt(X, td), Tt(uvr, td), Tt(st),
                                   cam.fx, cam.fy, cam.cx, cam.cy, bf, tspec,
                                   None if right is None else Tt(right))
    ref = j_reproj.project_residuals(jnp.asarray(Rj), jnp.asarray(tj), jnp.asarray(X),
                                     jnp.asarray(uvr), jnp.asarray(st), cam.fx, cam.fy, cam.cx,
                                     cam.cy, bf, spec,
                                     None if right is None else jnp.asarray(right))
    uvp, Jp, z = reproj.cam_uv_jac(Tt(X, td), Tt(st), cam.fx, cam.fy, cam.cx, cam.cy, bf, tspec,
                                   None if right is None else Tt(right))
    juvp, jJp, jz = j_reproj.cam_uv_jac(jnp.asarray(X), jnp.asarray(st), cam.fx, cam.fy, cam.cx,
                                        cam.cy, bf, spec,
                                        None if right is None else jnp.asarray(right))
    for a, b in zip(list(got) + [uvp, Jp, z], list(ref) + [juvp, jJp, jz]):
        b = np.asarray(b, np.float64)
        assert a.dtype == td
        tol = 1e-9 if dt == "f64" else 1e-5 * max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
    # the stereo rows' third row is bf / z of the left depth, 0 elsewhere
    zl = X[:, 2]
    np.testing.assert_allclose(uvp[:, 2].numpy(), np.where(st, bf / zl, 0.0), rtol=1e-5)
    if right is not None:
        assert (z.numpy()[right] != zl[right]).all()


# ---------------------------------------------------------------- pose LM


def _kb8_pose_problem(rng, rig, npd):
    """tests/test_kb8_solvers.py's pose problems: wide-FOV points,
    noise-free KB8 pixels, half of them through the rig's right camera."""
    cam, cam2 = JKB8(KB_PARAMS, W, H), JKB8(KB_R, W, H)
    Trl = _rig() if rig else None
    spec = j_reproj.make_kb8_spec(cam, cam2 if rig else None, Trl)
    X = _scene(rng, n=240 if rig else 200)
    R_gt = _rot([0.1, 0.8, -0.2], 0.04) if rig else _rot([0.3, 1.0, 0.1], 0.05)
    t_gt = np.array([-0.06, 0.02, 0.1]) if rig else np.array([0.1, -0.05, 0.08])
    Xc = X @ R_gt.T + t_gt
    uv = np.asarray(JK.kb8_project(cam.full_params, jnp.asarray(Xc)))
    is_right = np.zeros(len(X), bool)
    if rig:
        is_right = rng.rand(len(X)) < 0.5
        Xr = Xc @ Trl[:3, :3].T + Trl[:3, 3]
        uv = np.where(is_right[:, None], np.asarray(JK.kb8_project(cam2.full_params,
                                                                   jnp.asarray(Xr))), uv)
    n = len(X)
    arrays = (np.eye(3, dtype=npd), np.zeros(3, npd), X.astype(npd),
              np.concatenate([uv, np.zeros((n, 1))], -1).astype(npd), np.ones(n, npd),
              np.zeros(n, bool), np.ones(n, bool))
    return arrays, (cam.fx, cam.fy, cam.cx, cam.cy, 0.0), spec, is_right, (R_gt, t_gt)


@functools.lru_cache
def _jax_pose(kind):
    """A pose problem (from RandomState(0)) and tpuslam's f64 solve of it."""
    prob = _kb8_pose_problem(np.random.RandomState(0), kind == "rig", np.float64)
    arrays, scalars, spec, is_right, _ = prob
    jr = jnp.asarray(is_right) if kind == "rig" else None
    return prob, [np.asarray(o) for o in j_pose_optimize(*map(jnp.asarray, arrays), *scalars,
                                                         cam=spec, is_right=jr)]


@pytest.mark.parametrize("case", [("mono", "f64"), ("rig", "f64"), ("rig", "f32")])
def test_pose_optimize_kb8_matches_tpuslam(case):
    """The f32 case is held against tpuslam's f64 solve."""
    kind, dt = case
    td = DT[dt][1]
    (arrays, scalars, spec, is_right, (R_gt, t_gt)), (Rj, tj, inlj, _) = _jax_pose(kind)
    tspec = reproj.CamSpec(spec.kind, spec.k, spec.k2, spec.Trl)
    tr = Tt(is_right) if kind == "rig" else None
    R, t, inl, chi2 = pose_optimize(*[Tt(a, td) for a in arrays], *scalars, cam=tspec,
                                    is_right=tr)
    before = pose_opt_cuda.counter.launches
    Rb, tb, inlb, _ = pose_optimize_best(*[Tt(a, td) for a in arrays], *scalars, cam=tspec,
                                         is_right=tr)
    assert pose_opt_cuda.counter.launches == before      # the generic solver, no kernel
    assert R.dtype == Rb.dtype == td and torch.equal(R, Rb) and torch.equal(inl, inlb)
    tol_R, tol_t = (1e-8, 1e-8) if dt == "f64" else (2e-4, 2e-3)
    np.testing.assert_allclose(R.numpy(), Rj, atol=tol_R, rtol=0)
    np.testing.assert_allclose(t.numpy(), tj, atol=tol_t, rtol=0)
    assert np.mean(inl.numpy() == inlj) >= (1.0 if dt == "f64" else 0.97)
    assert int(inl.sum()) >= 0.95 * len(inl)
    err = np.linalg.norm(t.numpy() - t_gt) + np.linalg.norm(R.numpy() - R_gt)
    assert err < (1e-5 if dt == "f64" else 1e-3), err


# ------------------------------------------------------------------ BA


def _kb8_ba_problem(rng, rig):
    """tests/test_kb8_solvers.py:118's window (4 poses, 60 points), and
    for the rig the right camera's observations of every point too."""
    cam, cam2 = JKB8(KB_PARAMS, W, H), JKB8(KB_R, W, H)
    Trl = _rig()
    spec = j_reproj.make_kb8_spec(cam, cam2 if rig else None, Trl if rig else None)
    P, K = 60, 4
    X_gt = _scene(rng, n=P, z_range=(3.0, 6.0))
    R_gt = [np.eye(3)] + [_rot([0.1, 1.0, 0.05], 0.03 * k) for k in range(1, K)]
    t_gt = [np.zeros(3)] + [np.array([0.15 * k, 0.02 * k, -0.05 * k]) for k in range(1, K)]
    obs_kf, obs_pt, uvr, right = [], [], [], []
    for k in range(K):
        Xc = X_gt @ R_gt[k].T + t_gt[k]
        views = [(False, Xc, cam)]
        if rig:
            views.append((True, Xc @ Trl[:3, :3].T + Trl[:3, 3], cam2))
        for is_r, Xv, c in views:
            uv = np.asarray(JK.kb8_project(c.full_params, jnp.asarray(Xv)))
            inb = (Xv[:, 2] > 0.1) & (np.abs(uv[:, 0] - c.cx) < 250) & (np.abs(uv[:, 1] - c.cy)
                                                                        < 250)
            for j in np.where(inb)[0]:
                obs_kf.append(k)
                obs_pt.append(j)
                uvr.append([uv[j, 0], uv[j, 1], 0.0])
                right.append(is_r)
    O = len(obs_kf)
    R0 = [R_gt[0]] + [_rot(rng.randn(3), 0.01) @ R_gt[k] for k in range(1, K)]
    t0 = [t_gt[0]] + [t_gt[k] + rng.randn(3) * 0.02 for k in range(1, K)]
    X0 = X_gt + rng.randn(P, 3) * 0.03
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = (np.stack(R0), np.stack(t0), X0, np.asarray(obs_kf, np.int32),
            np.asarray(obs_pt, np.int32), np.asarray(uvr), np.ones(O), np.zeros(O, bool),
            np.ones(O, bool), fixed, cam.fx, cam.fy, cam.cx, cam.cy, 0.0)
    return args, spec, (np.asarray(right) if rig else None), (R_gt, t_gt)


@functools.lru_cache
def _jax_ba(kind):
    prob = _kb8_ba_problem(np.random.RandomState(0), kind == "rig")
    args, spec, right, _ = prob
    return prob, j_ba.ba_solve_np(*args, n_iters=15, cam=spec, right=right)


@pytest.mark.parametrize("case", [("mono", "f64"), ("rig", "f64"), ("rig", "f32")])
def test_ba_kb8_matches_tpuslam(case):
    """tpuslam's ba_solve_np solves in f64 here, the f32 case included."""
    kind, dt = case
    (args, spec, right, (R_gt, t_gt)), jo = _jax_ba(kind)
    tspec = reproj.CamSpec(spec.kind, spec.k, spec.k2, spec.Trl)
    to = ba.ba_solve_np(*args, n_iters=15, cam=tspec, right=right, device="cpu",
                        dtype=DT[dt][1])
    tol = [1e-6] * 3 if dt == "f64" else [2e-4, 2e-3, 2e-3]
    for a, b, tl, name in zip(to[:3], jo[:3], tol, ("R", "t", "X")):
        np.testing.assert_allclose(a, np.asarray(b), atol=tl, rtol=0, err_msg=name)
    assert np.array_equal(to[4], np.asarray(jo[4]))
    if dt == "f64":
        np.testing.assert_allclose(to[3], np.asarray(jo[3]), atol=1e-9, rtol=1e-6)
    assert np.median(to[3]) < 1e-6
    if kind == "rig":
        # the rig's right camera fixes the scale: no alignment needed
        for k in range(1, 4):
            assert np.linalg.norm(to[1][k] - t_gt[k]) < 5e-3, k


# ------------------------------------------------------------------ Sim3


def _kb8_sim3_problem(rng, N=80, outlier_frac=0.3, s=1.8):
    cam = JKB8(KB_PARAMS, W, H)
    R = _rot(rng.randn(3), 0.4)
    t = rng.randn(3) * 0.5
    X1 = _scene(rng, N, z_range=(2.0, 6.0))
    X2 = s * X1 @ R.T + t
    X2[:, 2] += 3.0
    t = t + np.array([0, 0, 3.0])
    out = rng.choice(N, int(N * outlier_frac), replace=False)
    X2[out] += rng.randn(len(out), 3) * 1.0

    def proj(X):
        return np.asarray(JK.kb8_project(cam.full_params, jnp.asarray(X)))

    return cam, X1, X2, proj(X1), proj(X2), (s, R, t)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_sim3_kb8_matches_tpuslam(rng, dt):
    """sim3_ransac with JAX's own randint samples, then optimize_sim3 from
    a perturbed truth, both projecting through KB8."""
    cam, X1, X2, uv1, uv2, (s, R, t) = _kb8_sim3_problem(rng)
    spec = j_reproj.make_kb8_spec(cam)
    tspec = reproj.CamSpec(spec.kind, spec.k)
    td = DT[dt][1]
    N = len(X1)
    valid = np.ones(N, bool)
    valid[3] = False
    key = jax.random.PRNGKey(0)
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    oj = JS.sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), jnp.asarray(uv1),
                        jnp.asarray(uv2), jnp.ones(N), jnp.ones(N), *intr, key, n_hyp=256,
                        cam=spec)
    idx = np.asarray(jax.random.randint(key, (256, 3), 0, int(valid.sum())))
    one = torch.ones(N, dtype=td)
    ot = sim3.sim3_ransac(Tt(X1, td), Tt(X2, td), Tt(valid), Tt(uv1, td), Tt(uv2, td), one, one,
                          *intr, idx=idx, n_hyp=256, cam=tspec)
    assert int(oj["n_inliers"]) >= 50
    if dt == "f64":
        assert int(ot["n_inliers"]) == int(oj["n_inliers"])
        assert np.array_equal(ot["inliers"].numpy(), np.asarray(oj["inliers"]))
        for k in ("s", "R", "t"):
            close(ot[k], oj[k], 1e-9)
    else:
        assert abs(int(ot["n_inliers"]) - int(oj["n_inliers"])) <= 2
        close(ot["R"], oj["R"], 1e-3)
    close(ot["R"], R, 0.02)
    s0, R0, t0 = s * 1.05, R @ _rot([0.3, -0.2, 0.1], 0.03), t + rng.randn(3) * 0.05
    args = (s0, R0, t0, X1, X2, valid, uv1, uv2, np.ones(N), np.ones(N))
    oj = JS.optimize_sim3(*[jnp.asarray(a) for a in args], *intr, n_iters=15, cam=spec)
    ot = sim3.optimize_sim3(*[Tt(a, td) for a in args], *intr, n_iters=15, cam=tspec)
    for a, b in zip(ot[:3], oj[:3]):
        close(a, b, 1e-9 if dt == "f64" else 1e-3)
    if dt == "f64":
        assert np.array_equal(ot[3].numpy(), np.asarray(oj[3]))
    close(ot[0], s, 5e-3)


# ------------------------------------------- camera-agnostic ray solvers


def _kb8_rays(cam, X, rng, noise_px=0.3):
    """Rays of KB8 pixels of camera-frame points (pixel noise added), as
    the frontend makes them: kb8_unproject, then the z = 1 coordinates."""
    uv = np.asarray(JK.kb8_project(cam.full_params, jnp.asarray(X)))
    uv = uv + rng.randn(*uv.shape) * noise_px
    rays = np.asarray(JK.kb8_unproject(cam.full_params, jnp.asarray(uv)))
    np.testing.assert_allclose(K.kb8_unproject(cam.full_params, Tt(uv)).numpy(), rays,
                               atol=1e-9)
    return rays[:, :2] / rays[:, 2:3]


def test_two_view_and_pnp_on_kb8_rays(rng):
    """ops/twoview and solve/pnp work on normalized rays (their parity with
    tpuslam is tests/test_torch_geometry.py's), so a fisheye feeds them
    KB8-unprojected rays unchanged: from 0.3 px noisy fisheye pixels of
    points up to 75 degrees off axis they recover the relative pose."""
    cam = JKB8(KB_PARAMS, W, H)
    X = _scene(rng, n=300, z_range=(3.0, 8.0))
    R21 = _rot([0.02, -0.06, 0.01], 0.07)
    t21 = np.array([0.6, 0.05, 0.02])
    x1 = _kb8_rays(cam, X, rng)
    x2 = _kb8_rays(cam, X @ R21.T + t21, rng)
    valid = np.ones(len(X), bool)
    valid[:5] = False
    ot = TV.reconstruct_two_views(Tt(x1), Tt(x2), Tt(valid),
                                  generator=torch.Generator().manual_seed(0))
    assert bool(ot["success"]) and not bool(ot["used_h"])
    assert int(ot["n_good"]) > 200
    close(ot["R21"], R21, 5e-3)
    t = ot["t21"].numpy()
    assert np.dot(t / np.linalg.norm(t), t21 / np.linalg.norm(t21)) > 0.999
    rt = pnp.pnp_ransac(Tt(X), Tt(x2), torch.ones(len(X), dtype=torch.float64), Tt(valid),
                        generator=torch.Generator().manual_seed(1), n_hyp=512,
                        focal2=cam.fx ** 2)
    assert int(rt["n_inliers"]) >= 250 and not rt["inliers"].numpy()[~valid].any()
    close(rt["R"], R21, 5e-3)
    close(rt["t"], t21, 2e-2)


# ------------------------------------------------- the KB8 epipolar gate


def _gate_problem(rng, n=160, T=3):
    """A KB8 keyframe and T neighbours 25 cm apart seeing the same points:
    normalized ray coordinates, essential matrices, KB8 thresholds, and
    descriptors equal up to 2 % flipped bits for the true pairs."""
    cam = JKB8(KB_PARAMS, W, H)
    X = _scene(rng, n=n, z_range=(2.0, 6.0))
    bits = rng.randint(0, 2, (n, 256)).astype(np.uint8)
    ang = rng.uniform(0, 2 * np.pi, n)
    poses = [(np.eye(3), np.zeros(3))] + [(_rot(rng.randn(3), 0.02),
                                           np.array([-0.25 * k, 0.02 * k, 0.0]))
                                          for k in range(1, T + 1)]
    views = []
    for R, t in poses:
        perm = rng.permutation(n)
        b = bits[perm].copy()
        b[rng.rand(n, 256) < 0.02] ^= 1
        views.append(dict(xy=_kb8_rays(cam, X[perm] @ R.T + t, rng), bits=b, ang=ang[perm],
                          octave=rng.randint(0, 3, n), perm=perm))
    R1, t1 = poses[0]
    Es = []
    for R2, t2 in poses[1:]:
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        Es.append(np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]],
                            [-t12[1], t12[0], 0]]) @ R12)
    sf = 1.2 ** np.arange(8)
    sig2 = np.stack([3.84 * sf[v["octave"]] ** 2 / cam.fx ** 2 for v in views[1:]])
    return views, np.stack(Es), sig2, cam


def _packed(bits):
    return (bits.reshape(len(bits), 8, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_kb8_epipolar_gate_matches_tpuslam(rng, dt):
    """The triangulation matcher with the normalized-coordinate essential
    gate (tpuslam's make_tri_kernel step against tri_candidates): the same
    matches, and every match a true pair."""
    npd, td, jd = DT[dt]
    views, Es, sig2, _ = _gate_problem(rng)
    own, nbr = views[0], views[1:]
    n = len(own["xy"])
    free1 = np.ones(n, bool)
    free1[:10] = False
    tfree = np.ones((len(nbr), n), bool)
    oxyh = np.concatenate([own["xy"], np.ones((n, 1))], 1).astype(npd)
    gxy = np.stack([v["xy"] for v in nbr]).astype(npd)
    jargs = (jnp.asarray(_packed(own["bits"])), jnp.asarray(own["ang"], jd), jnp.asarray(oxyh),
             jnp.asarray(free1), jnp.asarray(Es, jd), jnp.asarray(gxy), jnp.asarray(tfree),
             jnp.asarray(sig2, jd),
             jnp.asarray(np.stack([_packed(v["bits"]) for v in nbr])),
             jnp.asarray(np.stack([v["ang"] for v in nbr]), jd))
    ji, jdist = (np.asarray(x) for x in make_tri_kernel()(*jargs))
    tpack = np.stack([_packed(v["bits"]) for v in nbr]).astype(np.int64)
    ti, tdist = tri_candidates(
        Tt(_packed(own["bits"]).astype(np.int64), torch.int64), Tt(own["ang"], td), Tt(oxyh, td),
        Tt(free1), Tt(Es, td), Tt(gxy, td), Tt(tfree), Tt(sig2, td), Tt(tpack, torch.int64),
        Tt(np.stack([v["ang"] for v in nbr]), td))
    assert np.array_equal(ti.numpy(), ji) and np.array_equal(tdist.numpy(), jdist)
    assert torch.equal(unpack_desc(Tt(tpack[0], torch.int64)), Tt(nbr[0]["bits"], torch.uint8))
    hit = np.nonzero(ji >= 0)[0]
    assert len(hit) > 60
    t_idx, i2 = ji[hit] // n, ji[hit] % n
    truth = np.array([nbr[t]["perm"][i] for t, i in zip(t_idx, i2)])
    assert np.mean(truth == own["perm"][hit]) > 0.98


def _kb8_map(FF, SM, rng_seed=5, n_kf=3, n_feat=160):
    """A fisheye map: KB8 keyframes 30 cm apart, 60 points of KF 0 seen by
    the others, the rest of each KF's features free (new-point material)."""
    rng = np.random.RandomState(rng_seed)
    cam = JKB8(KB_PARAMS, W, H)
    X = _scene(rng, n=n_feat, z_range=(2.0, 6.0))
    bits = rng.randint(0, 2, (n_feat, 256)).astype(np.uint8)
    ang = rng.uniform(0, 2 * np.pi, n_feat)
    m = SM(n_feat)
    for k in range(n_kf):
        R = _rot(rng.randn(3), 0.01)
        t = np.array([-0.3 * k, 0.0, 0.0])
        uv = np.asarray(JK.kb8_project(cam.full_params, jnp.asarray(X @ R.T + t)))
        uv = uv + rng.randn(n_feat, 2) * 0.3
        norm = np.asarray(JK.kb8_unproject(cam.full_params, jnp.asarray(uv)))[:, :2]
        b = bits.copy()
        b[rng.rand(n_feat, 256) < 0.02] ^= 1
        m.add_keyframe(R, t, FF(xy=uv, und_xy=uv.copy(), norm_xy=norm,
                                octave=np.zeros(n_feat, np.int32), angle=ang.copy(),
                                response=np.ones(n_feat), bits=b, packed=_packed(b),
                                valid=np.ones(n_feat, bool)), 0.1 * k, k)
    for j in range(60):
        mp = m.add_point(X[j], 0, j)
        for k in range(1, n_kf):
            m.add_observation(mp, k, j)
    for k in range(n_kf):
        m.update_connections(k)
    return m, cam


def test_kb8_mapper_new_points_match_tpuslam():
    """A fisheye mapper's CreateNewMapPoints (the kb8 branch: essential
    gate in normalized coordinates, KB8 reprojection gates): tpuslam's and
    the port's create the same points on the same map."""
    jm, jcam = _kb8_map(JFrameFeatures, JSlamMap)
    tm, _ = _kb8_map(FrameFeatures, SlamMap)
    jlm = j_lm.LocalMapper(jcam, JSlamConfig(), jm, mono=False, bf=19.0)
    tlm = LocalMapper(KannalaBrandt8(KB_PARAMS, W, H), SlamConfig(), tm, bf=19.0, mono=False,
                      device="cpu", dtype=torch.float64)
    assert tlm.camspec.kind == "kb8"
    seen = []
    real = tlm.devk.tri_match
    tlm.devk.tri_match = lambda *a: seen.append(a[6]) or real(*a)
    n_j = jlm._create_new_points(2)
    n_t = tlm._create_new_points(2)
    assert seen == [True]                      # the normalized gate
    assert n_t == n_j > 40
    _assert_same_state(jm, tm)


# ------------------------------------------------------ renderer and ATE


def test_fisheye_render_matches_tpuslam():
    """The KB8 rig sequence of tests/test_e2e_fisheye.py: left and right
    frames within 1e-6 (gray levels 0..255) of tpuslam's, the same ground
    truth, and the rig extrinsic's right camera."""
    from test_e2e_fisheye import KB_L, KB_R as KB_R256

    Trl = np.eye(4)
    Trl[:3, 3] = [-0.2, 0.0, 0.0]
    js = JSyntheticSequence(n_frames=4, fps=10, speed=0.5, camera=JKB8(KB_L, 256, 256),
                            camera2=JKB8(KB_R256, 256, 256), Trl=Trl)
    ts = SyntheticSequence(n_frames=4, fps=10, speed=0.5, camera=KannalaBrandt8(KB_L, 256, 256),
                           camera2=KannalaBrandt8(KB_R256, 256, 256), Trl=Trl)
    assert (ts.height, ts.width, ts.fx, ts.cx) == (js.height, js.width, js.fx, js.cx)
    for i in (0, 3):
        for right in (False, True):
            a, b = ts.frame(i, right=right), js.frame(i, right=right)
            assert a.dtype == b.dtype and a.shape == (256, 256)
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
            assert a.std() > 10.0
        for x, y in zip(ts.gt_pose_cw(i / 10), js.gt_pose_cw(i / 10)):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(ts.frame(1), ts.frame(1, right=True))


def test_ate_matches_tpuslam(rng):
    gt = np.cumsum(rng.randn(50, 3) * 0.1, 0)
    R = _rot([0.2, 0.5, 1.0], 0.7)
    est = (gt @ R.T * 0.6 + [1.0, -2.0, 0.5]) + rng.randn(50, 3) * 0.01
    for with_scale in (False, True):
        for a, b in zip(ate.horn_align(est, gt, with_scale), j_ate.horn_align(est, gt, with_scale)):
            np.testing.assert_allclose(a, b, atol=1e-12)
        assert ate.ate_rmse(est, gt, with_scale) == j_ate.ate_rmse(est, gt, with_scale)
    assert ate.ate_rmse(est, gt, True)[0] < 0.03
    t_gt = np.arange(0, 5, 0.05)
    t_est = np.sort(rng.uniform(-0.2, 5.2, 60))
    for x, y in zip(ate.associate(t_est, t_gt), j_ate.associate(t_est, t_gt)):
        np.testing.assert_array_equal(x, y)
