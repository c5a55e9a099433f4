"""The host solvers of the port vs tpuslam: Lie ops, the SPD solve,
reprojection residuals, the camera-generic pose LM and its dispatcher,
and bundle adjustment (both Schur paths).

Inputs are made with numpy from a seed and fed to both sides. f64 cases
compare like with like (the suite runs JAX with x64): Lie, linalg and
reproj to 1e-10, BA to 1e-6. The pose LM uses the tolerances of
tests/test_pose_opt_pallas.py (R 2e-4, t 2e-3, inlier agreement > 0.97).
Every solver also gets one f32 case: Lie and linalg against tpuslam in
f32 (1e-5; rtol 1e-3 for the scaled solve), the pose LM against tpuslam
in f32, BA in f32 against tpuslam's ba_solve_np, which always solves in
f64 here (2e-4 on poses, 2e-3 on points: f32 rounding of a 10-step LM).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import lie as j_lie
from tpuslam.core import linalg as j_linalg
from tpuslam.solve import ba as j_ba
from tpuslam.solve import reproj as j_reproj
from tpuslam.solve.pose_opt import pose_optimize as j_pose_optimize
from tpuslam_torch.core import lie, linalg
from tpuslam_torch.solve import ba, pose_opt_cuda, reproj
from tpuslam_torch.solve.pose_opt import pose_optimize
from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

torch.set_num_threads(2)
DT = {"f64": (np.float64, torch.float64, 1e-10), "f32": (np.float32, torch.float32, 1e-5)}


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------------- lie


@pytest.mark.parametrize("dt", list(DT))
def test_lie_matches_tpuslam(rng, dt):
    npd, td, tol = DT[dt]
    xi = rng.randn(64, 6).astype(npd)
    xi[:8, 3:] *= 1e-5                    # the small-angle branch
    xi[8:16, 3:] *= 3.0                   # large angles
    Rj, tj = j_lie.se3_exp(jnp.asarray(xi))
    R, t = lie.se3_exp(_t(xi, td))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=tol)
    np.testing.assert_allclose(lie.so3_exp(_t(xi[:, 3:], td)).numpy(),
                               np.asarray(j_lie.so3_exp(jnp.asarray(xi[:, 3:]))), atol=tol)
    Ri, ti = lie.se3_inverse(R, t)
    Rij, tij = j_lie.se3_inverse(Rj, tj)
    np.testing.assert_allclose(Ri.numpy(), np.asarray(Rij), atol=tol)
    np.testing.assert_allclose(ti.numpy(), np.asarray(tij), atol=tol)
    q = lie.rot_to_quat(R).numpy()
    np.testing.assert_allclose(q, np.asarray(j_lie.rot_to_quat(Rj)), atol=10 * tol)
    assert (q[:, 3] >= 0).all()


def test_hat(rng):
    w = rng.randn(5, 3)
    np.testing.assert_array_equal(lie.hat(torch.tensor(w)).numpy(),
                                  np.asarray(j_lie.hat(jnp.asarray(w))))


# ---------------------------------------------------------------- linalg


def _spd(rng, n, batch=(), scale=True):
    A = rng.randn(*batch, 2 * n, n)
    H = np.swapaxes(A, -1, -2) @ A
    if scale:  # fx^2-scaled pixel terms against unit rotation terms
        s = np.sqrt(np.r_[np.full(n // 2, 1e5), np.ones(n - n // 2)])
        H = H * s[:, None] * s[None, :]
    return H, rng.randn(*batch, n)


@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("damping", [0.0, 1e-3])
def test_spd_solve_matches_tpuslam(rng, dt, damping):
    npd, td, _ = DT[dt]
    H, b = _spd(rng, 6, (4,))
    H, b = H.astype(npd), b.astype(npd)
    ref = np.asarray(j_linalg.spd_solve(jnp.asarray(H), jnp.asarray(b), damping=damping))
    got = linalg.spd_solve(_t(H, td), _t(b, td), damping=damping).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3 if dt == "f32" else 1e-8,
                               atol=1e-6 if dt == "f32" else 1e-12)


def test_spd_solve_guards(rng):
    """Dead variables (zero diagonal) get dx = 0; an indefinite matrix gives
    dx = 0 instead of raising, as the JAX version returns zeros."""
    H, b = _spd(rng, 6, scale=False)
    H[2, :] = H[:, 2] = 0.0
    dx = linalg.spd_solve(torch.tensor(H), torch.tensor(b)).numpy()
    ref = np.asarray(j_linalg.spd_solve(jnp.asarray(H), jnp.asarray(b)))
    assert dx[2] == 0.0
    np.testing.assert_allclose(dx, ref, atol=1e-10)
    bad = -np.eye(6)
    assert not linalg.spd_solve(torch.tensor(bad), torch.tensor(b)).numpy().any()
    assert not np.asarray(j_linalg.spd_solve(jnp.asarray(bad), jnp.asarray(b))).any()


# ---------------------------------------------------------------- reproj


def test_project_residuals_matches_tpuslam(rng):
    n = 50
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 1], -1)
    uvr = rng.rand(n, 3) * 300
    st = rng.rand(n) < 0.5
    R, t = j_lie.se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.02, 0.01, -0.03]))
    cam = (458.0, 457.0, 376.0, 240.0, 50.0)
    ref = j_reproj.project_residuals(R, t, jnp.asarray(X), jnp.asarray(uvr), jnp.asarray(st),
                                     *cam)
    got = reproj.project_residuals(torch.tensor(np.asarray(R)), torch.tensor(np.asarray(t)),
                                   torch.tensor(X), torch.tensor(uvr), torch.tensor(st), *cam)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-9)
    chi = reproj.obs_chi2(got[0], torch.ones(n), torch.tensor(st))
    np.testing.assert_allclose(chi.numpy(), np.asarray(j_reproj.obs_chi2(ref[0], 1.0, st)))


def test_kb8_spec_raises():
    """A kb8 CamSpec no longer raises: its residuals (mono and stereo rows,
    the bf/z third row) equal tpuslam's to 1e-10; an unknown kind raises.
    The rig and f32 cases: tests/test_torch_kb8.py."""
    spec = reproj.CamSpec(kind="kb8", k=(0.1, 0.02, -0.01, 0.001))
    rng = np.random.RandomState(0)
    X = np.stack([rng.randn(40), rng.randn(40), rng.rand(40) * 3 + 0.5], -1)
    uvr = rng.rand(40, 3) * 300
    st = rng.rand(40) < 0.5
    cam = (190.0, 191.0, 256.0, 250.0, 38.0)
    got = reproj.cam_residual(torch.tensor(X), torch.tensor(uvr), torch.tensor(st), *cam, spec)
    ref = j_reproj.cam_residual(jnp.asarray(X), jnp.asarray(uvr), jnp.asarray(st), *cam,
                                j_reproj.CamSpec(kind="kb8", k=spec.k))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="omni"):
        reproj.cam_uv_jac(torch.ones(4, 3), torch.zeros(4, dtype=torch.bool), 1.0, 1.0, 0.0,
                          0.0, 0.0, reproj.CamSpec(kind="omni"))


# --------------------------------------------------------------- pose LM


def _pose_problem(n=300, stereo=False, outliers=30, seed=0, npd=np.float64):
    """As tests/test_pose_opt_pallas.py builds it."""
    rng = np.random.RandomState(seed)
    fx = fy = 458.0
    cx, cy = 376.0, 240.0
    bf = 47.9 if stereo else 0.0
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 2], -1)
    u = fx * X[:, 0] / X[:, 2] + cx
    v = fy * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3) * 0.3
    uvr[:outliers] += rng.randn(outliers, 3) * 40
    is_stereo = np.zeros(n, bool)
    if stereo:
        is_stereo[: n // 2] = True
    dR, dt = j_lie.se3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.02, -0.015, 0.01], npd))
    arrays = (np.asarray(dR, npd), np.asarray(dt, npd), X.astype(npd), uvr.astype(npd),
              np.ones(n, npd), is_stereo, np.ones(n, bool))
    return arrays, (fx, fy, cx, cy, bf)


@pytest.mark.parametrize("case", [("mono", "f64"), ("stereo", "f64"), ("stereo", "f32")])
def test_pose_optimize_matches_tpuslam(case):
    kind, dt = case
    npd, td, _ = DT[dt]
    arrays, scalars = _pose_problem(stereo=kind == "stereo", npd=npd)
    Rj, tj, inlj, _ = [np.asarray(o) for o in
                       j_pose_optimize(*map(jnp.asarray, arrays), *scalars)]
    R, t, inl, chi2 = pose_optimize(*[torch.tensor(a) for a in arrays], *scalars)
    assert R.dtype == td and chi2.shape == (300,)
    np.testing.assert_allclose(R.numpy(), Rj, atol=2e-4)
    np.testing.assert_allclose(t.numpy(), tj, atol=2e-3)
    assert np.mean(inl.numpy() == inlj) > 0.97


def test_pose_optimize_best_routes_pinhole_to_the_fused_kernel():
    """Pinhole: the fused route (its plain version on CPU tensors, no
    launch), f64 host inputs cast to f32, padded invalid rows never
    inliers; against tpuslam's pose_optimize at the Pallas tolerances. A
    kb8 spec goes to the camera-generic solver in the input's dtype."""
    arrays, scalars = _pose_problem(n=700, stereo=True)
    nb = 768
    pad = [np.concatenate([a, np.zeros((nb - 700,) + a.shape[1:], a.dtype)]) for a in arrays[2:]]
    padded = list(arrays[:2]) + pad
    before = pose_opt_cuda.counter.launches
    R, t, inl, _ = pose_optimize_best(*[torch.tensor(a) for a in padded], *scalars)
    assert pose_opt_cuda.counter.launches == before
    assert R.dtype == torch.float32 and inl.shape == (nb,) and not inl[700:].any()
    Rj, tj, inlj, _ = [np.asarray(o) for o in
                       j_pose_optimize(*map(jnp.asarray, arrays), *scalars)]
    np.testing.assert_allclose(R.numpy(), Rj, atol=2e-4)
    np.testing.assert_allclose(t.numpy(), tj, atol=2e-3)
    assert np.mean(inl.numpy()[:700] == inlj) > 0.97
    kb8 = reproj.CamSpec(kind="kb8", k=(0.0, 0.0, 0.0, 0.0))
    Rk, tk, inlk, _ = pose_optimize_best(*[torch.tensor(a) for a in arrays], *scalars, cam=kb8)
    Rg, tg, inlg, _ = pose_optimize(*[torch.tensor(a) for a in arrays], *scalars, cam=kb8)
    assert pose_opt_cuda.counter.launches == before and Rk.dtype == torch.float64
    assert torch.equal(Rk, Rg) and torch.equal(tk, tg) and torch.equal(inlk, inlg)


# ------------------------------------------------------------------- BA


def _ba_window(seed=0, K=5, P=120, npd=np.float64):
    """A synthetic window: K poses along x, P points in front, every point
    seen by 2..K cameras, 40 % stereo observations, 1-px noise, a few
    gross outliers; poses and points perturbed from the truth."""
    rng = np.random.RandomState(seed)
    fx = fy = 200.0
    cx, cy, bf = 188.0, 120.0, 20.0
    Rs = np.stack([np.asarray(j_lie.so3_exp(jnp.asarray(rng.randn(3) * 0.02))) for _ in range(K)])
    ts = np.stack([np.array([-0.1 * k, 0.0, 0.0]) for k in range(K)]) + rng.randn(K, 3) * 0.01
    Xw = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P), rng.uniform(2, 5, P)], -1)
    okf, opt, uvr, st = [], [], [], []
    for j in range(P):
        for k in sorted(rng.choice(K, rng.randint(2, K + 1), replace=False)):
            Xc = Rs[k] @ Xw[j] + ts[k]
            u, v = fx * Xc[0] / Xc[2] + cx, fy * Xc[1] / Xc[2] + cy
            s = rng.rand() < 0.4
            okf.append(k)
            opt.append(j)
            uvr.append([u, v, u - bf / Xc[2] if s else 0.0])
            st.append(s)
    uvr = np.array(uvr) + np.c_[rng.randn(len(okf), 2), rng.randn(len(okf))] * 1.0
    uvr[~np.array(st), 2] = 0.0
    uvr[:6, :2] += 30.0
    O = len(okf)
    inv_s2 = 1.2 ** (-2.0 * rng.randint(0, 3, O))
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    R0 = Rs.copy()
    t0 = ts.copy()
    for k in range(2, K):
        R0[k] = np.asarray(j_lie.so3_exp(jnp.asarray(rng.randn(3) * 0.005))) @ Rs[k]
        t0[k] = ts[k] + rng.randn(3) * 0.02
    X0 = Xw + rng.randn(P, 3) * 0.03
    cast = lambda a: np.asarray(a, npd)  # noqa: E731
    return (cast(R0), cast(t0), cast(X0), np.array(okf, np.int32), np.array(opt, np.int32),
            cast(uvr), cast(inv_s2), np.array(st), np.ones(O, bool), fixed), (fx, fy, cx, cy, bf)


def test_build_obs_pairs_matches_tpuslam(rng):
    obs_pt = rng.randint(0, 30, 200)
    for a, b in zip(ba.build_obs_pairs(obs_pt, 30), j_ba.build_obs_pairs(obs_pt, 30)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", [("dense", "f64"), ("cg", "f64"), ("dense", "f32")])
def test_ba_solve_np_matches_tpuslam(case, monkeypatch):
    """Both Schur paths of ba_solve_np against tpuslam's dense path (the
    CG path is forced by a zero pair threshold; 30 PCG iterations reach
    the dense solve's step to ~1e-7 on this window)."""
    path, dt = case
    npd, td, _ = DT[dt]
    arrays, cam = _ba_window(npd=npd)
    if path == "cg":
        monkeypatch.setattr(ba, "CG_MIN_PAIRS", 0)
    Rj, tj, Xj, chi2j, poszj = j_ba.ba_solve_np(*arrays, *cam, n_iters=10)
    R, t, X, chi2, posz = ba.ba_solve_np(*arrays, *cam, n_iters=10, device="cpu", dtype=td)
    tol_pose, tol_pt = (1e-6, 1e-5) if dt == "f64" else (2e-4, 2e-3)
    np.testing.assert_allclose(R, Rj, atol=tol_pose)
    np.testing.assert_allclose(t, tj, atol=tol_pose)
    np.testing.assert_allclose(X, Xj, atol=tol_pt)
    assert np.array_equal(posz, poszj)
    assert np.mean((chi2 > 5.991) == (chi2j > 5.991)) > 0.99
    np.testing.assert_array_equal(R[:2], arrays[0][:2])   # fixed poses stay
    # the solve improves the perturbed window
    c0 = ba.ba_chi2(*[torch.tensor(a) for a in arrays[:8]], *cam)[0].numpy()
    assert np.median(chi2) < 0.5 * np.median(c0)
