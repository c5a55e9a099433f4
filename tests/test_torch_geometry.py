"""The port's geometry solvers vs tpuslam's, on the CPU: two-view
reconstruction, PnP, Horn / Sim3 RANSAC / optimize_sim3, the Sim(3) Lie
ops, the pose graph (dense, and PCG past 256 vertices) and the essential
graph on a carried map.

The inputs are made with numpy from a seed and go through both sides.
Each RANSAC gets JAX's own samples: the test draws the indices
tpuslam's PRNG key yields (jax.random.choice / randint with the same key)
and hands them to the port as `idx`. The SVD null vector's sign is free,
so H, F and E are not compared; what callers consume is. Tolerances: f64
against f64 (tests/conftest.py turns on x64) to 1e-6 or tighter, stated
per test; one f32 case per solver against the f64 reference, with f32
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import lie as JL
from tpuslam.map.store import FrameFeatures as JFrameFeatures
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.ops import twoview as JTV
from tpuslam.solve import pnp as JP
from tpuslam.solve import pose_graph as JG
from tpuslam.solve import sim3 as JS
from tpuslam_torch.core import lie as L
from tpuslam_torch.map.store import map_from_numpy, map_state
from tpuslam_torch.ops import twoview as TV
from tpuslam_torch.solve import pnp as P
from tpuslam_torch.solve import pose_graph as G
from tpuslam_torch.solve import sim3 as S

torch.set_num_threads(2)
FX = FY = 300.0
CX = CY = 200.0


def T(a, dtype=torch.float64):
    a = np.asarray(a)
    return torch.tensor(a) if a.dtype == bool else torch.tensor(a, dtype=dtype)


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol)


# ------------------------------------------------------------------ two-view


def _pair(rng, planar=False, rotation_only=False, n=300):
    z = np.full(n, 5.0) if planar else rng.uniform(4, 8, n)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], -1)
    if planar:
        X[:, 2] += X[:, 0] * 0.1
    R = np.asarray(JL.so3_exp(jnp.asarray([0.02, -0.06, 0.01])))
    t = np.zeros(3) if rotation_only else np.array([0.6, 0.05, 0.02])
    x1 = X[:, :2] / X[:, 2:3]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:3]
    x1 = x1 + rng.randn(n, 2) * 0.5 / 400
    x2 = x2 + rng.randn(n, 2) * 0.5 / 400
    out = rng.choice(n, n // 10, replace=False)
    x2[out] += rng.uniform(0.05, 0.2, (len(out), 2))
    valid = np.ones(n, bool)
    valid[:5] = False
    return x1, x2, valid


def _jax_choice(valid, key):
    p = valid.astype(np.float32)
    return np.asarray(jax.random.choice(key, len(valid), shape=(JTV.N_HYP, 8),
                                        p=jnp.asarray(p / p.sum())))


@pytest.mark.parametrize("case", ["general_uses_f", "planar_uses_h", "pure_rotation"])
def test_two_view_matches_tpuslam(rng, case):
    """Same matches, same 200 x 8 samples (tpuslam's PRNGKey(0) draw):
    success, model choice, good mask equal; R21, t21, X to 1e-9."""
    x1, x2, valid = _pair(rng, planar=case == "planar_uses_h",
                          rotation_only=case == "pure_rotation")
    key = jax.random.PRNGKey(0)
    oj = JTV.reconstruct_two_views(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    ot = TV.reconstruct_two_views(T(x1), T(x2), T(valid), idx=_jax_choice(valid, key))
    assert bool(ot["success"]) == bool(oj["success"]) == (case != "pure_rotation")
    assert bool(ot["used_h"]) == bool(oj["used_h"])
    assert int(ot["n_good"]) == int(oj["n_good"])
    assert np.array_equal(ot["good"].numpy(), np.asarray(oj["good"]))
    if case == "pure_rotation":
        return
    assert bool(ot["used_h"]) == (case == "planar_uses_h")
    close(ot["R21"], oj["R21"], 1e-9)
    close(ot["t21"], oj["t21"], 1e-9)
    good = np.asarray(oj["good"])
    close(ot["X"].numpy()[good], np.asarray(oj["X"])[good], 1e-8)


def test_two_view_f32_and_own_draw(rng):
    """f32 inputs against the f64 reference on the same samples (R21 to
    1e-4, good masks 99 % equal), and the port's own seeded draw."""
    x1, x2, valid = _pair(rng)
    key = jax.random.PRNGKey(0)
    oj = JTV.reconstruct_two_views(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), key)
    o32 = TV.reconstruct_two_views(T(x1, torch.float32), T(x2, torch.float32), T(valid),
                                   idx=_jax_choice(valid, key))
    assert bool(o32["success"]) and not bool(o32["used_h"])
    close(o32["R21"], oj["R21"], 1e-4)
    assert np.mean(o32["good"].numpy() == np.asarray(oj["good"])) > 0.99
    own = TV.reconstruct_two_views(T(x1), T(x2), T(valid),
                                   generator=torch.Generator().manual_seed(0))
    idx = TV.draw_samples(T(valid), torch.Generator().manual_seed(0))
    assert idx.shape == (200, 8) and bool(T(valid)[idx].all())
    assert bool(own["success"])
    close(own["R21"], oj["R21"], 5e-3)


def test_triangulate_exact(rng):
    X = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1.5, 1.5, 50), rng.uniform(4, 8, 50)], -1)
    R = np.asarray(JL.so3_exp(jnp.asarray([0.1, 0.05, -0.02])))
    t = np.array([0.5, -0.1, 0.03])
    x1 = X[:, :2] / X[:, 2:3]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:3]
    Xt = TV.triangulate_batch(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64),
                              T(R), T(t), T(x1), T(x2))
    close(Xt, X, 1e-6)
    Xj = JTV.triangulate_batch(jnp.eye(3), jnp.zeros(3), jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(x1), jnp.asarray(x2))
    close(Xt, Xj, 1e-9)


# ----------------------------------------------------------------------- PnP


def _pnp_scene(rng, N):
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.4)))
    t = np.array([0.3, -0.2, 0.5])
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N), rng.uniform(4, 10, N)], 1)
    return R, t, (X - t) @ R, X[:, :2] / X[:, 2:3]


def test_dlt_exact(rng):
    R, t, Xw, xy = _pnp_scene(rng, 6)
    Re, te = P.dlt_pose(T(Xw[None]), T(xy[None]))
    close(Re[0], R, 1e-6)
    close(te[0], t, 1e-6)


@pytest.mark.parametrize("padded", [False, True])
def test_pnp_ransac_matches_tpuslam(rng, padded):
    """Outliers (or invalid padding rows), JAX's randint samples: inliers
    equal, R and t to 1e-8 (eigh/SVD of the two backends)."""
    R, t, Xw, xy = _pnp_scene(rng, 80)
    xy = xy.copy()
    out = rng.choice(80, 30, replace=False)
    xy[out] += rng.randn(30, 2) * 0.2
    valid = np.ones(80, bool)
    if padded:
        valid[50:] = False
        Xw[50:] = 0.0
    key = jax.random.PRNGKey(1)
    rj = JP.pnp_ransac(jnp.asarray(Xw), jnp.asarray(xy), jnp.ones(80), jnp.asarray(valid), key,
                       n_hyp=512, focal2=FX ** 2)
    idx = np.asarray(jax.random.randint(key, (512, 6), 0, int(valid.sum())))
    rt = P.pnp_ransac(T(Xw), T(xy), torch.ones(80, dtype=torch.float64), T(valid), idx=idx,
                      n_hyp=512, focal2=FX ** 2)
    assert int(rt["n_inliers"]) == int(rj["n_inliers"]) >= 30
    assert np.array_equal(rt["inliers"].numpy(), np.asarray(rj["inliers"]))
    assert not rt["inliers"].numpy()[~valid].any()
    close(rt["R"], rj["R"], 1e-8)
    close(rt["t"], rj["t"], 1e-8)
    close(rt["R"], R, 5e-3)
    r32 = P.pnp_ransac(T(Xw, torch.float32), T(xy, torch.float32), torch.ones(80), T(valid),
                       idx=idx, n_hyp=512, focal2=FX ** 2)
    close(r32["R"], rj["R"], 2e-3)


# ---------------------------------------------------------------------- Sim3


def _sim3_problem(rng, N=80, outlier_frac=0.3, s=1.8):
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.5)))
    t = rng.randn(3)
    X1 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-2, 2, N), rng.uniform(3, 9, N)], 1)
    X2 = s * X1 @ R.T + t
    X2[:, 2] += 10.0
    t = t + np.array([0, 0, 10.0])
    out = rng.choice(N, int(N * outlier_frac), replace=False)
    X2[out] += rng.randn(len(out), 3) * 3.0

    def proj(X):
        return np.stack([FX * X[:, 0] / X[:, 2] + CX, FY * X[:, 1] / X[:, 2] + CY], 1)

    return X1, X2, proj(X1), proj(X2), (s, R, t)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_matches_tpuslam(rng, fix_scale):
    s = 1.0 if fix_scale else 0.5 + rng.rand() * 2
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.5)))
    t = rng.randn(3)
    X1 = rng.randn(4, 20, 3)
    X2 = s * X1 @ R.T + t + rng.randn(4, 20, 3) * 0.01
    st, Rt, tt = S.horn_sim3(T(X1), T(X2), fix_scale=fix_scale)
    sj, Rj, tj = JS.horn_sim3(jnp.asarray(X1), jnp.asarray(X2), fix_scale=fix_scale)
    close(st, sj, 1e-12)
    close(Rt, Rj, 1e-12)
    close(tt, tj, 1e-12)
    close(Rt[0], R, 2e-2)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_tpuslam(rng, fix_scale):
    """JAX's randint samples; the LO refits included: s, R, t to 1e-9 and
    equal inliers."""
    X1, X2, uv1, uv2, (s, R, t) = _sim3_problem(rng, s=1.0 if fix_scale else 1.8)
    N = len(X1)
    valid = np.ones(N, bool)
    valid[3] = False
    key = jax.random.PRNGKey(0)
    oj = JS.sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), jnp.asarray(uv1),
                        jnp.asarray(uv2), jnp.ones(N), jnp.ones(N), FX, FY, CX, CY, key,
                        n_hyp=256, fix_scale=fix_scale)
    idx = np.asarray(jax.random.randint(key, (256, 3), 0, int(valid.sum())))
    one = torch.ones(N, dtype=torch.float64)
    ot = S.sim3_ransac(T(X1), T(X2), T(valid), T(uv1), T(uv2), one, one, FX, FY, CX, CY,
                       idx=idx, n_hyp=256, fix_scale=fix_scale)
    assert int(ot["n_inliers"]) == int(oj["n_inliers"]) >= 50
    assert np.array_equal(ot["inliers"].numpy(), np.asarray(oj["inliers"]))
    close(ot["s"], oj["s"], 1e-9)
    close(ot["R"], oj["R"], 1e-9)
    close(ot["t"], oj["t"], 1e-8)
    close(ot["R"], R, 0.02)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_tpuslam(rng, fix_scale):
    """Perturbed truth refined 15 iterations on both sides: s, R, t to
    1e-9, equal inliers; the f32 port within 1e-3 of the f64 reference."""
    X1, X2, uv1, uv2, (s, R, t) = _sim3_problem(rng, outlier_frac=0.1,
                                                s=1.0 if fix_scale else 1.8)
    N = len(X1)
    s0 = s * (1.0 if fix_scale else 1.1)
    R0 = R @ np.asarray(JL.so3_exp(jnp.asarray([0.03, -0.02, 0.01])))
    t0 = t + rng.randn(3) * 0.1
    args = (s0, R0, t0, X1, X2, np.ones(N, bool), uv1, uv2, np.ones(N), np.ones(N))
    oj = JS.optimize_sim3(*[jnp.asarray(a) for a in args], FX, FY, CX, CY, n_iters=15,
                          fix_scale=fix_scale)
    ot = S.optimize_sim3(*[T(a) for a in args], FX, FY, CX, CY, n_iters=15, fix_scale=fix_scale)
    for a, b in zip(ot[:3], oj[:3]):
        close(a, b, 1e-9)
    assert np.array_equal(ot[3].numpy(), np.asarray(oj[3])) and int(ot[4]) >= 0.85 * N
    close(ot[0], s, 5e-3)
    o32 = S.optimize_sim3(*[T(a, torch.float32) for a in args], FX, FY, CX, CY, n_iters=15,
                          fix_scale=fix_scale)
    assert o32[1].dtype == torch.float32
    close(o32[0], oj[0], 1e-3)
    close(o32[1], oj[1], 1e-3)


def test_sim3_lie_matches_tpuslam(rng):
    """exp / log / compose / inverse / apply on a batch, and exp(0)
    through jacfwd (the identity), to 1e-12."""
    xi = rng.randn(6, 7) * 0.4
    xi[0] = 0.0
    xi[1, 3:6] = 0.0                     # theta -> 0 branch
    xi[2, 6] = 0.0                       # sigma -> 0 branch
    st, Rt, tt = L.sim3_exp(T(xi))
    sj, Rj, tj = JL.sim3_exp(jnp.asarray(xi))
    for a, b in ((st, sj), (Rt, Rj), (tt, tj)):
        close(a, b, 1e-12)
    close(L.sim3_log(st, Rt, tt), xi, 1e-9)
    close(L.sim3_log(st, Rt, tt), JL.sim3_log(sj, Rj, tj), 1e-12)
    X = rng.randn(6, 3)
    close(L.sim3_apply(st, Rt, tt, T(X)), JL.sim3_apply(sj, Rj, tj, jnp.asarray(X)), 1e-12)
    a, b = (st, Rt, tt), tuple(x.flip(0) for x in (st, Rt, tt))
    ja, jb = (sj, Rj, tj), tuple(x[::-1] for x in (sj, Rj, tj))
    for p, q in zip(L.sim3_compose(*a, *b), JL.sim3_compose(*ja, *jb)):
        close(p, q, 1e-12)
    for p, q in zip(L.sim3_inverse(*a), JL.sim3_inverse(*ja)):
        close(p, q, 1e-12)
    Rpi = np.asarray(JL.so3_exp(jnp.asarray([np.pi - 1e-4, 0.002, -0.001])))
    close(L.so3_log(T(Rpi)), JL.so3_log(jnp.asarray(Rpi)), 1e-9)
    J = torch.func.jacfwd(lambda e: L.sim3_log(*L.sim3_exp(e)))(torch.zeros(1, 7, dtype=torch.float64))
    close(J[0, :, 0], np.eye(7), 1e-12)


# ---------------------------------------------------------------- pose graph


def _drift_loop(K, drift, rng, s_drift=0.0):
    w = 2 * np.pi / K
    Rgt, tgt = [], []
    for k in range(K):
        c, s = np.cos(w * k), np.sin(w * k)
        Rk = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        Rgt.append(Rk)
        tgt.append(-Rk @ np.array([5 * np.cos(w * k), 5 * np.sin(w * k), 0.0]))
    ei = np.r_[np.arange(K - 1), K - 1].astype(np.int32)
    ej = np.r_[np.arange(1, K), 0].astype(np.int32)
    Rm = np.stack([Rgt[b] @ Rgt[a].T for a, b in zip(ei, ej)])
    tm = np.stack([tgt[b] - Rm[i] @ tgt[a] for i, (a, b) in enumerate(zip(ei, ej))])
    R0, t0 = [Rgt[0]], [tgt[0]]
    for k in range(1, K):
        dR = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * drift)))
        Rrel = Rgt[k] @ Rgt[k - 1].T
        R0.append(dR @ Rrel @ R0[-1])
        t0.append(Rrel @ t0[-1] + tgt[k] - Rrel @ tgt[k - 1] + rng.randn(3) * drift)
    s0 = 1.0 + rng.randn(K) * s_drift
    s0[0] = 1.0
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (s0, np.stack(R0), np.stack(t0), ei, ej, np.ones(K), Rm, tm, np.ones(K), fixed), tgt


@pytest.mark.parametrize("fix_scale,use_cg", [(False, False), (True, False), (False, True)])
def test_pose_graph_matches_tpuslam(rng, fix_scale, use_cg):
    """A drifted 24-vertex ring with one loop edge, 15 LM iterations, dense
    or PCG: s, R, t and cost to 1e-9; the f32 port to 1e-3."""
    args, tgt = _drift_loop(24, 0.01, rng, s_drift=0.0 if fix_scale else 0.01)
    kw = dict(n_iters=15, fix_scale=fix_scale, use_cg=use_cg, n_cg=100)
    oj = JG.pose_graph_solve(*[jnp.asarray(a) for a in args], **kw)
    ot = G.pose_graph_solve(*[T(a) for a in args], **kw)
    for a, b in zip(ot, oj):
        close(a, b, 1e-9)
    assert float(ot[3]) < 1e-6
    if fix_scale:
        close(ot[0], 1.0, 1e-12)
    o32 = G.pose_graph_solve(*[T(a, torch.float32) for a in args], **kw)
    close(o32[1], oj[1], 1e-3)
    close(o32[2] / o32[0][:, None], np.stack(tgt), 0.05)


def test_pose_graph_pcg_past_256_vertices(rng):
    """K = 300 (the size where optimize_essential_graph switches to PCG):
    the port's PCG against tpuslam's to 1e-8, and near ground truth."""
    args, tgt = _drift_loop(300, 0.001, rng)
    kw = dict(n_iters=6, n_cg=400)
    oj = JG.pose_graph_solve(*[jnp.asarray(a) for a in args], use_cg=True, **kw)
    ot = G.pose_graph_solve(*[T(a) for a in args], use_cg=True, **kw)
    for a, b in zip(ot[:3], oj[:3]):
        close(a, b, 1e-8)
    assert float(ot[3]) < 1e-4
    close(ot[2] / ot[0][:, None], np.stack(tgt), 0.05)


def _carried_map(rng, n_kf=8, P=80):
    """A tpuslam map of a drifting keyframe chain (noisy poses, shared
    points) and the port's copy of it."""
    Xw = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], 1)
    m = JSlamMap(n_feat=P)
    mp_of = {}
    for k in range(n_kf):
        R = np.asarray(JL.so3_exp(jnp.asarray([0.0, 0.03 * k, 0.0])))
        t = np.array([0.1 * k, 0.0, 0.0])
        Xc = Xw @ R.T + t
        uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], 1)
        f = JFrameFeatures(xy=uv.copy(), und_xy=uv.copy(), norm_xy=Xc[:, :2] / Xc[:, 2:],
                           octave=np.zeros(P, np.int32), angle=np.zeros(P),
                           response=np.ones(P), bits=(rng.rand(P, 256) > 0.5).astype(np.uint8),
                           packed=np.zeros((P, 8), np.uint32), valid=Xc[:, 2] > 0.2)
        Rn = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.01 * k))) @ R
        kf = m.add_keyframe(Rn, t + rng.randn(3) * 0.02 * k, f, float(k), k)
        for j in range(P):
            if j not in mp_of:
                mp_of[j] = m.add_point(Xw[j] + rng.randn(3) * 0.01, kf, j)
            else:
                m.add_observation(mp_of[j], kf, j)
        m.update_connections(kf)
    return m, map_from_numpy(*map_state(m))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_essential_graph_on_carried_map(rng, fix_scale):
    """optimize_essential_graph on a tpuslam map and on its carried copy,
    with a loop edge last <- first, corrected seeds and old poses: the
    returned Sim3 per KF and the written poses to 1e-9 (f64); then the
    4-DoF graph of an inertial map on fresh copies, poses to 1e-9."""
    jm, tm_ = _carried_map(rng)
    kfs = [int(k) for k in jm.valid_kf_ids()]
    meas = (1.0, jm.kf_R[kfs[-1]] @ jm.kf_R[0].T,
            np.array([0.7, 0.0, 0.0]) + rng.randn(3) * 0.01)
    corrected = {kfs[-1]: (1.0 if fix_scale else 1.02, jm.kf_R[kfs[-1]].copy(),
                           jm.kf_t[kfs[-1]] + 0.05)}
    old = {k: (jm.kf_R[k].copy(), jm.kf_t[k].copy()) for k in kfs[-2:]}
    kw = dict(fix_scale=fix_scale, min_covis_weight=40, old_poses=old)
    oj = JG.optimize_essential_graph(jm, [(0, kfs[-1], meas)], corrected, 0, **kw)
    ot = G.optimize_essential_graph(tm_, [(0, kfs[-1], meas)], corrected, 0, device="cpu",
                                    **kw)
    assert sorted(oj) == sorted(ot) == kfs
    for k in kfs:
        for a, b in zip(ot[k], oj[k]):
            close(a, b, 1e-9)
    close(tm_.kf_R[: tm_.n_kf], jm.kf_R[: jm.n_kf], 1e-9)
    close(tm_.kf_t[: tm_.n_kf], jm.kf_t[: jm.n_kf], 1e-9)
    # the inertial map's 4-DoF graph (yaw + translation) on fresh copies
    jm, tm_ = _carried_map(np.random.RandomState(5))
    corrected = {k: (1.0, R, t) for k, (_, R, t) in corrected.items()}
    oj = JG.optimize_essential_graph(jm, [(0, kfs[-1], meas)], corrected, 0, four_dof=True, **kw)
    ot = G.optimize_essential_graph(tm_, [(0, kfs[-1], meas)], corrected, 0, four_dof=True,
                                    device="cpu", **kw)
    assert sorted(oj) == sorted(ot) == kfs
    close(tm_.kf_R[: tm_.n_kf], jm.kf_R[: jm.n_kf], 1e-9)
    close(tm_.kf_t[: tm_.n_kf], jm.kf_t[: jm.n_kf], 1e-9)

