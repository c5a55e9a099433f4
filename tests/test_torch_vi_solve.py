"""The port's visual-inertial solvers against tpuslam's, on the CPU.

  * pose_inertial_solve on tests/test_pose_inertial.py's problems: the
    last-keyframe anchor (mono rows, stereo rows, a camera offset from the
    body, gross outliers) and the last-frame anchor held by the
    marginalization prior of a first solve. f64: R, p, v and the biases
    within 1e-9, H15 within 1e-7 relative to its largest entry, inliers
    equal; one f32 case within 2e-4 / 2e-3 of tpuslam's f32 run.
  * vi_ba_solve on tests/test_inertial_ba.py's problem (at the truth, from
    a perturbed start, with a fixed pose): f64 states within 1e-8 relative
    and the cost within 1e-6 relative; one f32 case passing tpuslam's own
    recovery gates, within 3 cm of tpuslam's f32 run.
  * Both solvers with a Kannala-Brandt (kb8) camera spec, KB8 pixels:
    pose_inertial_solve with 15 gross outliers and vi_ba_solve from a
    perturbed start, f64 at the tolerances above, f32 against tpuslam's
    f64 solve (2e-4 / 2e-3; 3 cm for the BA).
  * vi_matvec and pcg_solve_vi on a random 15-dim reduced system: within
    1e-12 / 1e-10 relative of tpuslam's, and the PCG solution within 1e-5
    of the dense solve (its stopping tolerance).
  * The 4-DoF essential graph on tests/test_pose_graph.py's loop (dense and
    PCG): R and t within 1e-9, pitch and roll untouched, the loop closed.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import KannalaBrandt8 as JKB8
from tpuslam.cameras import kb8 as JK
from tpuslam.core import lie as JL
from tpuslam.imu import preintegration as JP
from tpuslam.solve import inertial_ba as JBA
from tpuslam.solve import pose_graph as JG
from tpuslam.solve import pose_inertial as JPI
from tpuslam.solve import reproj as j_reproj
from tpuslam.solve import schur_cg as JS
from tpuslam_torch.imu.preintegration import pre_to
from tpuslam_torch.solve import inertial_ba as TBA
from tpuslam_torch.solve import pose_graph as TG
from tpuslam_torch.solve import pose_inertial as TPI
from tpuslam_torch.solve import reproj
from tpuslam_torch.solve import schur_cg as TS

from test_inertial_ba import _make_problem
from test_kb8_solvers import KB_PARAMS
from test_pose_graph import _circle_graph
from test_pose_inertial import CX, CY, FX, FY, _make, _obs, _perturbed

torch.set_num_threads(2)
BF = 30.0


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a, np.float64)).to(dtype)


def J(a, dtype=jnp.float64):
    return jnp.asarray(np.asarray(a, np.float64), dtype)


def close(a, b, rel, what=""):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert np.abs(a - b).max() <= rel * scale, (what, np.abs(a - b).max(), scale)


# ---------------------------------------------------------------- pose-inertial
def _pi_inputs(rng, d, k_anchor, k_frame, state2, prior=None, stereo_frac=0.0,
               n_outliers=0):
    """tests/test_pose_inertial.py's solve inputs as numpy, with optional
    stereo rows (u_right from BF) and gross outliers."""
    calib = d["calib"]
    uvr, valid = _obs(d, k_frame)
    P = len(uvr)
    stereo = np.zeros(P, bool)
    if stereo_frac:
        Rcw, tcw = calib.cam_from_body(d["Rwb"][k_frame], d["p"][k_frame])
        z = (d["X"] @ Rcw.T + tcw)[:, 2]
        stereo = (rng.rand(P) < stereo_frac) & valid
        uvr[stereo, 2] = uvr[stereo, 0] - BF / z[stereo]
    if n_outliers:
        bad = rng.choice(np.nonzero(valid)[0], n_outliers, replace=False)
        uvr[bad, :2] += rng.uniform(30, 80, (n_outliers, 2)) * np.sign(rng.randn(n_outliers, 2))
    pre = {k: np.asarray(v, np.float64) for k, v in d["pres"][k_frame - 1].items()}
    info9 = np.asarray(JP.information_from_cov(J(pre["C"][:9, :9])))
    dT = float(pre["dT"])
    pr = prior or dict(H=np.zeros((15, 15)), R=d["Rwb"][k_anchor], p=d["p"][k_anchor],
                       v=d["v"][k_anchor], bg=np.zeros(3), ba=np.zeros(3))
    anchor = (d["Rwb"][k_anchor], d["p"][k_anchor], d["v"][k_anchor], np.zeros(3), np.zeros(3))
    floats = (*anchor, *state2, d["X"], uvr, np.ones(P))
    edge = (info9, np.zeros(3), np.zeros(3))
    prior_args = (pr["H"], pr["R"], pr["p"], pr["v"], pr["bg"], pr["ba"])
    return floats, stereo, valid, pre, edge, (1.0 / (1e-9 * dT), 1.0 / (1e-8 * dT)), prior_args, \
        (calib.Rcb, calib.tcb)


def _pi_both(inputs, anchor_fixed, dtype=torch.float64, jax_kw=None, port_kw=None,
             port_only=False):
    """Both packages' pose_inertial_solve on `inputs` (port_only: the port's
    alone, None for tpuslam's); jax_kw / port_kw: extra keywords of each
    side's solve (a camera spec)."""
    floats, stereo, valid, pre, edge, rw, prior_args, ext = inputs
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jo = None if port_only else JPI.pose_inertial_solve(
        *[J(x, jd) for x in floats], jnp.asarray(stereo), jnp.asarray(valid),
        {k: J(v, jd) for k, v in pre.items()}, *[J(x, jd) for x in edge], *rw,
        *[J(x, jd) for x in prior_args], anchor_fixed, *[J(x, jd) for x in ext],
        FX, FY, CX, CY, BF, **(jax_kw or {}))
    to = TPI.pose_inertial_solve(
        *[T(x, dtype) for x in floats], torch.as_tensor(stereo), torch.as_tensor(valid),
        pre_to(pre, "cpu", dtype), *[T(x, dtype) for x in edge], *rw,
        *[T(x, dtype) for x in prior_args], anchor_fixed, *[T(x, dtype) for x in ext],
        FX, FY, CX, CY, BF, **(port_kw or {}))
    return None if jo is None else [np.asarray(x) for x in jo], [x.numpy() for x in to]


def _assert_pi_equal(jo, to, tol_state=1e-9, tol_h=1e-7):
    for name, a, b in zip(("R", "p", "v", "bg", "ba"), to[:5], jo[:5]):
        np.testing.assert_allclose(a, b, atol=tol_state, rtol=0, err_msg=name)
    assert np.array_equal(to[5], jo[5])
    close(to[6], jo[6], tol_h, "H15")
    assert int(to[7]) == int(jo[7])


@pytest.mark.parametrize("case", ["mono", "stereo", "tbc", "outliers"])
def test_pose_inertial_kf_anchor_matches_tpuslam(rng, case):
    calib = None
    if case == "tbc":
        from tpuslam.imu.preintegration import ImuCalib

        Tbc = np.eye(4)
        Tbc[:3, :3] = np.asarray(JL.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
        Tbc[:3, 3] = [0.1, -0.05, 0.02]
        calib = ImuCalib(Tbc=Tbc)
    d = _make(rng, calib=calib)
    R2, p2, v2 = _perturbed(rng, d, 1)
    inputs = _pi_inputs(rng, d, 0, 1, (R2, p2, v2, np.zeros(3), np.zeros(3)),
                        stereo_frac=0.5 if case == "stereo" else 0.0,
                        n_outliers=15 if case == "outliers" else 0)
    jo, to = _pi_both(inputs, True)
    _assert_pi_equal(jo, to)
    np.testing.assert_allclose(to[1], d["p"][1], atol=5e-3)
    if case == "outliers":
        assert to[5].sum() < inputs[2].sum() - 10


def test_pose_inertial_prior_anchor_matches_tpuslam(rng):
    """Frame 1 against KF 0, then frame 2 against the free frame-1 anchor
    held by the marginalization prior (tpuslam's LastFrame variant)."""
    d = _make(rng)
    jo1, to1 = _pi_both(_pi_inputs(rng, d, 0, 1, (*_perturbed(rng, d, 1), np.zeros(3),
                                                  np.zeros(3))), True)
    _assert_pi_equal(jo1, to1)
    R1s, p1s, v1s, bg1, ba1, _, H15, _ = jo1
    prior = dict(H=H15, R=R1s, p=p1s, v=v1s, bg=bg1, ba=ba1)
    d2 = dict(d, Rwb=d["Rwb"].copy(), p=d["p"].copy(), v=d["v"].copy())
    d2["Rwb"][1], d2["p"][1], d2["v"][1] = R1s, p1s, v1s
    R2, p2, v2 = _perturbed(rng, d, 2)
    inputs = _pi_inputs(rng, d2, 1, 2, (R2, p2, v2, bg1, ba1), prior=prior)
    floats = list(inputs[0])
    floats[3], floats[4] = bg1, ba1          # the anchor carries frame 1's biases
    jo, to = _pi_both((tuple(floats),) + inputs[1:], False)
    _assert_pi_equal(jo, to, tol_state=1e-8)
    np.testing.assert_allclose(to[1], d["p"][2], atol=5e-3)


def test_pose_inertial_f32_matches_tpuslam_f32(rng):
    d = _make(rng)
    R2, p2, v2 = _perturbed(rng, d, 1)
    jo, to = _pi_both(_pi_inputs(rng, d, 0, 1, (R2, p2, v2, np.zeros(3), np.zeros(3)),
                                 stereo_frac=0.5), True, dtype=torch.float32)
    assert to[0].dtype == np.float32
    np.testing.assert_allclose(to[0], jo[0], atol=2e-4)
    np.testing.assert_allclose(to[1], jo[1], atol=2e-3)
    np.testing.assert_allclose(to[2], jo[2], atol=2e-2)
    assert (to[5] == jo[5]).mean() > 0.97
    np.testing.assert_allclose(to[1], d["p"][1], atol=5e-3)


def _j_marginalize(H):
    """tpuslam's anchor marginalization (tpuslam/solve/pose_inertial.py:254-261)."""
    import jax

    H = jnp.asarray(H)
    d11 = jnp.diagonal(H[:15, :15])
    good = (d11 > 0) & jnp.isfinite(d11)
    s11 = jnp.where(good, jax.lax.rsqrt(jnp.where(good, d11, 1.0)), 1.0)
    A = H[:15, :15] * s11[:, None] * s11[None, :] + 1e-6 * jnp.eye(15, dtype=H.dtype)
    B12 = s11[:, None] * H[:15, 15:]
    H15 = H[15:, 15:] - B12.T @ jnp.linalg.solve(A, B12)
    return np.asarray(0.5 * (H15 + H15.T))


@pytest.mark.parametrize("case", ["regular", "singular"])
def test_anchor_marginalization_matches_tpuslam(rng, case):
    """The frame's prior from the [30, 30] Hessian: within 1e-12 relative of
    tpuslam's on a regular Hessian; on one whose scaled anchor block is
    exactly singular (rows 0 and 1 equal), where torch.linalg.solve raises,
    non-finite as tpuslam's jnp.linalg.solve leaves it (no exception: a
    singular block on the card stopped a mono-inertial run)."""
    M = rng.randn(30, 30)
    H = M @ M.T + np.eye(30)
    if case == "singular":
        H[:15, :15] = np.eye(15)                  # unit diagonal: the Jacobi scale is 1
        H[0, 1] = H[1, 0] = 1.0 + 1e-6            # = the damped diagonal
        A = T(H[:15, :15]) + 1e-6 * torch.eye(15, dtype=torch.float64)
        with pytest.raises(torch.linalg.LinAlgError):
            torch.linalg.solve(A, T(H[:15, 15:]))
    got = TPI._marginalize_anchor(T(H)).numpy()
    want = _j_marginalize(H)
    if case == "singular":
        assert not np.isfinite(want).all() and not np.isfinite(got).all()
    else:
        close(got, want, 1e-12, "H15")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_so3_log_of_a_symmetric_near_identity(dtype):
    """R^T R of a rotation shrunk by 1e-6 (not orthonormal to f32
    precision) is symmetric, so sin theta = 0 while cos theta < 1 - 1e-7:
    tpuslam's so3_log gives NaN there (theta / sin theta = 0 / 0). The
    port's takes the Taylor branch: its log (0) and its forward Jacobian
    (along a rotation increment) are finite, and it equals tpuslam's
    within 1e-6 on the rotation itself."""
    from tpuslam_torch.core import lie as TL

    R = np.asarray(JL.so3_exp(jnp.asarray([0.4, -0.3, 0.2], jnp.float64))) * (1.0 - 1e-6)
    M = R.T @ R
    td, jd = (torch.float32, jnp.float32) if dtype == "f32" else (torch.float64, jnp.float64)
    assert not np.isfinite(np.asarray(JL.so3_log(jnp.asarray(M, jd)))).all()
    Mt = torch.tensor(M, dtype=td)
    w = TL.so3_log(Mt)
    jac = torch.func.jacfwd(lambda e: TL.so3_log(Mt @ (torch.eye(3, dtype=td) + TL.hat(e))))(
        torch.zeros(3, dtype=td))
    assert torch.isfinite(w).all() and float(w.abs().max()) < 1e-6
    assert torch.isfinite(jac).all()
    close(TL.so3_log(torch.tensor(R / (1.0 - 1e-6), dtype=td)).numpy(),
          np.asarray(JL.so3_log(jnp.asarray(R / (1.0 - 1e-6), jd))), 1e-6, "so3_log")


def _card_solve_inputs(array):
    """The keyframe-anchored pose_inertial_solve call whose prior came out
    non-finite on the card: bench_sensors_torch.py's mono-inertial row,
    pass 0, frame 28, saved by scripts/vi_prior_witness_torch.py (f32;
    the preintegration dict is argument 15)."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data", "vi_kf_anchor_card.npz"))
    args, pre = [None] * 35, {}
    for k in z.files:
        if not k.startswith("c0/a"):
            continue
        name = k.split("/")[1][1:]
        if "." in name:
            i, key = name.split(".")
            pre[key] = array(z[k])
            args[int(i)] = pre
        else:
            args[int(name)] = array(z[k]) if z[k].ndim else z[k].item()
    return args


def test_kf_anchored_solve_from_the_card_gives_a_finite_prior():
    """The keyframe's rotation R1 was not orthonormal to f32 precision
    (R1^T R1 - I ~ 2e-6), so the prior residual so3_log(R1^T R1) was NaN:
    the anchor block of the Hessian turned NaN (NaN * the zero mask of the
    fixed anchor), torch.linalg.solve raised on it (F4), and tpuslam's
    solve on these inputs returns its start state unmoved and a NaN prior
    that the next frame's solve inherits. The port's solve moves the state
    and gives a finite, symmetric prior."""
    jargs = _card_solve_inputs(jnp.asarray)
    jout = JPI.pose_inertial_solve(*jargs)
    assert not np.isfinite(np.asarray(jout[6])).all()
    assert np.array_equal(np.asarray(jout[1]), np.asarray(jargs[6]))
    args = _card_solve_inputs(torch.tensor)
    out = TPI.pose_inertial_solve(*args)
    assert all(bool(torch.isfinite(x).all()) for x in out[:5] + (out[6],))
    assert torch.equal(out[6], out[6].T) and float((out[1] - args[6]).abs().max()) > 1e-6
    assert int(out[7]) > 150


# ------------------------------------------------------------------- VI BA
def _ba_start(rng, d, kind):
    K, P = d["K"], d["P"]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    zero = np.zeros((K, 3))
    if kind == "truth":
        return (d["Rwb"], d["p"], d["v"], zero, zero, d["X"]), fixed, 2
    if kind == "fixed":
        pn = d["p"] + np.concatenate([np.zeros((1, 3)), rng.randn(K - 1, 3) * 0.03])
        return (d["Rwb"], pn, d["v"], zero, zero, d["X"]), fixed, 8
    Rn, pn = d["Rwb"].copy(), d["p"].copy()
    vn = d["v"] + rng.randn(K, 3) * 0.05
    for k in range(1, K):
        Rn[k] = Rn[k] @ np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.02)))
        pn[k] = pn[k] + rng.randn(3) * 0.05
    Xn = d["X"] + rng.randn(P, 3) * 0.05
    bgn = np.tile(rng.randn(3) * 0.01, (K, 1))
    ban = np.tile(rng.randn(3) * 0.05, (K, 1))
    return (Rn, pn, vn, bgn, ban, Xn), fixed, 60


def _ba_both(d, start, fixed, n_iters, dtype=torch.float64, jax_kw=None, port_kw=None,
             port_only=False, bf=0.0):
    """Both packages' vi_ba_solve on problem d (port_only: the port's
    alone, None for tpuslam's); jax_kw / port_kw: extra keywords of each
    side's solve (a camera spec)."""
    K = d["K"]
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    pre = {k: np.asarray(v, np.float64) for k, v in d["pre_stack"].items()}
    info9 = np.asarray(d["info9"], np.float64)
    ints = (d["obs_kf"], d["obs_pt"])
    obs = (d["uvr"], d["inv_sigma2"])
    masks = (d["stereo"], d["valid"])
    edges = (d["edges_a"], d["edges_b"])
    pairs = (d["pair_a"], d["pair_b"])
    jo = None if port_only else JBA.vi_ba_solve(
        *[J(x, jd) for x in start], *map(jnp.asarray, ints), *[J(x, jd) for x in obs],
        *map(jnp.asarray, masks), *map(jnp.asarray, edges), {k: J(v, jd) for k, v in pre.items()},
        J(info9, jd), J(np.zeros((K, 3)), jd), J(np.zeros((K, 3)), jd), jnp.asarray(fixed),
        *map(jnp.asarray, pairs), d["fx"], d["fy"], d["cx"], d["cy"], bf,
        J(d["rw_info_g"], jd), J(d["rw_info_a"], jd), n_iters=n_iters, **(jax_kw or {}))
    to = TBA.vi_ba_solve(
        *[T(x, dtype) for x in start], *map(torch.as_tensor, ints), *[T(x, dtype) for x in obs],
        *map(torch.as_tensor, masks), *map(torch.as_tensor, edges), pre_to(pre, "cpu", dtype),
        T(info9, dtype), T(np.zeros((K, 3)), dtype), T(np.zeros((K, 3)), dtype),
        torch.as_tensor(fixed), *map(torch.as_tensor, pairs), d["fx"], d["fy"], d["cx"], d["cy"],
        bf, T(d["rw_info_g"], dtype), T(d["rw_info_a"], dtype), n_iters=n_iters,
        **(port_kw or {}))
    return None if jo is None else [np.asarray(x) for x in jo], [x.numpy() for x in to]


def _with_stereo_rows(d):
    """Problem d with every other observation a stereo row (u_right = u -
    BF / z, the body frame being the camera's), as a stereo map gives the
    visual-inertial BA."""
    d = dict(d)
    Xc = np.einsum("oji,oj->oi", d["Rwb"][d["obs_kf"]], d["X"][d["obs_pt"]] - d["p"][d["obs_kf"]])
    stereo = (np.arange(len(Xc)) % 2 == 0) & d["valid"]
    d["uvr"] = d["uvr"].copy()
    d["uvr"][stereo, 2] = d["uvr"][stereo, 0] - BF / Xc[stereo, 2]
    d["stereo"] = stereo
    assert stereo.sum() > 10 and (Xc[stereo, 2] > 0).all()
    return d


@pytest.mark.parametrize("kind", ["truth", "perturbed", "fixed", "stereo"])
def test_vi_ba_solve_matches_tpuslam(rng, kind):
    """stereo: the perturbed problem with stereo rows (BF), as the
    stereo-inertial mapper's BAs give it."""
    d = _make_problem(rng)
    bf = 0.0
    if kind == "stereo":
        d, bf = _with_stereo_rows(d), BF
    start, fixed, n_iters = _ba_start(rng, d, "perturbed" if kind == "stereo" else kind)
    jo, to = _ba_both(d, start, fixed, n_iters, bf=bf)
    for name, a, b in zip(("Rwb", "p", "v", "bg", "ba", "X"), to[:6], jo[:6]):
        close(a, b, 1e-8, name)
    assert abs(float(to[6]) - float(jo[6])) <= 1e-6 * max(float(jo[6]), 1e-3)
    np.testing.assert_allclose(to[1][0], start[1][0], atol=1e-12)   # the fixed pose
    if kind != "fixed":
        np.testing.assert_allclose(to[1], d["p"], atol=3e-2)


def test_vi_ba_solve_f32_recovers(rng):
    """f32 (the card's dtype): tpuslam's recovery gates, and within their
    3 cm of tpuslam's f32 solution (the near-noiseless problem's flat
    direction converges only asymptotically, so f32 paths part there)."""
    d = _make_problem(rng)
    start, fixed, n_iters = _ba_start(rng, d, "f32")
    jo, to = _ba_both(d, start, fixed, n_iters, dtype=torch.float32)
    assert to[1].dtype == np.float32
    np.testing.assert_allclose(to[1], d["p"], atol=3e-2)
    np.testing.assert_allclose(to[2], d["v"], atol=5e-2)
    assert np.abs(to[3]).max() < 5e-3 and np.abs(to[4]).max() < 5e-2
    np.testing.assert_allclose(to[1], jo[1], atol=3e-2)


# --------------------------------------------------- with a KB8 camera


def _kb8_obs(uvr, X, Rcw, tcw, fx, fy, cx, cy):
    """Replace a problem's pinhole pixels by the KB8 pixels of the same
    points (TUM-VI k's, the problem's intrinsics)."""
    p = (fx, fy, cx, cy) + tuple(KB_PARAMS[4:])
    uv = np.asarray(JK.kb8_project(p, jnp.asarray(X @ Rcw.T + tcw)))
    return np.concatenate([uv, uvr[:, 2:]], 1)


def _kb8_spec_of(fx, fy, cx, cy):
    jcam = JKB8([fx, fy, cx, cy] + KB_PARAMS[4:], 512, 512)
    spec = j_reproj.make_kb8_spec(jcam)
    return spec, reproj.CamSpec(spec.kind, spec.k)


@pytest.fixture(scope="module")
def pi_kb8():
    """tests/test_pose_inertial.py's frame-1 solve with KB8 pixels and 15
    gross outliers, and tpuslam's f64 solve of it."""
    rng = np.random.RandomState(0)
    d = _make(rng)
    R2, p2, v2 = _perturbed(rng, d, 1)
    inputs = _pi_inputs(rng, d, 0, 1, (R2, p2, v2, np.zeros(3), np.zeros(3)))
    floats = list(inputs[0])
    Rcw, tcw = d["calib"].cam_from_body(d["Rwb"][1], d["p"][1])
    uvr = _kb8_obs(floats[11], d["X"], Rcw, tcw, FX, FY, CX, CY)
    bad = rng.choice(np.nonzero(inputs[2])[0], 15, replace=False)
    uvr[bad, :2] += rng.uniform(30, 80, (15, 2)) * np.sign(rng.randn(15, 2))
    floats[11] = uvr
    inputs = (tuple(floats),) + inputs[1:]
    spec, tspec = _kb8_spec_of(FX, FY, CX, CY)
    jo, _ = _pi_both(inputs, True, jax_kw=dict(cam=spec), port_kw=dict(cam=tspec))
    return d, inputs, tspec, jo


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_pose_inertial_kb8_matches_tpuslam(pi_kb8, dt):
    """f64 at tests/test_torch_vi_solve.py's tolerances; f32 against
    tpuslam's f64 solve (2e-4 on R, 2e-3 on p, inliers 97 % equal)."""
    d, inputs, tspec, jo = pi_kb8
    _, to = _pi_both(inputs, True, dtype=torch.float64 if dt == "f64" else torch.float32,
                     port_kw=dict(cam=tspec), port_only=True)
    if dt == "f64":
        _assert_pi_equal(jo, to)
    else:
        assert to[0].dtype == np.float32
        np.testing.assert_allclose(to[0], jo[0], atol=2e-4)
        np.testing.assert_allclose(to[1], jo[1], atol=2e-3)
        assert (to[5] == jo[5]).mean() > 0.97
    assert to[5].sum() < inputs[2].sum() - 10          # the outliers are out
    np.testing.assert_allclose(to[1], d["p"][1], atol=5e-3)


@pytest.fixture(scope="module")
def viba_kb8():
    """tests/test_inertial_ba.py's window with KB8 pixels from a perturbed
    start, and tpuslam's f64 solve of it."""
    rng = np.random.RandomState(0)
    d = _make_problem(rng)
    Xc_obs = np.einsum("oji,oj->oi", d["Rwb"][d["obs_kf"]],
                       d["X"][d["obs_pt"]] - d["p"][d["obs_kf"]])
    d["uvr"] = _kb8_obs(d["uvr"], Xc_obs, np.eye(3), np.zeros(3), d["fx"], d["fy"], d["cx"],
                        d["cy"])
    spec, tspec = _kb8_spec_of(d["fx"], d["fy"], d["cx"], d["cy"])
    start, fixed, n_iters = _ba_start(rng, d, "perturbed")
    jo, _ = _ba_both(d, start, fixed, n_iters, jax_kw=dict(cam=spec), port_kw=dict(cam=tspec))
    return d, (start, fixed, n_iters), tspec, jo


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_vi_ba_kb8_matches_tpuslam(viba_kb8, dt):
    """f64 states within 1e-8 relative; f32 within 3 cm of tpuslam's f64
    solve (tests/test_torch_vi_solve.py's f32 bound)."""
    d, (start, fixed, n_iters), tspec, jo = viba_kb8
    _, to = _ba_both(d, start, fixed, n_iters, dtype=torch.float64 if dt == "f64" else
                     torch.float32, port_kw=dict(cam=tspec), port_only=True)
    if dt == "f64":
        for name, a, b in zip(("Rwb", "p", "v", "bg", "ba", "X"), to[:6], jo[:6]):
            close(a, b, 1e-8, name)
    else:
        assert to[1].dtype == np.float32
        np.testing.assert_allclose(to[1], jo[1], atol=3e-2)
    np.testing.assert_allclose(to[1], d["p"], atol=3e-2)


# --------------------------------------------------------------- VI PCG
def _reduced_system(rng, K=6, P=40, obs_per_pt=3):
    E = K - 1
    A = rng.randn(K, 15, 15) * 0.3
    Hdiag = A @ A.transpose(0, 2, 1) + 20.0 * np.eye(15)
    Hoff = rng.randn(E, 15, 15) * 0.5
    obs_kf = np.concatenate([rng.choice(K, obs_per_pt, replace=False) for _ in range(P)])
    obs_pt = np.repeat(np.arange(P), obs_per_pt)
    Wo = rng.randn(len(obs_kf), 6, 3) * 0.4
    B = rng.randn(P, 3, 3)
    Hll_inv = np.linalg.inv(B @ B.transpose(0, 2, 1) + 5.0 * np.eye(3))
    free = np.ones((K, 15), bool)
    free[0, :6] = False
    return dict(Hdiag=Hdiag, Hoff=Hoff, ea=np.arange(E), eb=np.arange(1, E + 1), Hll_inv=Hll_inv,
                Wo=Wo, obs_kf=obs_kf, obs_pt=obs_pt, free=free, b=rng.randn(K, 15))


def _dense(s):
    K = len(s["Hdiag"])
    S = np.zeros((K, 15, K, 15))
    for k in range(K):
        S[k, :, k] = s["Hdiag"][k]
    for e, (a, b) in enumerate(zip(s["ea"], s["eb"])):
        S[a, :, b] += s["Hoff"][e]
        S[b, :, a] += s["Hoff"][e].T
    for o1, (k1, j1) in enumerate(zip(s["obs_kf"], s["obs_pt"])):
        for o2, (k2, j2) in enumerate(zip(s["obs_kf"], s["obs_pt"])):
            if j1 == j2:
                S[k1, :6, k2, :6] -= s["Wo"][o1] @ s["Hll_inv"][j1] @ s["Wo"][o2].T
    return S.reshape(K * 15, K * 15)


def test_vi_matvec_and_pcg_match_tpuslam(rng):
    s = _reduced_system(rng)
    mats = ("Hdiag", "Hoff")
    idx = ("ea", "eb")
    x = rng.randn(*s["b"].shape)
    args_j = ([J(s[k]) for k in mats], [jnp.asarray(s[k]) for k in idx], J(s["Hll_inv"]),
              J(s["Wo"]), jnp.asarray(s["obs_kf"]), jnp.asarray(s["obs_pt"]))
    args_t = ([T(s[k]) for k in mats], [torch.as_tensor(s[k]) for k in idx], T(s["Hll_inv"]),
              T(s["Wo"]), torch.as_tensor(s["obs_kf"]), torch.as_tensor(s["obs_pt"]))

    def flat(args):
        return [*args[0], *args[1], *args[2:]]

    yj = JS.vi_matvec(J(x), *flat(args_j))
    yt = TS.vi_matvec(T(x), *flat(args_t))
    close(yt, yj, 1e-12, "matvec")
    close(yt.numpy().reshape(-1), _dense(s) @ x.reshape(-1), 1e-12, "dense matvec")
    xj = JS.pcg_solve_vi(J(s["b"]), *flat(args_j), jnp.asarray(s["free"]), n_iters=150)
    xt = TS.pcg_solve_vi(T(s["b"]), *flat(args_t), torch.as_tensor(s["free"]), n_iters=150)
    close(xt, xj, 1e-10, "pcg")
    f = s["free"].reshape(-1)
    S = _dense(s)[np.ix_(f, f)]
    # the PCG stops at |r|^2 <= 1e-12 |b|^2
    close(xt.numpy().reshape(-1)[f], np.linalg.solve(S, s["b"].reshape(-1)[f]), 1e-5, "solve")
    assert np.all(xt.numpy()[~s["free"]] == 0)


# ---------------------------------------------------------- 4-DoF essential graph
def _graph4(rng, K=12):
    """tests/test_pose_graph.py's 4-DoF loop: yaw + translation odometry
    noise, one exact loop edge."""
    gt, _, meas = _circle_graph(rng, K, drift=0.0, s_drift=0.0)
    est, meas2 = [gt[0]], []
    for k in range(K - 1):
        _, R_rel, t_rel = meas[k][2]
        yaw = rng.randn() * 0.02
        c, s = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        Rn = Rz @ np.asarray(R_rel)
        tn = Rz @ np.asarray(t_rel) + rng.randn(3) * np.array([0.02, 0.02, 0.0])
        meas2.append((k, k + 1, Rn, tn))
        _, Rk, tk = est[k]
        est.append((1.0, Rn @ Rk, Rn @ tk + tn))
    _, R_loop, t_loop = meas[-1][2]
    meas2.append((0, K - 1, np.asarray(R_loop), np.asarray(t_loop)))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return gt, dict(R=np.stack([e[1] for e in est]), t=np.stack([e[2] for e in est]),
                    ei=np.array([m[0] for m in meas2]), ej=np.array([m[1] for m in meas2]),
                    Rm=np.stack([m[2] for m in meas2]), tm=np.stack([m[3] for m in meas2]),
                    w=np.ones(len(meas2)), fixed=fixed)


@pytest.mark.parametrize("use_cg", [False, True])
def test_pose_graph_4dof_matches_tpuslam(rng, use_cg):
    gt, g = _graph4(rng)
    K = len(g["R"])
    kw = dict(n_iters=25, use_cg=use_cg)
    Rj, tj, cj = JG.pose_graph_solve_4dof(
        J(g["R"]), J(g["t"]), jnp.asarray(g["ei"], jnp.int32), jnp.asarray(g["ej"], jnp.int32),
        J(g["Rm"]), J(g["tm"]), J(g["w"]), jnp.asarray(g["fixed"]), **kw)
    Rt, tt, ct = TG.pose_graph_solve_4dof(
        T(g["R"]), T(g["t"]), torch.as_tensor(g["ei"]), torch.as_tensor(g["ej"]), T(g["Rm"]),
        T(g["tm"]), T(g["w"]), torch.as_tensor(g["fixed"]), **kw)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-9)
    assert abs(float(ct) - float(cj)) <= 1e-9 * max(1.0, abs(float(cj)))
    # gravity (the third column of Rcw) untouched; the loop closed
    np.testing.assert_allclose(Rt.numpy()[:, :, 2], g["R"][:, :, 2], atol=1e-9)

    def center_err(R, t):
        _, Rg, tg = gt[K - 1]
        return np.linalg.norm(-(R[K - 1].T @ t[K - 1]) + Rg.T @ tg)

    assert center_err(Rt.numpy(), tt.numpy()) < 0.2 * center_err(g["R"], g["t"])


def test_pose_graph_4dof_f32_runs_on_edges_of_one(rng):
    """f32 solve (the card's dtype): the jacfwd of the 4-dim increments
    keeps every intermediate batched, so no f64 tangent appears."""
    gt, g = _graph4(rng)
    Rt, tt, _ = TG.pose_graph_solve_4dof(
        T(g["R"], torch.float32), T(g["t"], torch.float32), torch.as_tensor(g["ei"]),
        torch.as_tensor(g["ej"]), T(g["Rm"], torch.float32), T(g["tm"], torch.float32),
        T(g["w"], torch.float32), torch.as_tensor(g["fixed"]), n_iters=25)
    Rd, td, _ = TG.pose_graph_solve_4dof(
        T(g["R"]), T(g["t"]), torch.as_tensor(g["ei"]), torch.as_tensor(g["ej"]), T(g["Rm"]),
        T(g["tm"]), T(g["w"]), torch.as_tensor(g["fixed"]), n_iters=25)
    assert Rt.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), td.numpy(), atol=2e-3)
