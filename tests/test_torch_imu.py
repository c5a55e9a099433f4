"""The port's IMU preintegration, synthetic IMU and inertial initialization
against tpuslam's, on the CPU.

  * imu_between: bitwise equal to tpuslam's for the same sequence.
  * preintegrate, corrected_delta, predict_state, inertial_residual,
    information_from_cov and merge_preintegrations on the same seeded
    samples: f64 within 1e-9 relative (scaled by each array's largest
    entry), and one f32 case within 1e-5 relative.
  * The init solves on tests/test_imu_init.py's problems (a visual frame
    rotated and scaled against the truth): gyro_bias_from_rotations,
    linear_sgv_seed and inertial_init_solve (mono scale and the stereo
    fixed-scale variant) within 1e-7 of tpuslam in f64 (the running cost
    within 1e-12 of the initial cost), and the recovery
    gates of tests/test_imu_init.py on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import lie as JL
from tpuslam.imu import init as JI
from tpuslam.imu import preintegration as JP
from tpuslam.io.synthetic import SyntheticSequence as JSeq
from tpuslam_torch.imu import init as TI
from tpuslam_torch.imu import preintegration as TP
from tpuslam_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(2)


def T(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, np.float64)).to(dtype)


def close(a, b, rel):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("kind", ["forward_arc", "vi_excite", "loop"])
def test_imu_between_bitwise(kind):
    js = JSeq(n_frames=4, fps=10, imu_rate=200.0, kind=kind)
    ts = SyntheticSequence(n_frames=4, fps=10, imu_rate=200.0, kind=kind)
    for t0, t1 in ((0.0, 0.1), (0.1, 0.35), (1.23, 1.5)):
        for a, b in zip(ts.imu_between(t0, t1), js.imu_between(t0, t1)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    t = np.linspace(0, 3, 7)
    for name in ("vel", "acc", "yaw_pitch_rates"):
        for a, b in zip(np.atleast_2d(getattr(ts.traj, name)(t)),
                        np.atleast_2d(getattr(js.traj, name)(t))):
            assert np.array_equal(a, b)


def _samples(rng, n=40):
    seq = SyntheticSequence(n_frames=2, fps=5, imu_rate=200.0, kind="vi_excite")
    ts, ws, accs = seq.imu_between(0.0, n / 200.0)
    dts = np.diff(np.concatenate([[0.0], ts]))
    ws = ws + rng.randn(*ws.shape) * 1e-3
    accs = accs + rng.randn(*accs.shape) * 1e-2
    dts[5] = 0.0            # a padding-like row: the identity update
    return ws, accs, dts, rng.randn(3) * 1e-3, rng.randn(3) * 1e-2


NOISE = (1e-6, 1e-5, 1e-9, 1e-8)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-9), (torch.float32, 1e-5)])
def test_preintegrate_matches_tpuslam(rng, dtype, rel):
    ws, accs, dts, bg, ba = _samples(rng)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jpre = JP.preintegrate(*[jnp.asarray(a, jdt) for a in (ws, accs, dts, bg, ba)], *NOISE)
    tpre = TP.preintegrate(*[T(a, dtype) for a in (ws, accs, dts, bg, ba)], *NOISE)
    assert set(tpre) == set(jpre)
    for k in jpre:
        assert tpre[k].dtype == dtype
        close(tpre[k], jpre[k], rel)


def _pre_pair(rng, n=40):
    ws, accs, dts, bg, ba = _samples(rng, n)
    jpre = JP.preintegrate(*[jnp.asarray(a) for a in (ws, accs, dts, bg, ba)], *NOISE)
    return jpre, {k: T(v) for k, v in jpre.items()}


def test_residuals_prediction_and_information_match_tpuslam(rng):
    jpre, tpre = _pre_pair(rng)
    dbg, dba = rng.randn(3) * 1e-3, rng.randn(3) * 1e-2
    for a, b in zip(TP.corrected_delta(tpre, T(dbg), T(dba)),
                    JP.corrected_delta(jpre, jnp.asarray(dbg), jnp.asarray(dba))):
        close(a, b, 1e-12)
    R = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3))))
    p, v = rng.randn(3), rng.randn(3)
    for args in ((), (dbg, dba)):
        for a, b in zip(TP.predict_state(T(R), T(p), T(v), tpre, *[T(x) for x in args]),
                        JP.predict_state(jnp.asarray(R), jnp.asarray(p), jnp.asarray(v), jpre,
                                         *[jnp.asarray(x) for x in args])):
            close(a, b, 1e-12)
    R2 = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3))))
    args = [R, p, v, R2, rng.randn(3), rng.randn(3), dbg, dba, np.zeros(3), np.zeros(3)]
    close(TP.inertial_residual(*[T(a) for a in args], tpre),
          JP.inertial_residual(*[jnp.asarray(a) for a in args], jpre), 1e-9)
    C9 = np.asarray(jpre["C"])[:9, :9]
    close(TP.information_from_cov(T(C9)), JP.information_from_cov(jnp.asarray(C9)), 1e-9)
    close(TP.information_from_cov(T(C9, torch.float32)),
          JP.information_from_cov(jnp.asarray(C9, jnp.float32)), 1e-4)
    jpre2, tpre2 = _pre_pair(rng, 25)
    jm, tm = JP.merge_preintegrations(jpre, jpre2), TP.merge_preintegrations(tpre, tpre2)
    for k in jm:
        close(tm[k], jm[k], 1e-12)


def _init_problem(K=10, s_true=2.5, bg_true=(0.004, -0.003, 0.002)):
    """tests/test_imu_init.py's problem: the visual frame is the true world
    rotated by R_vw and scaled by 1 / s_true; the gyro is biased."""
    seq = SyntheticSequence(n_frames=K, fps=4.0, imu_rate=400.0)
    tr = seq.traj
    times = seq.timestamps()
    R_vw = np.asarray(JL.so3_exp(jnp.asarray([0.25, -0.15, 0.4])))
    bg_true = np.asarray(bg_true)
    Rwb = np.stack([R_vw @ tr.pose_cw(t)[0].T for t in times])
    p = np.stack([R_vw @ tr.pos(t) / s_true for t in times])
    v = np.stack([R_vw @ tr.vel(t) for t in times])
    jpres = []
    for k in range(K - 1):
        ts, ws, accs = seq.imu_between(times[k], times[k + 1])
        dts = np.diff(np.concatenate([[times[k]], ts]))
        jpres.append(JP.preintegrate(jnp.asarray(ws + bg_true), jnp.asarray(accs),
                                     jnp.asarray(dts), jnp.zeros(3), jnp.zeros(3),
                                     1e-6, 1e-5, 1e-9, 1e-8))
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jpres)
    info9 = np.stack([np.asarray(JP.information_from_cov(pre["C"][:9, :9])) for pre in jpres])
    tstack = {k: T(v_) for k, v_ in jstack.items()}
    return dict(Rwb=Rwb, p=p, v=v, jstack=jstack, tstack=tstack, info9=info9, jpres=jpres,
                g_vis=R_vw @ np.array([0.0, 0.0, -1.0]), s_true=s_true, bg_true=bg_true)


@pytest.fixture(scope="module")
def init_problem():
    return _init_problem()


def test_gyro_bias_and_linear_seed_match_tpuslam(init_problem):
    d = init_problem
    R1, R2 = d["Rwb"][:-1], d["Rwb"][1:]
    jb = JI.gyro_bias_from_rotations((jnp.asarray(R1), jnp.asarray(R2)), d["jstack"]["dR"],
                                     d["jstack"]["JRg"])
    tb = TI.gyro_bias_from_rotations((T(R1), T(R2)), d["tstack"]["dR"], d["tstack"]["JRg"])
    close(tb, jb, 1e-9)
    np.testing.assert_allclose(tb.numpy(), d["bg_true"], atol=2e-4)
    K = len(d["Rwb"])
    ea, eb = np.arange(K - 1), np.arange(1, K)
    pres = [jax.tree.map(np.asarray, pre) for pre in d["jpres"]]
    for a, b in zip(TI.linear_sgv_seed(d["Rwb"], d["p"], ea, eb, pres),
                    JI.linear_sgv_seed(d["Rwb"], d["p"], ea, eb, pres)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mono", [True, False])
def test_inertial_init_solve_matches_tpuslam(init_problem, mono):
    """Mono: 120 LM steps from s = 1 recover s within 2 % (the gate of
    tests/test_imu_init.py); stereo (mono_scale=False): scale stays 1.
    Every output within 1e-7 of tpuslam's, relative to its largest entry."""
    d = init_problem if mono else _init_problem(s_true=1.0)
    K = len(d["Rwb"])
    ea = np.arange(K - 1, dtype=np.int32)
    n_iters = 120 if mono else 30
    jo = JI.inertial_init_solve(jnp.asarray(d["Rwb"]), jnp.asarray(d["p"]), jnp.zeros((K, 3)),
                                jnp.asarray(ea), jnp.asarray(ea + 1), d["jstack"],
                                jnp.asarray(d["info9"]), prior_g=1.0, prior_a=1e8,
                                n_iters=n_iters, mono_scale=mono)
    to = TI.inertial_init_solve(T(d["Rwb"]), T(d["p"]), torch.zeros((K, 3), dtype=torch.float64),
                                torch.as_tensor(ea), torch.as_tensor(ea + 1), d["tstack"],
                                T(d["info9"]), prior_g=1.0, prior_a=1e8, n_iters=n_iters,
                                mono_scale=mono)
    assert set(to) == set(jo)
    for k in set(jo) - {"cost"}:
        close(to[k], jo[k], 1e-7)
    # the cost is the initial cost plus the accepted decrements: its
    # rounding is that of the initial cost (up to ~1e10 here)
    cost0 = float(TI.inertial_init_solve(
        T(d["Rwb"]), T(d["p"]), torch.zeros((K, 3), dtype=torch.float64), torch.as_tensor(ea),
        torch.as_tensor(ea + 1), d["tstack"], T(d["info9"]), prior_g=1.0, prior_a=1e8, n_iters=0,
        mono_scale=mono)["cost"])
    assert abs(float(to["cost"]) - float(jo["cost"])) <= 1e-12 * cost0
    s = float(to["scale"])
    g_est = to["Rwg"].numpy() @ np.array([0.0, 0.0, -1.0])
    assert float(np.dot(g_est, d["g_vis"])) > 0.9998
    if mono:
        assert abs(s - d["s_true"]) / d["s_true"] < 0.02, s
        np.testing.assert_allclose(to["bg"].numpy(), d["bg_true"], atol=5e-4)
        np.testing.assert_allclose(to["v"].numpy(), d["v"], atol=0.05)
    else:
        assert s == 1.0
