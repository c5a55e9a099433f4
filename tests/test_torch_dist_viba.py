"""The port's distributed FullInertialBA (dist_viba_solve) against tpuslam's
on the CPU, on tests/test_inertial_ba._make_problem with the arguments of
tests/test_dist_viba._dist_solve (K = 6 keyframes, 60 points, perfect IMU,
f64, 300 CG iterations): over 2 and 4 gloo ranks against tpuslam's
8-device mesh, poses, velocities and biases within 1e-6 and the same count
of accepted LM steps, every rank's states bitwise equal. tpuslam's
fixed-pose test is a case. The engine's window inertial BA over ranks is
in tests/test_torch_vi_engine.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_inertial_ba import _make_problem
from tests.test_torch_dist_ba import _tpuslam_solve, run_cases
from tpuslam.core import lie as JL
from tpuslam.parallel import dist_ba as JD


def _start(rng, d, scenario):
    """(Rwb, p, v, bg, ba, X, fixed) of a scenario: "recovers" perturbs
    every state as tests/test_dist_viba.py's recovery test does,
    "fixed_pose_stays" moves every position but the fixed first one."""
    K, P = d["K"], d["P"]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    if scenario == "fixed_pose_stays":
        pn = d["p"] + np.concatenate([np.zeros((1, 3)), rng.randn(K - 1, 3) * 0.03])
        return d["Rwb"].copy(), pn, d["v"], np.zeros((K, 3)), np.zeros((K, 3)), d["X"], fixed
    Rn, pn = d["Rwb"].copy(), d["p"].copy()
    vn = d["v"] + rng.randn(K, 3) * 0.05
    for k in range(1, K):
        Rn[k] = Rn[k] @ np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.02)))
        pn[k] = pn[k] + rng.randn(3) * 0.05
    Xn = d["X"] + rng.randn(P, 3) * 0.05
    return (Rn, pn, vn, np.tile(rng.randn(3) * 0.01, (K, 1)), np.tile(rng.randn(3) * 0.05, (K, 1)),
            Xn, fixed)


CASES = [("recovers", 2, 10), ("recovers", 4, 10), ("fixed_pose_stays", 2, 8)]


def _args(case, d, state):
    """dist_viba_solve's arguments after the group for a case on problem d,
    its start drawn from the rng state `_make_problem` left (seed 0, as the
    rng fixture gives)."""
    rng = np.random.RandomState()
    rng.set_state(state)
    K = d["K"]
    Rwb, p, v, bg, ba, X, fixed = _start(rng, d, case[0])
    pre = {k: np.asarray(a) for k, a in d["pre_stack"].items()}
    return (Rwb, p, v, bg, ba, X, d["obs_kf"], d["obs_pt"], d["uvr"], d["inv_sigma2"],
            d["stereo"], d["valid"], d["edges_a"], d["edges_b"], pre, np.asarray(d["info9"]),
            np.zeros((K, 3)), np.zeros((K, 3)), d["rw_info_g"], d["rw_info_a"], fixed,
            d["fx"], d["fy"], d["cx"], d["cy"], 0.0, np.eye(3), np.zeros(3))


@pytest.fixture(scope="module")
def solved():
    """Every case: the port's solve (one group of 4 gloo ranks), tpuslam's
    and the problem, by case."""
    rng = np.random.RandomState(0)
    d = _make_problem(rng)
    args = [_args(c, d, rng.get_state()) for c in CASES]
    kw = [dict(n_iters=n, cg_iters=300) for _, _, n in CASES]
    ours = run_cases([(ranks, "viba", a, dict(k, dtype=torch.float64))
                      for (_, ranks, _), a, k in zip(CASES, args, kw)])
    return {c: (port, _tpuslam_solve(JD.dist_viba_solve, "make_dist_viba_step", *a, **k), d)
            for c, port, a, k in zip(CASES, ours, args, kw)}


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_dist_viba_matches_tpuslam(solved, case):
    port, (out_j, acc_j), d = solved[case]
    out = port["out"]
    assert port["accepted"] == acc_j
    for name, a, b in zip(("Rwb", "p", "v", "bg", "ba"), out, out_j):
        assert np.abs(a - np.asarray(b)).max() < 1e-6, name
    assert out[6] == pytest.approx(float(out_j[6]), rel=1e-6, abs=1e-9)
    if case[0] == "fixed_pose_stays":
        np.testing.assert_allclose(out[1][0], d["p"][0], atol=1e-12)
        np.testing.assert_allclose(out[0][0], d["Rwb"][0], atol=1e-12)
