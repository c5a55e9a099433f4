"""Pose LM: the port's plain version (what the wrapper runs on CPU tensors)
vs tpuslam's fused Pallas solver in interpret mode and vs its XLA solver.

Tolerances: against the Pallas semantics it follows step for step, R 1e-4,
t 1e-3 and inlier agreement >= 0.99 (f32 sums in another order); against
pose_optimize, whose solve adds iterative refinement, the tolerances of
tests/test_pose_opt_pallas.py (R 2e-4, t 2e-3, agreement > 0.97).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import lie
from tpuslam.solve.pose_opt import pose_optimize
from tpuslam.solve.pose_opt_pallas import _chol6_solve, pose_optimize_fused
from tpuslam_torch.solve import pose_opt_cuda

torch.set_num_threads(2)
f32 = np.float32
CASES = {"mono": dict(), "stereo": dict(stereo=True), "n217": dict(n=217)}


def _problem(n=300, stereo=False, outliers=30, seed=0):
    """numpy inputs (as tests/test_pose_opt_pallas.py builds them)."""
    rng = np.random.RandomState(seed)
    fx = fy = 458.0
    cx, cy = 376.0, 240.0
    bf = 47.9 if stereo else 0.0
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 2], -1).astype(f32)
    u = fx * X[:, 0] / X[:, 2] + cx
    v = fy * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3).astype(f32) * 0.3
    uvr[:outliers] += rng.randn(outliers, 3) * 40
    is_stereo = np.zeros(n, bool)
    if stereo:
        is_stereo[: n // 2] = True
    dR, dt = lie.se3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.02, -0.015, 0.01], jnp.float32))
    arrays = (np.asarray(dR, f32), np.asarray(dt, f32), X, uvr.astype(f32),
              np.ones(n, f32), is_stereo, np.ones(n, bool))
    return arrays, (fx, fy, cx, cy, bf)


def _run_port(arrays, scalars, **kw):
    out = pose_opt_cuda.pose_optimize_fused(*map(torch.tensor, arrays), *scalars, **kw)
    return [o.numpy() for o in out]


def _run_jax(fn, arrays, scalars, **kw):
    return [np.asarray(o) for o in fn(*map(jnp.asarray, arrays), *scalars, **kw)]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arrays, scalars = _problem(**CASES[request.param])
    return arrays, scalars, _run_port(arrays, scalars)


def test_plain_matches_pallas_interpret(case):
    arrays, scalars, (R, t, inl, chi2) = case
    Rj, tj, inlj, chi2j = _run_jax(pose_optimize_fused, arrays, scalars, interpret=True)
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-3)
    assert np.mean(inl == inlj) >= 0.99
    assert chi2.shape == chi2j.shape and inl.dtype == bool


def test_plain_matches_xla_pose_optimize(case):
    arrays, scalars, (R, t, inl, _) = case
    Rj, tj, inlj, _ = _run_jax(pose_optimize, arrays, scalars)
    np.testing.assert_allclose(R, Rj, atol=2e-4)
    np.testing.assert_allclose(t, tj, atol=2e-3)
    assert np.mean(inl == inlj) > 0.97


def test_recovers_true_pose(case):
    _, _, (R, t, inl, _) = case
    np.testing.assert_allclose(R, np.eye(3), atol=5e-3)
    np.testing.assert_allclose(t, 0.0, atol=2e-2)
    assert not inl[:25].any()        # the gross outliers are rejected


@pytest.mark.parametrize("n_rounds", [1, 2])
def test_short_schedules_match_pallas(n_rounds):
    arrays, scalars = _problem(stereo=True, seed=3)
    R, t, inl, _ = _run_port(arrays, scalars, n_rounds=n_rounds)
    Rj, tj, inlj, _ = _run_jax(pose_optimize_fused, arrays, scalars, n_rounds=n_rounds,
                               interpret=True)
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-3)
    assert np.mean(inl == inlj) >= 0.99


@pytest.mark.parametrize("n,stereo,n_rounds,n_iters", [(217, False, 2, 3), (217, True, 4, 1),
                                                       (300, True, 3, 0), (256, False, 1, 10)])
def test_step_counts_match_pallas(n, stereo, n_rounds, n_iters):
    """The plain version's schedule (one evaluation per step at the trial
    pose, H/g/cost at P kept) at other step counts, including none (only
    the re-classification between rounds) and a single step."""
    arrays, scalars = _problem(n=n, stereo=stereo, seed=5)
    R, t, inl, chi2 = _run_port(arrays, scalars, n_rounds=n_rounds, n_iters=n_iters)
    Rj, tj, inlj, chi2j = _run_jax(pose_optimize_fused, arrays, scalars, n_rounds=n_rounds,
                                   n_iters=n_iters, interpret=True)
    np.testing.assert_allclose(R, Rj, atol=1e-4)
    np.testing.assert_allclose(t, tj, atol=1e-3)
    assert np.mean(inl == inlj) >= 0.99
    if n_iters == 0:
        np.testing.assert_allclose(chi2, chi2j, rtol=1e-4)   # f32 residuals


@pytest.mark.parametrize("seed", [0, 1])
def test_chol6_solve_matches_pallas(seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(12, 6).astype(f32)
    H = (A.T @ A * np.array([1e5, 1e5, 1e5, 1, 1, 1], f32)).astype(f32)
    b = rng.randn(6).astype(f32)
    ref = _chol6_solve([[jnp.float32(H[i, j]) for j in range(6)] for i in range(6)],
                       [jnp.float32(v) for v in b], jnp.float32(1e-3))
    got = pose_opt_cuda._chol6_solve(torch.tensor(H), torch.tensor(b), torch.tensor(1e-3))
    np.testing.assert_allclose(got.numpy(), np.array([float(v) for v in ref]), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("xi", [[0.1, -0.2, 0.3, 0.02, -0.015, 0.01], [0.1, 0.2, 0.3, 1e-5, 0, 0]])
def test_se3_exp_matches_lie(xi):
    Rj, tj = lie.se3_exp(jnp.asarray(xi, jnp.float32))
    R, t = pose_opt_cuda._se3_exp(torch.tensor(xi, dtype=torch.float32))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-6)


def test_wrapper_dispatch_and_checks():
    arrays, scalars = _problem(n=40)
    before = pose_opt_cuda.counter.launches
    _run_port(arrays, scalars, n_rounds=1, n_iters=2)
    assert pose_opt_cuda.counter.launches == before      # CPU: plain version, no launch
    meta = [torch.tensor(a).to("meta") for a in arrays]
    with pytest.raises(ValueError):
        pose_opt_cuda.pose_optimize_fused(*meta, *scalars)
