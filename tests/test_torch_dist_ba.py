"""The port's distributed BA (tpuslam_torch/parallel/dist_ba.py) against
tpuslam's on the CPU.

  * shard_observations / pack_sharded equal tpuslam's.
  * dist_ba_solve over 2 and 4 gloo ranks equals tpuslam's dist_ba_solve on
    the conftest's 8-device CPU mesh, on tests/test_solve._prep_ba's
    problem: f64 within 1e-6 in R and t and the same count of accepted LM
    steps; one f32 case within 1e-3 (near the optimum an f32 trial's cost
    change is rounding, so which trials are accepted, and where in the flat
    valley the solve stops, differs between two summation orders: the
    costs agree to 1e-5); every rank returns bitwise-equal states.
    tpuslam's in-step-acceptance test (a hard start) is a case.
  * The engine's route: LoopCloser._solve_gba with dist_gba_min_obs = 0 over
    2 ranks lands on the single-rank result (bench_dist_torch's dry run at a
    small K / P), and System.shutdown releases a follower, which exits 0.
  * A rank that raises fails the whole run at once and leaves no process.

The ranks are fresh processes started on tests/torch_dist_jobs.py, which
imports only the port; each group has a timeout.
"""

import multiprocessing
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import bench_dist_torch
import torch_dist_jobs as jobs
from tests.test_solve import BF, CX, CY, FX, FY, _prep_ba
from tpuslam.parallel import dist_ba as JD
from tpuslam_torch.parallel import dist_ba as D
from tpuslam_torch.parallel import launch

TIMEOUT = 120.0
NAMES = ("R", "t", "X", "obs_kf", "obs_pt", "uvr", "inv_sigma2", "stereo", "valid", "fixed")


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_and_pack_equal_tpuslam(rng, n_shards):
    obs_pt = rng.randint(0, 50, 700).astype(np.int32)
    shards, per = D.shard_observations(obs_pt, n_shards)
    assert (shards, per) == JD.shard_observations(obs_pt, n_shards)
    for arr, fill in ((obs_pt, 0), (rng.randn(700, 3), 0.0), (rng.rand(700) > 0.5, False)):
        a = D.pack_sharded(arr, shards, per, fill)
        b = JD.pack_sharded(arr, shards, per, fill)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _tpuslam_solve(solver, maker, *args, **kw):
    """tpuslam's solve on the 8-device mesh, with the (cost before, cost
    after) of every LM trial recorded: its step runs jitted as always, the
    host loop around it reads the costs. Returns (its result, the LM steps
    it accepted)."""
    trials = []
    make = getattr(JD, maker)

    def recording(*a, **k):
        step = jax.jit(make(*a, **k))

        def run(*x):
            out = step(*x)
            trials.append((float(out[-2]), float(out[-1])))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JD, maker, recording)
        mp.setattr(JD, "jax", types.SimpleNamespace(jit=lambda f: f, lax=jax.lax, tree=jax.tree))
        out = solver(Mesh(np.array(jax.devices()[:8]), ("obs",)), *args, **kw)
    return out, sum(c1 < c0 for c0, c1 in trials)


def run_cases(cases):
    """Every case (n, kind, args, kw) solved by the port over ranks 0..n-1
    of ONE group of max(n) gloo ranks (a process start costs seconds), the
    ranks' results checked bitwise equal and free of jax / tpuslam; returns
    rank 0's result of each case."""
    world = max(c[0] for c in cases)
    res = launch.run(jobs.solve_cases, world, args=(cases,), timeout=TIMEOUT)
    lead = []
    for i, (n, *_) in enumerate(cases):
        ranks = [res[r][i] for r in range(n)]
        for r in ranks[1:]:
            for a, b in zip(ranks[0]["out"], r["out"]):
                assert np.array_equal(a, b), (i, n)
        assert all(r["foreign"] == [] for r in ranks), ranks[0]["foreign"]
        lead.append(ranks[0])
    return lead


# tpuslam test each scenario follows: _prep_ba's arguments, n_iters
SCENARIOS = {
    "matches_single": (dict(n_pts=80, n_kf=5, noise=0.3), 12),
    "in_step_acceptance": (dict(n_pts=60, n_kf=4, noise=0.3, perturb_pose=0.3, perturb_pt=0.5),
                           25),
}
CASES = [("matches_single", 2, "float64", 1e-6),
         ("matches_single", 4, "float64", 1e-6),
         ("matches_single", 4, "float32", 1e-3),
         ("in_step_acceptance", 4, "float64", 1e-6)]


def _problem(scenario, dtype):
    """The scenario's problem from the seed the rng fixture gives (0), as
    numpy in `dtype`, and its ground truth."""
    kw, n_iters = SCENARIOS[scenario]
    R, t, X, args = _prep_ba(np.random.RandomState(0), **kw)
    a = [np.asarray(args[k]) for k in NAMES]
    a = [x.astype(dtype) if x.dtype.kind == "f" else x for x in a]
    return tuple(a) + (FX, FY, CX, CY, BF), n_iters, (R, t)


@pytest.fixture(scope="module")
def solved():
    """Every case of CASES, tpuslam's solve and the port's, by case."""
    ours = run_cases([(ranks, "ba", _problem(sc, dt)[0],
                       dict(n_iters=SCENARIOS[sc][1], dtype=getattr(torch, dt)))
                      for sc, ranks, dt, _ in CASES])
    out = {}
    for case, port in zip(CASES, ours):
        args, n_iters, _ = _problem(case[0], case[2])
        out[case] = port, _tpuslam_solve(JD.dist_ba_solve, "make_dist_ba_step", *args,
                                         n_iters=n_iters)
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_dist_ba_matches_tpuslam(solved, case):
    scenario, ranks, dtype, tol = case
    port, ((Rj, tj, Xj, cj), acc_j) = solved[case]
    Rf, tf, Xf, cost = port["out"]
    if dtype == "float64":
        assert port["accepted"] == acc_j
    assert np.abs(Rf - Rj).max() < tol
    assert np.abs(tf - tj).max() < tol
    assert cost == pytest.approx(float(cj), rel=1e3 * tol)
    # tpuslam's own gates: the ground truth from the start the test gives
    R, t = _problem(scenario, dtype)[2]
    gate_R, gate_t = (2e-3, 2e-2) if scenario == "matches_single" else (5e-3, 5e-2)
    for k in range(2, len(R)):
        assert np.abs(Rf[k] - R[k]).max() < gate_R, k
        assert np.abs(tf[k] - t[k]).max() < gate_t, k


def test_solve_gba_routes_over_ranks():
    """The engine's GBA with dist_gba_min_obs = 0 over 2 ranks lands on the
    single-rank route's result (the dry run's check, at K = 8, P = 400)."""
    K, P, slots = 8, 400, 128
    lc, snap, cost = bench_dist_torch.dryrun_closer(K, P, slots, "cpu")
    R1, t1, X1 = lc._solve_gba(snap, n_iters=6)          # no group: ba_solve_np
    res = launch.run(bench_dist_torch.dryrun_rank, 2, args=(K, P, slots, "cpu"),
                     timeout=TIMEOUT)
    lead = res[0]
    assert res[1] == lead["dist_solves"] == 3           # 6 iterations in 3 chunks
    R2, t2, X2 = lead["solved"]
    assert lead["cost_after"] < 0.5 * lead["cost_before"]
    assert lead["cost_after"] == pytest.approx(cost(R1, t1, X1), rel=1e-3)
    assert np.abs(R2 - R1).max() < 1e-4
    assert np.abs(t2 - t1).max() < 1e-3


def test_shutdown_releases_a_follower():
    """System.shutdown on rank 0 sends the stop: the follower leaves serve
    having served nothing and its process exits 0; a second shutdown sends
    nothing (else rank 0 would wait on a broadcast no rank joins)."""
    lead, served = launch.run(jobs.system_shutdown, 2, timeout=TIMEOUT)
    assert lead == (True, False)
    assert served == 0


def test_a_failing_rank_fails_the_run():
    """A rank that raises fails launch.run with its traceback at once, and no
    rank outlives the run (the others wait in a collective it never joins)."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed(.|\n)*rank 1 fails"):
        launch.run(jobs.fail_on_rank1, 3, timeout=TIMEOUT)
    assert time.perf_counter() - t0 < 0.5 * TIMEOUT
    assert multiprocessing.active_children() == []
