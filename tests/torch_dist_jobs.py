"""Rank functions of the port's distributed tests (tests/test_torch_dist_*.py,
tests/test_torch_vi_engine.py).

tpuslam_torch.parallel.launch.run starts each rank in a fresh process that
imports this module, so it imports only the port (never jax, tpuslam or the
tests' conftest). Every function takes (rank, world, ...), runs on the CPU
and returns what the test reads, with the foreign modules the rank loaded.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from tpuslam_torch.parallel import dist_ba as D


def foreign_modules():
    """Modules of jax, tpuslam or the tests' conftest loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "tpuslam", "conftest"))


def solve_cases(rank, world, cases):
    """Each case (n, kind, args, kw) is dist_ba_solve ("ba") or
    dist_viba_solve ("viba") of the whole problem over ranks 0..n-1 (a
    subgroup of the default group when n < world). Returns one entry per
    case: this rank's solution, the LM steps accepted and tried, and the
    foreign modules loaded; None where the rank is outside the case's group."""
    out = []
    for n, kind, args, kw in cases:
        group = None if n == world else dist.new_group(list(range(n)))
        if rank >= n:
            out.append(None)
            continue
        D.counter.__init__()
        res = D.SOLVERS[kind](group, *args, device="cpu", **kw)
        out.append(dict(out=res, accepted=D.counter.accepted, trials=D.counter.trials,
                        foreign=foreign_modules()))
    return out


def window_viba(rank, world, state, camera, calib, opt_kfs, n_iters):
    """Rank 0: window_inertial_ba (f64) on the map `state` (map_state's
    arrays) with DIST_VIBA_MIN_OBS = 0, its solve dispatched to the other
    ranks, which serve until rank 0 releases them. Rank 0 returns the map's
    keyframe states and the distributed solves it ran."""
    from tpuslam_torch.engine import inertial as EI
    from tpuslam_torch.map.store import map_from_numpy

    if rank:
        return dict(served=D.serve(device="cpu"), foreign=foreign_modules())
    D.counter.__init__()
    EI.DIST_VIBA_MIN_OBS = 0
    m = map_from_numpy(*state)
    try:
        EI.window_inertial_ba(m, camera, calib, np.ones(8), opt_kfs=opt_kfs, fixed_kfs=[],
                              n_iters=n_iters, fix_first=True, device="cpu",
                              dtype=torch.float64)
    finally:
        D.release_followers()
    return dict(kf_R=m.kf_R[opt_kfs], kf_t=m.kf_t[opt_kfs], kf_vel=m.kf_vel[opt_kfs],
                viba=D.counter.viba, foreign=foreign_modules())


def inertial_closer(state, camera, calib):
    """A LoopCloser (synchronous GBA, f64 on the CPU) over the map `state`
    (map_state's arrays), its mapper holding the IMU calibration."""
    from tpuslam_torch.engine.config import LoopConfig, SlamConfig
    from tpuslam_torch.engine.local_mapping import LocalMapper
    from tpuslam_torch.engine.loop_closing import LoopCloser
    from tpuslam_torch.map.store import map_from_numpy
    from tpuslam_torch.place import train_vocabulary

    m = map_from_numpy(*state)
    cfg = SlamConfig(loop=LoopConfig(background_gba=False))
    f64 = dict(device="cpu", dtype=torch.float64)
    descs = (np.random.RandomState(3).rand(120, 256) > 0.5).astype(np.uint8)
    lm = LocalMapper(camera, cfg, m, imu_calib=calib, mono=True, **f64)
    return LoopCloser(camera, cfg, m, train_vocabulary(descs, k=5, L=2, iters=3, device="cpu"),
                      local_mapper=lm, **f64)


def inertial_gba(rank, world, state, camera, calib, fix_kf, n_iters):
    """Rank 0: inertial_closer's FullInertialBA snapshot and its chunked
    solve (LoopCloser._solve_gba_vi) with DIST_VIBA_MIN_OBS = 0, its chunks
    dispatched to the other ranks, which serve until rank 0 releases them.
    Rank 0 returns the solved states and the distributed solves it ran."""
    from tpuslam_torch.engine import inertial as EI

    if rank:
        return dict(served=D.serve(device="cpu"), foreign=foreign_modules())
    D.counter.__init__()
    EI.DIST_VIBA_MIN_OBS = 0
    lc = inertial_closer(state, camera, calib)
    try:
        solved = lc._solve_gba_vi(lc._snapshot_gba(fix_kf), n_iters=n_iters)
    finally:
        D.release_followers()
    return dict(solved=solved, viba=D.counter.viba, foreign=foreign_modules())


def system_shutdown(rank, world):
    """Rank 0 builds a System and shuts it down twice, and returns whether
    its distributed route was open before and after; the others serve and
    return the problems they served."""
    if rank:
        return D.serve(device="cpu")
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig
    from tpuslam_torch.engine.system import Sensor, System

    slam = System(Pinhole([200.0, 200.0, 100.0, 75.0], 200, 150),
                  SlamConfig(orb=OrbConfig(n_features=300)), sensor=Sensor.MONOCULAR,
                  device="cpu")
    open_before = D.route_open()
    slam.shutdown()
    slam.shutdown()              # a second shutdown sends nothing
    return open_before, D.route_open()


def fail_on_rank1(rank, world):
    """Rank 1 raises; the others wait in a collective that rank 1 never
    joins."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
