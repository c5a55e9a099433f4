"""Distributed-BA benchmark of the PyTorch port (the counterpart of
bench_dist.py): LM-step throughput at a large local-BA scale, and the
engine's distributed GBA route over N ranks.

Problem (as bench_dist.py): K=30 poses, P=3000 landmarks, O=15360
observations (a large covisibility-window local BA; ref
Optimizer::LocalBundleAdjustment window sizes, src/Optimizer.cc:1699-1788).
One iteration = one damped-LM trial step of
tpuslam_torch/parallel/dist_ba.make_dist_ba_step: residual / Jacobian
reduction, Schur rhs, a 15-iteration matrix-free PCG on the reduced camera
system, landmark back-substitution and the post-step cost, everything the
solver does per accepted step.

    python3 bench_dist_torch.py                # one-rank NCCL group on the card: iters/s
    python3 bench_dist_torch.py --cpu-mesh     # 1 and 8 gloo ranks on the CPU: ms/step
    python3 bench_dist_torch.py --dryrun 4     # the engine's GBA over 4 gloo ranks on the card
    python3 bench_dist_torch.py --dryrun 4 --device cpu

--dryrun N is the counterpart of __graft_entry__.dryrun_multichip: the
engine's LoopCloser._snapshot_gba -> _solve_gba -> _apply_gba at K=30,
P=3000, O > 10,000 over N ranks, whose GBA must take the distributed route
and more than halve the reprojection cost of a noisy map.

NOTE: ranks on one host share its cores, and ranks that share one card
talk through gloo, which stages CUDA tensors through the host: such runs
show the sharding's overhead, not scaling. True scaling needs one card per
rank (NCCL). Prints one JSON line per measurement, each with its device
and backend.
"""

import json
import sys
import time

import numpy as np
import torch

from tpuslam_torch.parallel import dist_ba as D
from tpuslam_torch.parallel import launch

FX = 200.0
CX, CY = 376.0, 240.0


def build_problem(rng, K=30, P=3000, O=15360, FX=200.0):
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = (rng.randn(K, 3) * 0.1).astype(np.float32)
    X = np.stack([rng.randn(P) * 2, rng.randn(P) * 2,
                  rng.rand(P) * 4 + 3], -1).astype(np.float32)
    obs_kf = rng.randint(0, K, O).astype(np.int32)
    obs_pt = rng.randint(0, P, O).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[obs_kf], X[obs_pt]) + t[obs_kf]
    uvr = np.zeros((O, 3), np.float32)
    uvr[:, 0] = FX * Xc[:, 0] / Xc[:, 2] + 376.0
    uvr[:, 1] = FX * Xc[:, 1] / Xc[:, 2] + 240.0
    uvr[:, :2] += rng.randn(O, 2).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    valid = Xc[:, 2] > 0.2
    return R, t, X, obs_kf, obs_pt, uvr, fixed, valid


def problem_args():
    """build_problem(seed 0) as dist_ba_solve / ba_solve_np arguments:
    (R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fixed, fx,
    fy, cx, cy, bf)."""
    R, t, X, obs_kf, obs_pt, uvr, fixed, valid = build_problem(np.random.RandomState(0))
    O = len(obs_kf)
    return (R, t, X, obs_kf, obs_pt, uvr, np.ones(O, np.float32), np.zeros(O, bool), valid,
            fixed, FX, FX, CX, CY, 0.0)


def problem_cost(R, t, X):
    """The solver's objective at (R, t, X): the Huber cost (chi2 gate 5.991,
    unit information) of problem_args()'s valid observations in front of
    their camera, in f64 on the host."""
    _, _, _, obs_kf, obs_pt, uvr, is2, _, valid, *_ = problem_args()
    Xc = np.einsum("oij,oj->oi", R[obs_kf], X[obs_pt]) + t[obs_kf]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FX * Xc[:, 1] / Xc[:, 2] + CY], 1)
    chi2 = np.sum((uv - uvr[:, :2]) ** 2, 1) * is2
    d2 = 5.991
    c = np.where(chi2 <= d2, chi2, 2.0 * np.sqrt(d2 * chi2) - d2)
    return float(c[valid & (Xc[:, 2] > 0)].sum())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def trial_step(group, device):
    """(step, args): the LM trial step of make_dist_ba_step (15 PCG
    iterations, f32, lambda 1e-3) at K30 / P3000 / O15360 on this rank's
    slice of the observations, and its arguments; every rank of `group`
    calls step(*args) together."""
    R, t, X, obs_kf, obs_pt, uvr, is2, st, valid, fixed, *_ = problem_args()
    f32 = torch.float32
    rows = D.LocalRows(group, obs_pt, device, f32)
    args = [torch.as_tensor(a, device=device) for a in (R, t, X, fixed)]
    args.append(torch.tensor(1e-3, dtype=f32, device=device))
    args.extend(rows.observations(obs_kf, obs_pt, uvr, is2, st, valid))
    return D.make_dist_ba_step(group, FX, FX, CX, CY, 0.0, cg_iters=15), args


def time_step(group, device, reps=20, warmup=3):
    """Seconds per trial_step: host clock around `reps` steps ending in a
    device synchronize, after `warmup` steps."""
    step, args = trial_step(group, device)
    for _ in range(warmup):
        out = step(*args)
    assert np.isfinite(float(out[4]))
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(*args)
    c = float(out[4])
    _sync(device)
    dt = (time.perf_counter() - t0) / reps
    assert np.isfinite(c)
    return dt


def _rank_device(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return dev


def step_rank(rank, world, device, reps):
    """launch.run target: time_step on every rank of the default group."""
    return time_step(None, _rank_device(device), reps)


# ----------------------------------------------------------- the dry run
def dryrun_closer(K=30, P=3000, slots=512, device="cuda"):
    """__graft_entry__.dryrun_multichip's map (K keyframes 0.12 m apart on a
    line, each seeing `slots` of P points with 0.5 px noise, poses and
    points perturbed by 2 cm) and a LoopCloser on it that routes every GBA
    to the distributed solver (dist_gba_min_obs = 0). Returns (closer,
    snapshot, cost), cost(R, t, X) the mean squared reprojection error."""
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import LoopConfig, SlamConfig
    from tpuslam_torch.engine.loop_closing import LoopCloser
    from tpuslam_torch.map.store import FrameFeatures, SlamMap
    from tpuslam_torch.place import train_vocabulary

    rng = np.random.RandomState(0)
    fx = fy = 200.0
    cx, cy = 376.0 / 2, 240.0 / 2
    cam = Pinhole([fx, fy, cx, cy], 376, 240)
    X = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)], 1)
    m = SlamMap(n_feat=slots)
    mp_of = np.full(P, -1, np.int64)
    for k in range(K):
        R = np.eye(3)
        t = np.array([0.12 * k, 0.0, 0.0])
        sel = rng.choice(P, slots, replace=False)
        Xc = X[sel] @ R.T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], 1)
        uv += rng.randn(*uv.shape) * 0.5
        ok = Xc[:, 2] > 0.2
        f = FrameFeatures(
            xy=uv, und_xy=uv.copy(), norm_xy=(uv - [cx, cy]) / [fx, fy],
            octave=np.zeros(slots, np.int32), angle=np.zeros(slots), response=np.ones(slots),
            bits=np.zeros((slots, 256), np.uint8), packed=np.zeros((slots, 8), np.uint32),
            valid=ok)
        kf = m.add_keyframe(R, t, f, float(k), k)
        m.kf_t[kf] = t + (rng.randn(3) * 0.02 if k else 0.0)
        for slot in np.nonzero(ok)[0]:
            j = sel[slot]
            if mp_of[j] < 0:
                mp_of[j] = m.add_point(X[j] + rng.randn(3) * 0.02, kf, int(slot))
            else:
                m.add_observation(int(mp_of[j]), kf, int(slot))
        m.update_connections(kf)
    vocab = train_vocabulary((rng.rand(64, 256) > 0.5).astype(np.uint8), k=4, L=2, iters=2,
                             device=device)
    cfg = SlamConfig(loop=LoopConfig(dist_gba_min_obs=0, background_gba=False))
    lc = LoopCloser(cam, cfg, m, vocab, device=device)
    snap = lc._snapshot_gba(fix_kf=0)

    def cost(R, t, Xp):
        Xc = np.einsum("oij,oj->oi", R[snap["obs_kf"]], Xp[snap["obs_pt"]]) + t[snap["obs_kf"]]
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], 1)
        return float(np.mean(np.sum((uv - snap["uvr"][:, :2]) ** 2, 1)))

    return lc, snap, cost


def _dryrun_lead(K, P, slots, device, n_iters):
    lc, snap, cost = dryrun_closer(K, P, slots, device)
    c0 = cost(snap["R"], snap["t"], snap["X"])
    t0 = time.perf_counter()
    solved = lc._solve_gba(snap, n_iters=n_iters)
    dt = time.perf_counter() - t0
    lc._apply_gba(snap, solved)
    return dict(cost_before=c0, cost_after=cost(*solved), obs=len(snap["obs_kf"]),
                solve_s=dt, solved=solved)


def dryrun_rank(rank, world, K, P, slots, device, n_iters=6):
    """launch.run target: rank 0 builds dryrun_closer's map and runs the
    engine's GBA (snapshot -> _solve_gba -> _apply_gba), its solve
    dispatched to the other ranks, which serve until it releases them.
    Rank 0 returns (cost before, cost after, observations, solve seconds,
    the solved (R, t, X), the distributed solves run); the others the
    number of problems they served."""
    dev = _rank_device(device)
    if rank:
        return D.serve(device=dev)
    D.counter.__init__()
    try:
        res = _dryrun_lead(K, P, slots, dev, n_iters)
    finally:
        D.release_followers()
    return dict(res, dist_solves=D.counter.ba)


def dryrun(n_ranks, device="cuda", timeout=600.0):
    """The dry run at K=30, P=3000 over n_ranks gloo ranks, with
    dryrun_multichip's checks; returns rank 0's result."""
    res = launch.run(dryrun_rank, n_ranks, args=(30, 3000, 512, str(device)),
                     timeout=timeout)[0]
    if res["obs"] <= 10_000:
        raise AssertionError(f"dry run: {res['obs']} observations")
    if res["dist_solves"] == 0:
        raise AssertionError("dry run: the GBA did not take the distributed route")
    if not (np.isfinite(res["cost_after"]) and res["cost_after"] < 0.5 * res["cost_before"]):
        raise AssertionError(f"dry run: cost {res['cost_before']} -> {res['cost_after']}")
    return res


# ------------------------------------------------- a window inertial BA
def vi_window_map(device="cuda"):
    """A window inertial BA problem in the manner of
    tests/test_engine_vi._build_map: 10 keyframes at 4 fps on the
    renderer's forward arc, IMU at 400 Hz preintegrated between them (f32,
    on `device`), 300 points 3-8 m ahead of the middle keyframe seen by
    every keyframe, perfect measurements (seed 0); then every keyframe
    after the first is moved (0.6 deg, 3 cm, 5 cm/s;
    test_recovers_perturbed_window's perturbation). Returns (map, camera,
    calib, keyframes, ground-truth (kf_R, kf_t, kf_vel))."""
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.core.lie import so3_exp
    from tpuslam_torch.engine.inertial import _preintegrate_np
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.map.store import FrameFeatures, SlamMap

    K, P = 10, 300
    rng = np.random.RandomState(0)
    fx = fy = 300.0
    cx = cy = 200.0
    seq = SyntheticSequence(n_frames=K, fps=4.0, imu_rate=400.0)
    tr, times = seq.traj, seq.timestamps()
    calib = ImuCalib(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5, freq=400.0)
    m = SlamMap(n_feat=P)
    mid = K // 2
    Xc = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(3, 8, P)], 1)
    Xw = Xc @ tr.pose_cw(times[mid])[0] + tr.pos(times[mid])
    kfs = []
    for k in range(K):
        Rcw, tcw = tr.pose_cw(times[k])
        Xck = Xw @ Rcw.T + tcw
        uv = np.stack([fx * Xck[:, 0] / Xck[:, 2] + cx, fy * Xck[:, 1] / Xck[:, 2] + cy], 1)
        f = FrameFeatures(
            xy=uv.copy(), und_xy=uv.copy(), norm_xy=Xck[:, :2] / Xck[:, 2:3],
            octave=np.zeros(P, np.int32), angle=np.zeros(P), response=np.ones(P),
            bits=np.zeros((P, 256), np.uint8), packed=np.zeros((P, 8), np.uint32),
            valid=Xck[:, 2] > 0.2)
        kf = m.add_keyframe(Rcw, tcw, f, times[k], k)
        kfs.append(kf)
        m.kf_vel[kf] = tr.vel(times[k])
    for j in range(P):
        mp = m.add_point(Xw[j], kfs[0], j)
        for k in kfs[1:]:
            m.add_observation(mp, k, j)
    for kf in kfs:
        m.update_connections(kf)
    for a, b in zip(kfs[:-1], kfs[1:]):
        ts, ws, accs = seq.imu_between(times[a], times[b])
        dts = np.diff(np.concatenate([[times[a]], ts]))
        m.kf_preint[b] = _preintegrate_np(ws, accs, dts, np.zeros(3), np.zeros(3), calib, device)
        m.kf_imu[b] = (ws, accs, dts)
        m.kf_prev[b] = a
    gt = (m.kf_R[kfs].copy(), m.kf_t[kfs].copy(), m.kf_vel[kfs].copy())
    for k in kfs[1:]:
        dR = so3_exp(torch.as_tensor(rng.randn(3) * 0.01)).numpy()
        m.kf_R[k] = dR @ m.kf_R[k]
        m.kf_t[k] = m.kf_t[k] + rng.randn(3) * 0.03
        m.kf_vel[k] = m.kf_vel[k] + rng.randn(3) * 0.05
    return m, Pinhole([fx, fy, cx, cy], 400, 400), calib, kfs, gt


def vi_window_ba(device, n_iters=12):
    """vi_window_map's problem through the engine's window_inertial_ba (f32):
    the distributed FullInertialBA in a group of more than one rank
    (DIST_VIBA_MIN_OBS = 0), vi_ba_solve outside one. Returns (kf_R, kf_t,
    kf_vel) after the solve, the ground truth, observations, seconds."""
    from tpuslam_torch.engine import inertial as EI

    m, cam, calib, kfs, gt = vi_window_map(device=device)
    EI.DIST_VIBA_MIN_OBS = 0
    t0 = time.perf_counter()
    EI.window_inertial_ba(m, cam, calib, np.ones(8), opt_kfs=kfs, fixed_kfs=[],
                          n_iters=n_iters, fix_first=True, device=device)
    dt = time.perf_counter() - t0
    return dict(state=(m.kf_R[kfs], m.kf_t[kfs], m.kf_vel[kfs]), gt=gt,
                obs=sum(len(m.mp_obs[j]) for j in range(m.n_mp)), solve_s=dt)


def dist_checks_rank(rank, world, device):
    """launch.run target of chip_smoke.py's phase 10 (b, c), on every rank:
    problem_args() through dist_ba_solve (10 accepted steps) and
    time_step (5 steps); then rank 0 runs the engine's GBA dry run and
    vi_window_ba, their solves dispatched to the other ranks, which serve
    until it releases them. Returns a dict per rank."""
    dev = _rank_device(device)
    D.counter.__init__()
    R, t, X, cost = D.dist_ba_solve(None, *problem_args(), n_iters=10, device=dev)
    out = dict(problem=(R, t, X, cost), accepted=D.counter.accepted, trials=D.counter.trials,
               step_s=time_step(None, dev, reps=5))
    if rank:
        return dict(out, served=D.serve(device=dev))
    D.counter.__init__()
    try:
        out["dryrun"] = _dryrun_lead(30, 3000, 512, dev, 6)
        out["vi"] = vi_window_ba(dev)
    finally:
        D.release_followers()
    return dict(out, ba_solves=D.counter.ba, viba_solves=D.counter.viba)


def _device_name(device):
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv):
    if "--dryrun" in argv:
        n = int(argv[argv.index("--dryrun") + 1])
        device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
        res = dryrun(n, device)
        print(json.dumps({
            "metric": f"dist_gba_dryrun_ranks{n}", "value": res["solve_s"], "unit": "s",
            "cost_before": res["cost_before"], "cost_after": res["cost_after"],
            "obs": res["obs"], "dist_solves": res["dist_solves"], "backend": "gloo",
            "device": _device_name(device)}))
        return 0
    if "--cpu-mesh" in argv:
        for n in (1, 8):
            dt = launch.run(step_rank, n, args=("cpu", 5), timeout=600.0)[0]
            print(json.dumps({
                "metric": f"dist_ba_step_ms_vmesh{n}", "value": dt * 1e3, "unit": "ms/step",
                "backend": "gloo", "device": "cpu",
                "note": "the ranks share one host's cores: overhead check, not true scaling"}))
        return 0
    # the card: a one-rank NCCL group
    if not torch.cuda.is_available():
        print("bench_dist_torch: no CUDA device (use --cpu-mesh for the CPU)", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    launch.init_rank(0, 1, launch.free_port(), "nccl", 600.0)
    try:
        dt = time_step(None, torch.device("cuda", 0), reps=20)
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({
        "metric": "dist_ba_step_iters_per_s_K30_P3000_O15360", "value": 1.0 / dt,
        "unit": "iters/s", "backend": "nccl", "ranks": 1, "device": _device_name("cuda")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
