"""Profile the port's pose-inertial frame solve (solve/pose_inertial.py),
the one solve per frame of the fused visual-inertial step.

    python scripts/profile_vi_solve.py [--rows 512] [--reps 5] [--device cuda]

The problem follows chip_smoke.py phase 7: the renderer's vi_excite
trajectory (seed 0), the last keyframe at t = 2.0 s as the fixed anchor,
the frame at t = 2.1 s started 2 cm and 0.5 deg off its true pose, --rows
map points 2-8 m ahead projected into it at fx = 458 with 0.5 px noise and
10 % gross outliers, the 200 Hz IMU window between the two; f32, 4 rounds
of 10 LM iterations. Reports:
  - the aten operations one solve dispatches, in all and by part (the
    inertial edge's residual and its jacfwd, the prior's residual and its
    jacfwd, the visual rows, the 30-dim damped solve), counted with a
    TorchDispatchMode (any device; the count does not depend on it);
  - on a card: the host wall time of one solve that ends in a synchronize
    (median of --reps), and from a torch.profiler trace of one solve the
    device's busy time, its idle share and the kernels launched.
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def make_problem(rows, device, dtype, seed=0):
    """Inputs of pose_inertial_solve as the tracker passes them."""
    import torch

    from tpuslam_torch.core.lie import so3_exp
    from tpuslam_torch.engine.inertial import preintegrate_window
    from tpuslam_torch.imu.preintegration import ImuCalib, information_from_cov, pre_to
    from tpuslam_torch.io.synthetic import SyntheticSequence

    rng = np.random.RandomState(seed)
    seq = SyntheticSequence(n_frames=2, fps=10, speed=0.5, imu_rate=200.0, kind="vi_excite")
    calib = ImuCalib(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5, freq=200.0)
    t0, t1 = 2.0, 2.1
    ts, ws, accs = seq.imu_between(t0 - 0.05, t1)
    pre, _ = preintegrate_window(np.column_stack([ts, ws, accs]), t0, t1, np.zeros(3),
                                 np.zeros(3), calib, device)
    R1, p1 = calib.body_from_cam(*seq.traj.pose_cw(t0))
    R2, p2 = calib.body_from_cam(*seq.traj.pose_cw(t1))
    v1, v2 = seq.traj.vel(t0), seq.traj.vel(t1)
    # points ahead of the frame, observed with noise and some gross outliers
    Rcw, tcw = seq.traj.pose_cw(t1)
    fx = fy = 458.0
    cx, cy = 376.0, 240.0
    Xc = np.column_stack([rng.uniform(-3, 3, rows), rng.uniform(-2, 2, rows),
                          rng.uniform(2, 8, rows)])
    X = (Xc - tcw) @ Rcw
    uv = np.column_stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy])
    uv += rng.randn(rows, 2) * 0.5
    bad = rng.rand(rows) < 0.1
    uv[bad] += rng.uniform(20, 60, (int(bad.sum()), 2))
    R2s = R2 @ so3_exp(torch.as_tensor(rng.randn(3) * np.radians(0.5) / np.sqrt(3))).numpy()
    p2s = p2 + rng.randn(3) * 0.02 / np.sqrt(3)
    _, _, wg2, wa2 = calib.discrete_cov()
    dT = float(pre["dT"])

    def up(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    info9 = information_from_cov(torch.as_tensor(pre["C"][:9, :9], dtype=torch.float64,
                                                 device=device)).to(dtype)
    z3 = np.zeros(3)
    args = (up(R1), up(p1), up(v1), up(z3), up(z3), up(R2s), up(p2s), up(v2), up(z3), up(z3),
            up(X), up(np.column_stack([uv, np.zeros(rows)])), up(np.ones(rows)),
            torch.zeros(rows, dtype=torch.bool, device=device),
            torch.ones(rows, dtype=torch.bool, device=device), pre_to(pre, device, dtype),
            info9, up(z3), up(z3), 1.0 / (wg2 * dT), 1.0 / (wa2 * dT), up(np.zeros((15, 15))),
            up(R1), up(p1), up(v1), up(z3), up(z3), True, up(calib.Rcb), up(calib.tcb),
            fx, fy, cx, cy, 0.0)
    return args


def count_ops(solve_args):
    """Aten operations of one solve, in all and by part."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpuslam_torch.solve import pose_inertial as PI

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    parts = collections.Counter()
    names = {"edge_residual_and_jacobians": "inertial edge: residual + jacfwd",
             "_edge_residual_of_eps": "inertial edge: residual in the cost",
             "_prior_residual_of_eps": "prior: residual + jacfwd",
             "_visual_parts": "visual rows", "spd_solve": "30-dim damped solve"}
    saved = {name: getattr(PI, name) for name in names}

    def counted(name, fn):
        def run(*a, **k):
            with Count() as c:
                out = fn(*a, **k)
            parts[names[name]] += c.n
            return out
        return run

    try:
        for name, fn in saved.items():
            setattr(PI, name, counted(name, fn))
        with Count() as total:
            PI.pose_inertial_solve(*solve_args)
    finally:
        for name, fn in saved.items():
            setattr(PI, name, fn)
    return total.n, dict(parts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from tpuslam_torch.solve.pose_inertial import pose_inertial_solve
    from tpuslam_torch.utils import resolve_device

    dev = resolve_device(args.device)
    solve_args = make_problem(args.rows, dev, torch.float32)
    out = pose_inertial_solve(*solve_args)            # warm-up
    n_ops, parts = count_ops(solve_args)
    res = {"rows": args.rows, "inliers": int(out[7]), "aten_ops_per_solve": n_ops,
           "aten_ops_by_part": parts}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        import chip_smoke as cs

        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose_inertial_solve(*solve_args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pose_inertial_solve(*solve_args)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        res.update(card=cs.nvidia_smi_line(), wall_ms_median=float(np.median(walls)),
                   wall_ms=walls, wall_ms_profiled=prof_wall, device_busy_ms=busy,
                   device_idle_share=max(0.0, 1.0 - busy / prof_wall),
                   device_events=len(events))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
