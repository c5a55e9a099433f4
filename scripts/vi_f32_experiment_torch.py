"""The PyTorch port's long f32 visual-inertial run (the counterpart of
scripts/vi_f32_experiment.py).

Drives mono-inertial SLAM (or, with --stereo, stereo-inertial) at deployed
precision, every visual-inertial solver in f32 as on the card, over a long
rendered sequence: 220 frames (22 s) at 10 fps and 0.3 m/s, IMU at 200 Hz,
376x240, fx = 200, 600 features, a keyframe at least every 3 frames. At the
default InertialConfig the run crosses the inertial mapper's whole
schedule: the IMU init, the periodic scale refinements, VIBA1 5 s after the
init, VIBA2 15 s after it, and the local inertial BAs with zero bias priors
after VIBA2.

It prints tpuslam's lines in tpuslam's formats (the scaled ATE every 20
frames, FINAL, ATE, RESULT under tpuslam's rule: scaled ATE < 0.15, state
OK, trajectory rows > 0.9 x frames), and before FINAL its own: the mapper's
IMU events, the number of scale refinements, the frame of the IMU init, the
largest |R^T R - I| over the keyframe rotations, the median and max ms of the
visual-inertial stages, the kernels' launches per frame and, on a card, its
nvidia-smi name and power limit.

--stereo departs from tpuslam's script. tpuslam builds its IMU_STEREO
System on vi_excite, whose std |a| (0.0114 m/s^2) never reaches the
stereo-inertial init gate (0.25 m/s^2), so its --stereo run never starts
tracking and yields no trajectory. Here --stereo takes the heave trajectory of
tests/torch_vi_heave.py (vi_excite plus z += 0.10 sin 4t) with the same
arguments, which passes the gate; over the 22 s at 0.3 m/s the heaving
camera stays inside the 10 x 6 x 4 m room.

    python scripts/vi_f32_experiment_torch.py [--frames 220] [--stereo] [--device cuda|cpu]

run(frames, stereo, device, inertial=, log=) is the same run for a caller;
chip_smoke.py's phase 15 and the tests pass InertialConfig(**SHORT_SCHEDULE).
It returns the final numbers, the events and the per-frame records.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("pose_inertial", "track_fused_vi", "track", "imu_stage", "local_inertial_ba")
# the schedule shortened so that a run of ~50 frames crosses all of it (the
# init, a scale refinement, VIBA1, VIBA2 and zero-prior local inertial BAs):
# InertialConfig(**SHORT_SCHEDULE), for chip_smoke.py's phase 15 and the CPU
# tests; every other field keeps its default
SHORT_SCHEDULE = dict(viba1_time=0.5, viba2_time=1.0)


def sequence(frames, stereo):
    """The run's sequence: tpuslam's vi_excite (mono), or the heave
    trajectory with the same arguments (stereo)."""
    from tpuslam_torch.io.synthetic import SyntheticSequence

    kw = dict(n_frames=frames, fps=10, speed=0.3, imu_rate=200.0, kind="vi_excite",
              baseline=0.1 if stereo else 0.0)
    if not stereo:
        return SyntheticSequence(**kw)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_vi_heave import heave_sequence

    return heave_sequence(**kw)


def orthonormality_error(slam_map):
    """max |R^T R - I| (max abs) over the valid keyframes' rotations."""
    return max((float(np.abs(slam_map.kf_R[k].T @ slam_map.kf_R[k] - np.eye(3)).max())
                for k in slam_map.valid_kf_ids()), default=0.0)


def _count_schedule(mapper):
    """Wrap the mapper to count its scale refinements (the IMU stage's
    branch that moves _last_refine) and its local inertial BAs with zero
    bias priors (those after VIBA2); returns the counts, a dict."""
    stage, local_ba = mapper._imu_stage, mapper._local_inertial_ba
    n = dict(refinements=0, zero_prior_local_ba=0)

    def counted_stage(kf):
        before = mapper._last_refine
        stage(kf)
        n["refinements"] += mapper._last_refine != before

    def counted_local_ba(kf, **kw):
        n["zero_prior_local_ba"] += bool(mapper.map.inertial_ba2)
        local_ba(kf, **kw)

    mapper._imu_stage, mapper._local_inertial_ba = counted_stage, counted_local_ba
    return n


def run(frames, stereo=False, device="cuda", inertial=None, log=print):
    """The experiment over `frames` frames; inertial: an InertialConfig
    (default: the reference's schedule). Returns a dict of the final
    numbers, the mapper's events, the per-frame records and the System."""
    import torch

    from tpuslam_torch.utils.probes import gt_centers, nvidia_smi_line, vi_counts
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import (InertialConfig, OrbConfig, SlamConfig,
                                             TrackingConfig)
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.utils import resolve_device
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    device = resolve_device(device)
    seq = sequence(frames, stereo)
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    cfg = SlamConfig(orb=OrbConfig(n_features=600),
                     tracking=TrackingConfig(max_frames_between_kf=3,
                                             min_stereo_init_features=200),
                     inertial=inertial or InertialConfig())
    calib = ImuCalib(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5,
                     freq=seq.imu_rate)
    sensor = Sensor.IMU_STEREO if stereo else Sensor.IMU_MONOCULAR
    slam = System(cam, cfg, sensor=sensor, imu_calib=calib,
                  bf=seq.fx * seq.baseline if stereo else 0.0, device=device)
    # deployed precision: the visual-inertial solvers run in f32 (tpuslam's
    # script asserts jax_enable_x64 off)
    assert slam.tracker.dtype == slam.local_mapper.dtype == torch.float32
    schedule = _count_schedule(slam.local_mapper)
    GLOBAL_TIMER.samples.clear()
    times = seq.timestamps()
    rows = []
    t0 = time.perf_counter()
    for i in range(seq.n_frames):
        if i == 0:
            imu = None
        else:
            ts, ws, accs = seq.imu_between(times[i - 1], times[i])
            imu = np.column_stack([ts, ws, accs])
        before, initialized = vi_counts(), slam.map.imu_initialized
        if stereo:
            slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i], imu=imu)
        else:
            slam.track_monocular(seq.frame(i), times[i], imu=imu)
        rows.append(dict(initialized=initialized,
                         **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host"),
                                    (a - b for a, b in zip(vi_counts(), before))))))
        if i % 20 == 19:
            traj = slam.trajectory_tum()
            if len(traj) >= 10:
                est = np.array([[r[1], r[2], r[3]] for r in traj])
                rmse, scale = ate_rmse(est, gt_centers(seq, traj), with_scale=True)
                log(f"frame {i + 1:4d} t={times[i]:6.2f}s "
                    f"state={slam.get_tracking_state().name:14s} "
                    f"ate={rmse:8.4f} scale={scale:6.3f} "
                    f"kfs={len(slam.map.valid_kf_ids())}")
    dt = time.perf_counter() - t0
    slam.shutdown()
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([[r[1], r[2], r[3]] for r in traj]).reshape(-1, 3)
    gt = gt_centers(seq, traj).reshape(-1, 3)
    rmse, scale = ate_rmse(est, gt, with_scale=True) if len(traj) >= 3 else (np.inf, np.nan)
    rmse_u = ate_rmse(est, gt, with_scale=False)[0] if len(traj) >= 3 else np.inf
    state = slam.get_tracking_state()
    n_kfs = len(m.valid_kf_ids())

    events = [dict(e, frame=int(round(e["t"] * seq.fps))) for e in slam.local_mapper.debug_events]
    init_frame = next((i for i, r in enumerate(rows[1:], 1) if r["initialized"]), 0) - 1
    orth = orthonormality_error(m)
    stage_ms = {s: (float(np.median(GLOBAL_TIMER.samples[s]) * 1e3),
                    float(np.max(GLOBAL_TIMER.samples[s]) * 1e3), len(GLOBAL_TIMER.samples[s]))
                for s in STAGES if GLOBAL_TIMER.samples.get(s)}
    fused = [r for r in rows if r["fused_vi"] and not r["host"]]
    launches = {k: sum(r[k] for r in rows) for k in ("patch", "pose", "vi_solves")}
    for e in events:
        log(f"imu event {e['event']:8s} t={e['t']:6.2f}s frame={e['frame']:4d} "
            f"kfs={e['n_kfs']}")
    log(f"scale refinements {schedule['refinements']}; local inertial BAs with zero priors "
        f"{schedule['zero_prior_local_ba']}; IMU initialized after frame {init_frame}")
    log(f"max |R^T R - I| over {n_kfs} keyframes {orth:.3e}")
    for s, (med, mx, n) in stage_ms.items():
        log(f"stage {s:18s} n={n:4d} median {med:10.1f} ms  max {mx:10.1f} ms")
    log(f"launches per frame: patch gather {launches['patch'] / seq.n_frames:.3f}, pose LM "
        f"{launches['pose'] / seq.n_frames:.3f}; on {len(fused)} fused VI frames: patch gather "
        f"{sorted({r['patch'] for r in fused})}, pose LM {sorted({r['pose'] for r in fused})}, "
        f"pose_inertial_solve {sorted({r['vi_solves'] for r in fused})}")
    if device.type == "cuda":
        log(f"card {nvidia_smi_line()}")
    log(f"\nFINAL: {seq.n_frames} frames in {dt:.1f}s "
        f"({seq.n_frames / dt:.1f} fps) state={state.name}")
    log(f"ATE scaled={rmse:.4f} (scale {scale:.3f})  unscaled={rmse_u:.4f} "
        f"kfs={n_kfs} traj_rows={len(traj)}")
    ok = bool(rmse < 0.15 and str(state).endswith("OK") and len(traj) > 0.9 * seq.n_frames)
    log("RESULT: " + ("PASS" if ok else "FAIL"))
    return dict(ok=ok, state=state.name, rmse=float(rmse), scale=float(scale),
                rmse_unscaled=float(rmse_u), n_kfs=n_kfs, traj=traj, est=est, gt=gt,
                events=events, init_frame=init_frame, **schedule,
                orthonormality=orth, stage_ms=stage_ms, rows=rows, launches=launches,
                seconds=dt, seq=seq, slam=slam)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=220)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) "
                                                    "or 'cpu'")
    args = p.parse_args(argv)
    res = run(args.frames, stereo=args.stereo, device=args.device,
              log=lambda s: print(s, flush=True))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
