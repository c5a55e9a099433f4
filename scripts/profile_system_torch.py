"""Profile the PyTorch port's System.track_stereo stage by stage (the
counterpart of scripts/profile_system.py).

Drives System.track_stereo over a rendered stereo sequence (376x240,
fx = fy = 200, baseline 0.1 m, 20 fps, 0.5 m/s; rendered before the timed
loop, as a camera would deliver them) and prints, per run: the frames/s of
the whole loop, the median and p90 frame, the steady-state frames/s (the
first 5 frames left out), the per-stage table of utils/timing.GLOBAL_TIMER
(the reference's SAVE_TIMES, src/Tracking.cc:311-315,406-414), the map's
size and the unscaled ATE against the renderer's ground truth.

    python scripts/profile_system_torch.py [--frames 60] [--features 1024] [--repeat 1]
        [--async-mapping] [--pipelined] [--no-fused] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--features", type=int, default=1024)
    p.add_argument("--repeat", type=int, default=1,
                   help="run the tracking loop this many times, each with a new System")
    p.add_argument("--async-mapping", action="store_true",
                   help="run local mapping on the worker thread (the bench's configuration)")
    p.add_argument("--pipelined", action="store_true",
                   help="run the 1-frame pipelined fused step (the bench's configuration)")
    p.add_argument("--no-fused", action="store_true",
                   help="track every frame on the host path, not the fused step")
    p.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) "
                                                    "or 'cpu'")
    args = p.parse_args(argv)

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.utils import resolve_device
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    device = resolve_device(args.device)
    seq = SyntheticSequence(n_frames=args.frames, fps=20, speed=0.5, baseline=0.1)
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    cfg = SlamConfig(orb=OrbConfig(n_features=args.features),
                     tracking=TrackingConfig(min_stereo_init_features=200,
                                             pipelined=args.pipelined))
    bf = seq.fx * seq.baseline
    times = seq.timestamps()
    print("rendering frames...", flush=True)
    frames = [(seq.frame(i), seq.frame(i, right=True)) for i in range(seq.n_frames)]

    for rep in range(args.repeat):
        slam = System(cam, cfg, sensor=Sensor.STEREO, bf=bf, async_mapping=args.async_mapping,
                      device=device)
        if args.no_fused:
            slam.tracker.fused_enabled = False
        GLOBAL_TIMER.samples.clear()
        t0 = time.perf_counter()
        per_frame = []
        for i in range(seq.n_frames):
            f0 = time.perf_counter()
            slam.track_stereo(frames[i][0], frames[i][1], times[i])
            per_frame.append(time.perf_counter() - f0)
        if args.pipelined:
            slam.tracker._flush_pipeline()
        dt = time.perf_counter() - t0
        if args.async_mapping:
            slam.async_mapper.flush(raise_errors=True)
        n = seq.n_frames
        pf = np.array(per_frame)
        print(f"\n=== run {rep} on {device}: {n} frames in {dt:.2f}s = {n / dt:.1f} fps "
              f"(median {np.median(pf) * 1e3:.1f} ms, p90 {np.percentile(pf, 90) * 1e3:.1f} ms)")
        ss = pf[5:]
        print(f"    steady-state: {1.0 / np.mean(ss):.1f} fps (mean {np.mean(ss) * 1e3:.1f} ms)")
        print(GLOBAL_TIMER.report())
        print(f"state={slam.get_tracking_state()}, kfs={len(slam.map.valid_kf_ids())}, "
              f"mps={int(slam.map.mp_valid[:slam.map.n_mp].sum())}")
        traj = slam.trajectory_tum()
        if traj:
            est = np.array([r[1:4] for r in traj])
            gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
            rmse, _ = ate_rmse(est, gt, with_scale=False)
            print(f"ATE (unscaled) = {rmse:.4f} m over {len(traj)} frames")
        slam.shutdown()


if __name__ == "__main__":
    main()
