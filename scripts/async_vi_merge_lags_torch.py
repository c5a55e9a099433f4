"""The async stereo-inertial merge (chip_smoke.py phase 16 b async's route) on
the CPU under tests/torch_async.lagged at several lags: where the merge's
correction lands, the joint ATE and which rows carry it.

    python scripts/async_vi_merge_lags_torch.py [--lags 1,2,3,4,5,6]
        [--young-stage]

(from the repo root; each lag runs in a process of its own, one thread,
~5 min at 376x240.) tests/torch_vi_merge.py's loop_sessions (A 33 frames,
C 70 from 100 s, 600 features, the short schedule, f32) through an
IMU_STEREO System with async_mapping=True, a keyframe mapped `lag` frames
after the frame that made it. One JSON line per lag: the call whose worker
ran the merge's correction, the IMU events, the joint gates (unscaled ATE
on one alignment of both sessions' rows), the RMS of each part's rows (A; C
before the merge; C from the merge on) and the 8 largest row errors with
their frame. --young-stage: the merged map goes on with the young map's IMU
stage and flags, as tpuslam's store does (the port's merged map goes on
from the stage of the map further behind, map/store.py relabel_map).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(lag, young_stage):
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import numpy as np
    import torch

    import torch_vi_merge as vm
    from torch_async import lagged
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import (InertialConfig, LoopConfig, OrbConfig, SlamConfig,
                                             TrackingConfig)
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.imu.preintegration import ImuCalib

    torch.set_num_threads(1)
    seq, sessions = vm.loop_sessions()
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=vm.FEATURES),
                             tracking=TrackingConfig(max_frames_between_kf=3,
                                                     min_stereo_init_features=200),
                             loop=LoopConfig(background_gba=False),
                             inertial=InertialConfig(**vm.SHORT_SCHEDULE)),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**vm.NOISE),
                  bf=seq.fx * seq.baseline, vocab=vm.vocabulary(seq), async_mapping=True,
                  device="cpu")
    m, lc = slam.map, slam.loop_closer
    if young_stage:
        real_relabel = m.relabel_map

        def relabel(src, dst):
            m.map_imu.pop(dst, None)
            return real_relabel(src, dst)

        m.relabel_map = relabel
    lagged(slam, lag)
    calls, at_merge = [0], {}
    real_correct = lc._correct_loop

    def correct(kf, cand, *a, merge=False, **kw):
        if merge:
            at_merge.update(call=calls[0], kf=int(kf), cand=int(cand),
                            stage_old=m.imu_state_of(int(m.kf_map_id[cand]))["viba_stage"],
                            stage_young=m.viba_stage)
        return real_correct(kf, cand, *a, merge=merge, **kw)

    lc._correct_loop = correct
    for s, sess in enumerate(sessions):
        if s:
            slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            slam.track_stereo(sess.frame(i), sess.frame(i, right=True), float(t),
                              imu=vm.session_imu(sess, i))
            calls[0] += 1
    slam.async_mapper.flush(raise_errors=False)
    slam.shutdown()
    traj = np.asarray(slam.trajectory_tum())
    gates = vm.joint_gates(m, traj, sessions)
    t_rows, err = vm.row_errors(traj, sessions)
    n_a, fps = sessions[0].n_frames, seq.fps
    frame = np.array([int(round(t * fps)) if t < vm.T0_SECOND
                      else n_a + int(round((t - vm.T0_SECOND) * fps)) for t in t_rows])
    m0 = at_merge.get("call", len(frame))
    parts = {"A": frame < n_a, "C before the merge": (frame >= n_a) & (frame < m0),
             "C from the merge on": frame >= m0}
    return dict(lag=lag, young_stage=young_stage, merge=at_merge,
                events=[(e["event"], e["t"]) for e in slam.local_mapper.debug_events],
                errors=[repr(e) for e in slam.async_mapper.errors],
                gates=gates,
                rms_cm={k: round(float(np.sqrt(np.mean(err[sel] ** 2))) * 100, 3)
                        for k, sel in parts.items() if sel.any()},
                worst=[(int(frame[j]), round(float(err[j]) * 100, 3))
                       for j in np.argsort(-err)[:8]])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lags", default="1,2,3,4,5,6")
    ap.add_argument("--young-stage", action="store_true")
    ap.add_argument("--one", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run(args.one, args.young_stage)), flush=True)
        return 0
    extra = ["--young-stage"] if args.young_stage else []
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--one", lag] + extra,
                              stdout=subprocess.PIPE, text=True)
             for lag in args.lags.split(",")]
    code = 0
    for p in procs:
        out, _ = p.communicate()
        code = code or p.returncode
        print(out.strip().splitlines()[-1] if out.strip() else f"lag failed: {p.returncode}",
              flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
