"""Two mono-inertial sessions over one place, for the tests of the
mono-inertial Atlas merge (tests/test_torch_mono_vi_merge*.py) and
chip_smoke.py's phase 17. Imports only the port and numpy (chip_smoke.py
imports it from tests/).

The place is tests/torch_vi_merge.py's `loop_sessions` seen by the left
camera only: the heave on the `loop` trajectory at 1 m/s (a 1.6 m circle, a
lap every ~10 s), IMU at 200 Hz, 10 fps, a keyframe at least every 3
frames, the IMU init after 6 keyframes over 1 s (FAST_INIT) and
SHORT_SCHEDULE's VIBA1 / VIBA2 0.5 / 1.0 s after it. Session A is t = 0-2.5
s of the circle: its two-view init, IMU init, VIBA1 and VIBA2. Session B
starts 8.8 s into the lap, stamped from 100 s, and comes round to A's arc
just after its own IMU init: it is recognised against A after its two-view
init and its IMU init, before its VIBA1 and VIBA2. Each map's scale is its
own: a mono map is metric only after its IMU init, and the merge of two
inertial maps is a Sim3 of scale 1 (`fix_scale`). chip_smoke.py's phase 17
runs A over 41 frames and B from frame 90 at 752x480 (fx = 458): there A's
two-view init comes on its frame 16, not 5, and B is recognised after its
VIBA1, before its VIBA2.

`drive` feeds both sessions through `System.track_monocular(..., imu=)`
with `change_dataset()` between them and records what the tests read;
`mono_gates` scores a run on one alignment of all its rows to both
sessions' ground truth (PERF.md §2's mono-inertial gates), and
`session_scales` aligns each map's keyframes alone.
"""

import numpy as np

from tpuslam_torch.eval.ate import associate, horn_align

import torch_vi_merge as vm

# A's first frame in the sequence and its frames, B's first frame and its frames
START_A, N_A, START_B, N_B = 0, 26, 88, 22
FX_376 = 200.0                   # fx = fy at 376x240
FEATURES = vm.FEATURES           # at 376x240; chip_smoke.py runs 1024 at 752x480
MAX_KF_FRAMES = 3
INERTIAL = dict(vm.SHORT_SCHEDULE, **vm.FAST_INIT)
# PERF.md §2's mono-inertial gates, and how close the two sessions' Horn
# scales (each aligned alone) must come
GATES = dict(ate=0.06, scale=0.4, r22=0.99, vel=0.2, agree=0.05)


def sessions(n_a=N_A, start_b=START_B, n_b=N_B, start_a=START_A, **kw):
    """(sequence, [A, B]); kw: SyntheticSequence's size and camera (376x240,
    FX_376 by default)."""
    kw.setdefault("fx", FX_376 * kw.get("width", 376) / 376.0)
    kw.setdefault("fy", kw["fx"])
    seq, _ = vm.loop_sessions(n_a, start_b, n_b, **kw)
    view = vm.synth_script().SessionView
    return seq, [view(seq, start_a, n_a, 0.0), view(seq, start_b, n_b, vm.T0_SECOND)]


def config(n_features=FEATURES):
    """The port's SlamConfig of the route (synchronous GBA)."""
    from tpuslam_torch.engine.config import (InertialConfig, LoopConfig, OrbConfig, SlamConfig,
                                             TrackingConfig)

    return SlamConfig(orb=OrbConfig(n_features=n_features),
                      tracking=TrackingConfig(max_frames_between_kf=MAX_KF_FRAMES),
                      loop=LoopConfig(background_gba=False),
                      inertial=InertialConfig(**INERTIAL))


def port_system(seq, voc=None, device="cpu", cfg=None, **kw):
    """The port's IMU_MONOCULAR System on the route's configuration."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.imu.preintegration import ImuCalib

    return System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  cfg or config(), sensor=Sensor.IMU_MONOCULAR,
                  imu_calib=ImuCalib(**dict(vm.NOISE, freq=seq.imu_rate)), vocab=voc,
                  device=device, dtype=kw.pop("dtype", torch.float32), **kw)


def kf_centres(m, kfs):
    return np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])


def gt_centre(sessions, t):
    sess = sessions[1] if t >= sessions[1].t0 - 1e-9 else sessions[0]
    R, tt = sess.gt_pose_cw(t)
    return -R.T @ tt


def session_scales(m, sessions):
    """Each Atlas map's Horn scale (its keyframe centres aligned alone, with
    scale, to the ground truth): {map id: (scale, keyframes)}. Taken just
    before a merge's correction, it measures the two maps' metric scales."""
    out = {}
    for mid in m.map_ids():
        kfs = [int(k) for k in m.valid_kf_ids(map_id=mid)]
        if len(kfs) < 3:
            continue
        gt = np.stack([gt_centre(sessions, float(m.kf_time[k])) for k in kfs])
        out[mid] = (float(horn_align(kf_centres(m, kfs), gt, with_scale=True)[2]), len(kfs))
    return out


def drive(slam, sessions, frames=None, stop_after_merge=False, init_module=None):
    """Feed session A, change_dataset(), then B, each frame with its IMU
    samples (the port's System or tpuslam's). frames: the sequence's images
    (rendered here where None). Returns a record: rows (session, frame,
    time, Tcw or None, state name, map ids, keyframes over all maps, IMU
    initialized); merges [(frame over both sessions, kf, cand, Sim3 scale,
    the store's IMU flags and the mapper's stage at the correction, each
    map's Horn scale just before it)]; the IMU events [(event, frame, the
    last keyframe's gyro and accelerometer biases)]; the scale refinements
    [(frame, chain, the chain's first and last stamps)]; the merges
    aborted. init_module: the module whose run_imu_init the mapper calls
    (the port's engine.local_mapping by default; tpuslam's engine.inertial).
    The loop closer stays wrapped."""
    if init_module is None:
        from tpuslam_torch.engine import local_mapping as init_module

    lc, lm, m = slam.loop_closer, slam.local_mapper, slam.map
    rec = dict(rows=[], merges=[], refinements=[])
    if lc is not None:
        real = lc._correct_loop

        def correct(kf, cand, s, *a, merge=False, **kw):
            if merge:
                rec["merges"].append((len(rec["rows"]), int(kf), int(cand), float(s),
                                      (m.imu_initialized, m.inertial_ba1, m.inertial_ba2),
                                      lm.viba_stage, session_scales(m, sessions)))
            return real(kf, cand, s, *a, merge=merge, **kw)

        lc._correct_loop = correct
    real_init = init_module.run_imu_init

    def run_imu_init(mm, *a, **kw):
        if not kw.get("opt_bias", True):
            chain = [int(k) for k in mm.temporal_chain()]
            rec["refinements"].append((len(rec["rows"]), chain, float(mm.kf_time[chain[0]]),
                                       float(mm.kf_time[chain[-1]])))
        return real_init(mm, *a, **kw)

    init_module.run_imu_init = run_imu_init
    try:
        for s_i, sess in enumerate(sessions):
            if s_i:
                slam.change_dataset()
            for i, t in enumerate(sess.timestamps()):
                img = sess.frame(i) if frames is None else frames[sess.start + i]
                Tcw = slam.track_monocular(img, float(t), imu=vm.session_imu(sess, i))
                rec["rows"].append((s_i, i, float(t), None if Tcw is None else np.asarray(Tcw),
                                    slam.get_tracking_state().name, m.map_ids(),
                                    len(m.valid_kf_ids(all_maps=True)), bool(m.imu_initialized)))
                if stop_after_merge and rec["merges"]:
                    break
            if stop_after_merge and rec["merges"]:
                break
    finally:
        init_module.run_imu_init = real_init
    if not (stop_after_merge and rec["merges"]):
        slam.shutdown()
    fps, n_a = sessions[0].fps, sessions[0].n_frames
    rec["events"] = [(e["event"], int(round((e["t"] - sessions[1].t0) * fps)) + n_a
                      if e["t"] >= sessions[1].t0 - 1e-9 else int(round(e["t"] * fps)),
                      np.asarray(e["bg"], np.float64), np.asarray(e["ba"], np.float64))
                     for e in lm.debug_events]
    rec["aborted"] = list(getattr(lc, "merges_aborted", []))
    return rec


def mono_gates(m, traj, sessions):
    """The merged run's numbers on one scaled alignment of every trajectory
    row (t, x, y, z, ...) to the ground truth of both sessions: the scaled
    ATE (m), the Horn scale, |R[2, 2]|, the median keyframe-velocity error
    (m/s, s R v against the ground truth) and whether every keyframe pose,
    velocity and bias is finite; each session's rows aligned alone give its
    Horn scale. ok: all of PERF.md §2's mono-inertial gates and the two
    sessions' scales within GATES["agree"] of each other."""
    traj = np.asarray(traj, np.float64)
    t_gt = np.concatenate([s.timestamps() for s in sessions])
    i_e, _ = associate(traj[:, 0], t_gt)
    est = traj[:, 1:4]
    gt = np.stack([gt_centre(sessions, t) for t in traj[:, 0]])
    R, _, s, res = horn_align(est, gt, with_scale=True)
    kfs = m.valid_kf_ids(all_maps=True)
    vel = []
    for k in kfs:
        sess = sessions[1] if m.kf_time[k] >= sessions[1].t0 - 1e-9 else sessions[0]
        v_gt = sess.seq.traj.vel(sess._source_time(float(m.kf_time[k])))
        vel.append(np.linalg.norm(s * R @ m.kf_vel[k] - v_gt))
    finite = bool(all(np.isfinite(a[kfs]).all()
                      for a in (m.kf_R, m.kf_t, m.kf_vel, m.kf_bg, m.kf_ba)))
    scales = []
    for sess in sessions:
        sel = (traj[:, 0] >= sess.t0 - 1e-9) & (traj[:, 0] < sess.t0 + sess.n_frames / sess.fps)
        scales.append(float(horn_align(est[sel], gt[sel], with_scale=True)[2]))
    out = dict(rows=len(traj), matched=len(i_e), ate=float(np.sqrt(np.mean(res ** 2))),
               scale=float(s), r22=float(abs(R[2, 2])), vel=float(np.median(vel)),
               finite=finite, scales=scales, agree=float(abs(scales[1] / scales[0] - 1.0)))
    out["ok"] = bool(out["matched"] == len(traj) and out["ate"] < GATES["ate"]
                     and abs(out["scale"] - 1.0) < GATES["scale"] and out["r22"] > GATES["r22"]
                     and out["vel"] < GATES["vel"] and finite and out["agree"] < GATES["agree"])
    return out
