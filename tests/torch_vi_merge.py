"""Two stereo-inertial sessions over one place, for the multi-session
merge's tests and chip_smoke.py's phase 16. It imports only the port and
numpy (chip_smoke.py imports it from tests/).

Two layouts, each a pair of `SessionView`s of one rendered heave sequence
(tests/torch_vi_heave.py; scripts/make_synth_euroc_torch.py's views: a
stretch of the sequence stamped from its own t0, ground truth and IMU in
the sequence's world frame), as EuRoC's MH01 -> MH02:

  * `heave_sessions`: the heave on `vi_excite` at 0.5 m/s. Session A is
    frames 0 .. n_a - 1; B is frames start_b onward, stamped 100 s later,
    so B opens its map at a pose A passed through and sees A's places from
    its first frames, before its own IMU init (the merge "before the young
    map's IMU init").
  * `loop_sessions`: the heave on the `loop` trajectory at 1 m/s (a 1.6 m
    circle, a lap every ~10 s). Session A is t = 0-3.2 s; C starts on the
    far side of the circle at t = 4.5 s, stamped 100 s later, and comes
    round to A's arc only after its own IMU init and VIBA1 under
    SHORT_SCHEDULE (the merge "after the young map's IMU init").

`joint_gates` scores a run on one alignment of all its rows to both
sessions' ground truth (PERF.md §2's stereo-inertial gates).
"""

import importlib.util
import os

import numpy as np

from tpuslam_torch.eval.ate import associate, horn_align
from torch_vi_heave import heave_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOISE = dict(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5, freq=200.0)
FEATURES = 600              # at 376x240; chip_smoke.py runs 1024 at 752x480
# scripts/vi_f32_experiment_torch.py's SHORT_SCHEDULE: VIBA1 / VIBA2 0.5 /
# 1.0 s after the IMU init (the reference's 5 / 15 s)
SHORT_SCHEDULE = dict(viba1_time=0.5, viba2_time=1.0)
T0_SECOND = 100.0           # the second session's first stamp
# the CPU tests' IMU init after 6 keyframes over 1 s (InertialConfig's
# init_min_kfs / init_min_span; the defaults, 10 over 2 s, would double the
# frames both sessions need at a keyframe every 3 frames)
FAST_INIT = dict(init_min_kfs=6, init_min_span=1.0)
# heave_sessions: A's frames (with FAST_INIT its IMU init falls on frame 15
# at 376x240), B's first frame in the sequence and B's length
HEAVE_A, HEAVE_START_B, HEAVE_B = 16, 6, 11
# loop_sessions: A's frames, C's first frame in the sequence and C's length
LOOP_A, LOOP_START_C, LOOP_C = 33, 45, 70
VOCAB_FRAMES = 8            # frames of the sequence the vocabulary is trained on
GATES = dict(ate=0.05, scale=0.03, r22=0.99, vel=0.2)   # PERF.md §2


def synth_script():
    """scripts/make_synth_euroc_torch.py as a module (SessionView,
    write_euroc)."""
    spec = importlib.util.spec_from_file_location(
        "make_synth_euroc_torch", os.path.join(ROOT, "scripts", "make_synth_euroc_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def heave_sessions(n_a=HEAVE_A, start_b=HEAVE_START_B, n_b=HEAVE_B, **kw):
    """(sequence, [A, B]) of the vi_excite heave; kw: SyntheticSequence's
    size and camera (376x240 by default)."""
    seq = heave_sequence(n_frames=max(n_a, start_b + n_b), fps=10, speed=0.5,
                         imu_rate=200.0, baseline=0.1, **kw)
    view = synth_script().SessionView
    return seq, [view(seq, 0, n_a, 0.0), view(seq, start_b, n_b, T0_SECOND)]


def loop_sessions(n_a=LOOP_A, start_c=LOOP_START_C, n_c=LOOP_C, **kw):
    """(sequence, [A, C]) of the loop heave."""
    seq = heave_sequence(n_frames=start_c + n_c, fps=10, speed=1.0, imu_rate=200.0,
                         baseline=0.1, kind="loop", **kw)
    view = synth_script().SessionView
    return seq, [view(seq, 0, n_a, 0.0), view(seq, start_c, n_c, T0_SECOND)]


def session_imu(sess, i):
    """The [N, 7] IMU samples between frames i - 1 and i of a session (None
    for its first frame: each session starts its IMU stream anew)."""
    if i == 0:
        return None
    ts = sess.timestamps()
    return np.column_stack(sess.imu_between(ts[i - 1], ts[i]))


def vocabulary(seq, n_features=FEATURES, device="cpu", frames=None):
    """A vocabulary trained with the port's train_vocabulary on ORB
    descriptors of VOCAB_FRAMES frames spread over the sequence (or of the
    given uint8 frames)."""
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig
    from tpuslam_torch.engine.frontend import Frontend
    from tpuslam_torch.place import train_vocabulary

    fe = Frontend(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  OrbConfig(n_features=n_features), device=device)
    if frames is None:
        step = max(1, seq.n_frames // VOCAB_FRAMES)
        frames = [seq.frame(i) for i in range(0, seq.n_frames, step)][:VOCAB_FRAMES]
    bits = []
    for img in frames:
        f = fe.process(img)
        bits.append(np.asarray(f.bits)[np.asarray(f.valid)])
    return train_vocabulary(np.concatenate(bits), k=8, L=3, iters=5, device=device)


def vocabulary_text(seq, path, n_features=FEATURES):
    """vocabulary() written in the reference's text format (both packages
    load it); returns the path."""
    from tpuslam_torch.place import save_orbvoc_text

    save_orbvoc_text(vocabulary(seq, n_features), path)
    return path


def _session_of(sessions, t):
    for sess in reversed(sessions):
        if t >= sess.t0 - 1e-9:
            return sess
    return sessions[0]


def row_errors(traj, sessions):
    """Each trajectory row's error (m) on joint_gates' unscaled alignment of
    all rows to both sessions' ground truth: (the rows' stamps, errors)."""
    traj = np.asarray(traj, np.float64)
    t_gt = np.concatenate([s.timestamps() for s in sessions])
    gt = np.asarray([-R.T @ t for R, t in (s.gt_pose_cw(x) for s in sessions
                                           for x in s.timestamps())])
    i_e, i_g = associate(traj[:, 0], t_gt)
    return traj[i_e, 0], horn_align(traj[i_e, 1:4], gt[i_g], with_scale=False)[3]


def joint_gates(m, traj, sessions):
    """The merged run's numbers on one alignment of every trajectory row
    (t, x, y, z, ...) to the ground truth of both sessions: unscaled ATE
    (m), the Horn scale and rotation's R[2, 2] of the scaled alignment, the
    median keyframe-velocity error (m/s) and whether every keyframe pose,
    velocity and bias of map m is finite. ok: all of PERF.md §2's gates."""
    traj = np.asarray(traj, np.float64)
    t_gt = np.concatenate([s.timestamps() for s in sessions])
    gt = []
    for s in sessions:
        for t in s.timestamps():
            Rcw, tcw = s.gt_pose_cw(t)
            gt.append(-Rcw.T @ tcw)
    i_e, i_g = associate(traj[:, 0], t_gt)
    est, gt = traj[i_e, 1:4], np.asarray(gt)[i_g]
    _, _, _, res = horn_align(est, gt, with_scale=False)
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    kfs = m.valid_kf_ids(all_maps=True)
    vel = []
    for k in kfs:
        sess = _session_of(sessions, float(m.kf_time[k]))
        v_gt = sess.seq.traj.vel(sess._source_time(float(m.kf_time[k])))
        vel.append(np.linalg.norm(s * R @ m.kf_vel[k] - v_gt))
    finite = bool(all(np.isfinite(a[kfs]).all()
                      for a in (m.kf_R, m.kf_t, m.kf_vel, m.kf_bg, m.kf_ba)))
    out = dict(rows=len(traj), matched=len(i_e), ate=float(np.sqrt(np.mean(res ** 2))),
               scale=float(s), r22=float(abs(R[2, 2])), vel=float(np.median(vel)),
               finite=finite)
    out["ok"] = bool(out["matched"] == len(traj) and out["ate"] < GATES["ate"]
                     and abs(out["scale"] - 1.0) < GATES["scale"] and out["r22"] > GATES["r22"]
                     and out["vel"] < GATES["vel"] and finite)
    return out
