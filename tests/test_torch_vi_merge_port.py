"""The port's stereo-inertial System merges the second session only after
the young map's IMU init, and the merged map passes the stereo-inertial
gates, on the CPU.

The sessions of tests/test_torch_vi_merge.py (tests/torch_vi_merge.py's
`heave_sessions`) with the default IMU init (10 keyframes over 2 s): A
frames 0-27 (its IMU init on frame 27), B frames 0-35 (seq frames 6-41),
the port alone (f64, synchronous GBA). B sees A's places from its first
frames; the merge confirmed on B's sixth frame is aborted (B's IMU is not
initialized), and so is every merge confirmed before B's IMU init (its
10th keyframe, 2.7 s into B). The next merge confirmed after the init is
made, on B's frame 33, and it takes the inertial route: the merge's world
correction projected onto a rotation about gravity, the 4-DoF essential
graph with A's keyframes fixed and the seam measured in one frame, the
visual-inertial weld BA over the last 10 keyframes of the merged chain
with the seam's old side fixed, and the FullInertialBA as the GBA.

Gates (PERF.md §2, stereo-inertial; tests/test_torch_atlas_merge.py's for
the merge): exactly one merge, inside B and after B's IMU init (maps 2 ->
1); OK on every frame; no keyframe, point observation or tracker keyframe
left in the young map; no IMU init over a chain holding both sessions; on
one alignment of all rows to both sessions' ground truth an unscaled ATE
under 5 cm, a Horn scale within 3 %, |R[2, 2]| > 0.99, a median keyframe
velocity error under 0.2 m/s, and finite keyframe poses, velocities and
biases.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import local_mapping, loop_closing
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.imu.preintegration import ImuCalib

from torch_vi_merge import FEATURES, NOISE, heave_sessions, joint_gates, session_imu, vocabulary

torch.set_num_threads(2)
N_A, N_B = 28, 36


def _world_tilt(R, Rkf, Rcand):
    """Radians by which the world correction of a merge whose Sim3 has
    rotation R (current camera <- candidate camera) tilts the vertical."""
    Rw = (R @ Rcand).T @ Rkf
    return float(np.arccos(np.clip((Rw @ [0.0, 0.0, 1.0])[2], -1.0, 1.0)))


@pytest.fixture(scope="module")
def run():
    seq, sessions = heave_sessions(n_a=N_A, n_b=N_B)
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=FEATURES),
                             tracking=TrackingConfig(max_frames_between_kf=3),
                             loop=LoopConfig(background_gba=False)),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE),
                  bf=seq.fx * seq.baseline, vocab=vocabulary(seq), dtype=torch.float64,
                  device="cpu")
    m, lc = slam.map, slam.loop_closer
    frame = [0]
    rec = dict(rows=[], merges=[], inits=[], graph=[], weld=[], gba=[])

    def wrap(name, fn, after):
        def call(*a, **kw):
            out = fn(*a, **kw)
            after(out, *a, **kw)
            return out
        return name, call

    real_correct, real_snap = lc._correct_loop, lc._snapshot_gba

    def correct(kf, cand, s, R, *a, merge=False, **kw):
        if merge:
            rec["merges"].append((frame[0], int(kf), int(cand), m.imu_initialized, s,
                                  _world_tilt(R, m.kf_R[kf], m.kf_R[cand])))
        return real_correct(kf, cand, s, R, *a, merge=merge, **kw)

    def snapshot(fix_kf):
        snap = real_snap(fix_kf)
        rec["gba"].append(None if snap is None else snap.get("kind"))
        return snap

    lc._correct_loop, lc._snapshot_gba = correct, snapshot
    patches = [
        wrap("optimize_essential_graph", loop_closing.optimize_essential_graph,
             lambda out, *a, **kw: rec["graph"].append((kw["four_dof"], list(kw["fix_kfs"])))),
        wrap("window_inertial_ba", loop_closing.window_inertial_ba,
             lambda out, *a, **kw: rec["weld"].append((list(kw["opt_kfs"]),
                                                       list(kw["fixed_kfs"])))),
    ]

    def init_probe(real):
        def run_imu_init(mm, *a, **kw):
            chain = [int(k) for k in mm.temporal_chain()]
            ok = real(mm, *a, **kw)
            rec["inits"].append((frame[0], chain, bool(ok)))
            return ok
        return run_imu_init

    with pytest.MonkeyPatch.context() as mp:
        for name, fn in patches:
            mp.setattr(loop_closing, name, fn)
        mp.setattr(local_mapping, "run_imu_init", init_probe(local_mapping.run_imu_init))
        for s, sess in enumerate(sessions):
            if s:
                slam.change_dataset()
            for i, t in enumerate(sess.timestamps()):
                slam.track_stereo(sess.frame(i), sess.frame(i, right=True), float(t),
                                  imu=session_imu(sess, i))
                rec["rows"].append((s, i, slam.get_tracking_state().name, m.map_ids(),
                                    m.imu_initialized, len(lc.merges_aborted)))
                frame[0] += 1
    slam.shutdown()
    return slam, sessions, rec


def test_the_merge_waits_for_the_young_maps_imu_init(run):
    slam, _, rec = run
    m, lc = slam.map, slam.loop_closer
    (f_merge, kf, cand, inertial, _, _), = rec["merges"]
    # B's IMU init: the first init after A's, over B's keyframes only
    (f_a, chain_a, ok_a), (f_b, chain_b, ok_b) = [x for x in rec["inits"] if x[2]][:2]
    assert ok_a and ok_b and f_a < N_A <= f_b <= f_merge and inertial
    assert all(m.kf_time[k] < 100.0 for k in chain_a)
    assert all(m.kf_time[k] >= 100.0 for k in chain_b)
    # no IMU init ever ran over a chain holding both sessions
    assert all(len({m.kf_time[k] >= 100.0 for k in c}) == 1 for _, c, _ in rec["inits"])
    # merges confirmed before B's init were aborted, none after it
    aborted = [r[5] for r in rec["rows"]]
    assert aborted[f_b - 1] >= 1 and aborted[-1] == aborted[f_b - 1], aborted
    assert (kf, cand) not in lc.merges_aborted
    maps = [r[3] for r in rec["rows"]]
    assert all(x == [0] for x in maps[2:N_A])
    assert all(x == [0, 1] for x in maps[N_A + 2:f_merge])
    assert all(x == [0] for x in maps[f_merge:])
    assert all(r[2] == "OK" for r in rec["rows"][2:N_A] + rec["rows"][N_A + 2:])


def test_the_inertial_merge_route(run):
    slam, _, rec = run
    # the Sim3 the merge applies (the candidate's, refined on the keyframes
    # after B's init and projected each time) turns the young map about the
    # vertical only
    (_, kf, cand, _, s, tilt), = rec["merges"]
    assert s == 1.0 and tilt < 1e-6, (s, tilt)   # stereo: the Sim3's scale is fixed
    m = slam.map
    old_side = [k for k in m.valid_kf_ids() if m.kf_time[k] < 100.0]
    (four_dof, fixed), = rec["graph"]
    assert four_dof and set(old_side) <= set(fixed)
    (opt, weld_fixed), = rec["weld"]
    assert len(opt) == 10 and not set(opt) & set(weld_fixed)
    assert rec["gba"] == ["vi"]


def test_the_merged_map_passes_the_stereo_inertial_gates(run):
    slam, sessions, rec = run
    m, tr = slam.map, slam.tracker
    assert slam.get_tracking_state().name == "OK"
    assert m.map_ids() == [0] and m.current_map_id == 0 and m.n_maps_created == 2
    assert m.imu_initialized
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    assert all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
    assert all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf))
    traj = slam.trajectory_tum()
    assert len(traj) == len(rec["rows"]) - 4      # each session waits 2 frames for the gate
    got = joint_gates(m, traj, sessions)
    assert got["ok"], got
