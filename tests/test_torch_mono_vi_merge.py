"""Two mono-inertial sessions over one place merged into one Atlas map:
tpuslam's System and the port's in lockstep to the merge decision, then
the port's merged map and its control, on the CPU.

tests/torch_mono_vi_merge.py's sessions (tests/torch_vi_merge.py's
loop_sessions seen by the left camera, 376x240, 600 features, IMU at 200
Hz, a keyframe at least every 3 frames, FAST_INIT and SHORT_SCHEDULE): A is
26 frames (its two-view init, IMU init, VIBA1 and VIBA2), B 22 frames from
100 s (to its VIBA2), recognised against A just after its own two-view init
and IMU init.
The vocabulary is trained here and loaded by both packages; the GBA runs
synchronously; the port runs in f64, as tpuslam runs here (in f32 its
poses part from tpuslam's by up to 2.2 cm after A's IMU init and it merges
a frame earlier) and takes tpuslam's two-view and Sim3 RANSAC draws;
tpuslam's young map's initial BA is held to the port's repair
(tests/torch_mono_merge.init_ba_on_its_points; ROADMAP §3 has the fault).
tpuslam's run to its merge is read from its record (tests/torch_records.py,
written by tests/make_tpuslam_records.py mono_vi_merge), which stops on the
frame of its merge; the port's runs on to the end.

  * Lockstep to the merge decision: on every frame before it the same
    state, map ids, keyframe count and IMU flag, poses within 1 cm and 0.2
    degrees (tests/test_torch_system.py's; after an IMU init the world's z
    is gravity, so this holds the gravity direction too); both two-view
    inits on the same frames; the merge on the same frame between the same
    keyframes, and the same merges aborted (none).
  * The IMU events on the same frames (A's IMU init, VIBA1 and VIBA2, B's
    IMU init), with the last keyframe's biases within BIAS_TOL.
  * The Sim3 of the merge has a scale of exactly 1 in both packages: an
    inertial map merges at a fixed scale (`fix_scale` for every inertial
    sensor), so the inertial gate's scale window (0.9, 1.1) can reject no
    merge (ROADMAP §3). Each map's Horn scale just before the correction
    (its keyframes aligned alone) measures the gap the weld carries: B,
    just IMU-initialized, more than 5 % from A.
  * The port's merged map: one merge, inside B and after B's IMU init (maps
    2 -> 1), OK at the end, the IMU initialized, nothing left in the young
    map. It goes on from B's IMU stage, which is behind A's (A has run
    VIBA2): B's VIBA1 and VIBA2 run after the merge over both sessions'
    keyframes, and no scale refinement runs over a chain that holds A's
    keyframes. PERF.md §2's mono-inertial gates on one alignment of both
    sessions' rows: a scaled ATE under 6 cm, a Horn scale within 0.4 of 1,
    |R[2, 2]| > 0.99, a median keyframe-velocity error under 0.2 m/s,
    finite keyframe states, and the two sessions' Horn scales (each aligned
    alone) within 5 % of each other.
  * The control, the same frames to B's frame N_CONTROL without a
    vocabulary (the port in f32, in a process of its own; the run with one
    merges on B's frame 13): 2 maps at the end, OK.
"""

import numpy as np
import pytest
import torch

import tpuslam.engine.inertial as j_inertial
import tpuslam.engine.tracking as j_tracking
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import InertialConfig as JInertialConfig
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.place import load_orbvoc as j_load_orbvoc
from tpuslam_torch.ops import twoview
from tpuslam_torch.place import load_orbvoc
from tpuslam_torch.solve import sim3 as t_sim3

import torch_child
import torch_mono_vi_merge as mv
import torch_records
from test_torch_mono_merge import _Draws
from torch_mono_merge import init_ba_on_its_points
from torch_vi_merge import NOISE, vocabulary_text

torch.set_num_threads(2)
POS_TOL, ROT_TOL = 0.01, 0.2       # tests/test_torch_system.py's
# rad/s, m/s^2: the last keyframe's biases at an IMU event (B's init solve, 10
# keyframes over 1 s, leaves the gyro bias weakly observed)
BIAS_TOL = dict(bg=3e-3, ba=1e-3)
SCALE_GAP = 0.05                    # the maps' Horn scales at the merge: further apart than this
N_CONTROL = 16                      # B's frames in the control


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _tpuslam_to_the_merge(voc):
    """tpuslam's IMU_MONOCULAR System over A, change_dataset(), then B up
    to the frame of its merge: mv.drive's record."""
    seq, sessions = mv.sessions()
    cfg = JSlamConfig(orb=JOrbConfig(n_features=mv.FEATURES),
                      tracking=JTrackingConfig(max_frames_between_kf=mv.MAX_KF_FRAMES),
                      loop=JLoopConfig(background_gba=False),
                      inertial=JInertialConfig(**mv.INERTIAL))
    slam = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), cfg,
                   sensor=JSensor.IMU_MONOCULAR,
                   imu_calib=JImuCalib(**dict(NOISE, freq=seq.imu_rate)),
                   vocab=j_load_orbvoc(voc))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_tracking.Tracker, "_initial_ba",
                   init_ba_on_its_points(j_tracking.Tracker._initial_ba))
        return mv.drive(slam, sessions, stop_after_merge=True, init_module=j_inertial)


def _port_without_a_vocabulary():
    """The control: the port's run of both sessions with no vocabulary."""
    seq, sessions = mv.sessions(n_b=N_CONTROL)
    slam = mv.port_system(seq)
    rec = mv.drive(slam, sessions)
    return rec["rows"][-1], mv.mono_gates(slam.map, slam.trajectory_tum(), sessions)


def record_inputs(seq, voc):
    """Fingerprints of the inputs of tpuslam's recorded run
    (tests/torch_records.py): the sequence's frames and the vocabulary."""
    return {"frames": torch_records.sequence_fingerprint(seq, seq.n_frames),
            "vocabulary": torch_records.text_digest(voc)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tpuslam's record and the port's control (in a process of its own)
    beside the port's whole route, the port handed tpuslam's draws."""
    seq, sessions = mv.sessions()
    voc = vocabulary_text(seq, str(tmp_path_factory.mktemp("voc") / "voc.txt"))
    jax_side = torch_records.recorded("mono_vi_merge", record_inputs(seq, voc))
    control = torch_child.start(_port_without_a_vocabulary)
    draws = _Draws()
    slam = mv.port_system(seq, load_orbvoc(voc), dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twoview, "draw_samples", draws.twoview)
        mp.setattr(t_sim3, "draw_samples", draws.sim3)
        rec = mv.drive(slam, sessions)
    return dict(port=(slam, rec), tpuslam=jax_side.result(), control=control.result(),
                sessions=sessions)


def test_lockstep_to_the_merge_decision(runs):
    _, rec = runs["port"]
    jrec = runs["tpuslam"]
    assert len(rec["merges"]) == 1 and len(jrec["merges"]) == 1, (rec["merges"],
                                                                  jrec["merges"])
    n, kf, cand = rec["merges"][0][:3]
    assert (n, kf, cand) == jrec["merges"][0][:3]
    print(f"merge on frame {n}, keyframe {kf} onto {cand}; IMU events "
          f"{[e[:2] for e in rec['events']]}")
    rows, j_rows = rec["rows"], jrec["rows"]
    assert len(j_rows) == n + 1
    for a, b in zip(rows[:n], j_rows[:n]):
        where = a[:2]
        assert a[4:] == b[4:], (where, a[4:], b[4:])     # state, maps, keyframes, IMU
        assert (a[3] is None) == (b[3] is None), where
        if a[3] is not None:
            assert np.linalg.norm(a[3][:3, 3] - b[3][:3, 3]) < POS_TOL, where
            assert _rot_deg(a[3][:3, :3], b[3][:3, :3]) < ROT_TOL, where
    # both two-view inits on the same frames: the first OK frame of each session
    for s in (0, 1):
        assert (next(r[1] for r in rows if r[0] == s and r[4] == "OK")
                == next(r[1] for r in j_rows if r[0] == s and r[4] == "OK"))
    assert rec["aborted"] == jrec["aborted"]


def test_the_imu_events_and_biases(runs):
    """A's IMU init, VIBA1 and VIBA2 and B's IMU init on the same frames in
    both packages, the last keyframe's biases at each within BIAS_TOL."""
    _, rec = runs["port"]
    jrec = runs["tpuslam"]
    events = [e for e in rec["events"] if e[1] <= rec["merges"][0][0]]
    assert [e[:2] for e in events] == [e[:2] for e in jrec["events"]]
    assert [e[0] for e in events] == ["imu_init", "viba1", "viba2", "imu_init"]
    for (ev, f, bg, ba), (_, _, jbg, jba) in zip(events, jrec["events"]):
        print(f"{ev} on frame {f}: |bg - tpuslam's| {np.abs(bg - jbg).max():.2e}, "
              f"|ba - tpuslam's| {np.abs(ba - jba).max():.2e}")
        assert np.abs(bg - jbg).max() < BIAS_TOL["bg"], (ev, f, bg, jbg)
        assert np.abs(ba - jba).max() < BIAS_TOL["ba"], (ev, f, ba, jba)


def test_the_merge_is_at_a_fixed_scale(runs):
    """ROADMAP §3, the inertial scale window: both packages' merge Sim3 has
    a scale of exactly 1 while the two maps' own scales, measured on their
    keyframes just before the correction, are further apart than the
    window's 10 % allows a free Sim3."""
    _, rec = runs["port"]
    jrec = runs["tpuslam"]
    (_, _, _, s, flags, stage, scales), = rec["merges"]
    assert s == 1.0 and jrec["merges"][0][3] == 1.0
    assert flags == (True, False, False) and stage == 1     # B: IMU init, no VIBA1 yet
    (sa, _), (sb, _) = scales[0], scales[1]
    print(f"the maps' Horn scales just before the correction: A {sa:.5f}, B {sb:.5f} "
          f"({abs(sb / sa - 1.0) * 100:.2f} % apart); tpuslam's {jrec['merges'][0][6]}")
    assert abs(sb / sa - 1.0) > SCALE_GAP
    j_scales = jrec["merges"][0][6]
    assert abs(j_scales[1][0] / j_scales[0][0] - 1.0) > SCALE_GAP


def test_one_merge_after_the_young_maps_imu_init(runs):
    slam, rec = runs["port"]
    n_a = runs["sessions"][0].n_frames
    (n, _, _, s, flags, stage, _), = rec["merges"]
    maps = [r[5] for r in rec["rows"]]
    assert n > n_a and flags[0] and stage < 3 and maps[n - 1] == [0, 1]
    assert all(mp == [0] for mp in maps[n:]) and rec["rows"][-1][4] == "OK"
    m, tr = slam.map, slam.tracker
    assert m.map_ids() == [0] and m.current_map_id == 0 and m.imu_initialized and m.merged
    pts = m.valid_mp_ids()
    assert all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
    assert all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf))


def test_the_merged_map_goes_on_from_the_young_maps_stage(runs):
    slam, rec = runs["port"]
    (n, *_), = rec["merges"]
    t0 = runs["sessions"][1].t0
    assert [e[0] for e in rec["events"] if e[1] > n] == ["viba1", "viba2"]
    assert slam.map.viba_stage == 3 and slam.map.inertial_ba2
    assert all(last < t0 or first >= t0 for _, _, first, last in rec["refinements"])


def test_the_mono_inertial_gates(runs):
    slam, _ = runs["port"]
    gates = mv.mono_gates(slam.map, slam.trajectory_tum(), runs["sessions"])
    print(f"the joint gates: {gates}")
    assert gates["ok"], gates


def test_without_a_vocabulary_two_maps(runs):
    last, gates = runs["control"]
    print(f"without a vocabulary: {gates}")
    assert last[5] == [0, 1] and last[4] == "OK"
