"""Two stereo-inertial sessions over one place, the second recognised
against the first before its own IMU init: tpuslam's System and the port's
in lockstep on the CPU, and tpuslam's fault there.

tests/torch_vi_merge.py's `heave_sessions` (376x240, 600 features, 10 fps,
baseline 0.1 m, IMU at 200 Hz, a keyframe at least every 3 frames, the IMU
init after 6 keyframes over 1 s: FAST_INIT): A is frames 0-15 (its IMU
initializes on frame 15, its 6th keyframe), B is frames 6-16 of the same
heave sequence stamped from 100 s, so B opens map 1 at a pose A passed
through. The vocabulary is trained here on frames of the sequence and
loaded by both packages; the GBA runs synchronously; the port (f64, as
tpuslam runs here) takes tpuslam's Sim3 RANSAC draws. tpuslam's run is read
from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py) and compared frame by frame.

  * Lockstep until the runs part: on every frame the same tracking state,
    map ids and keyframe count, poses within 1 cm and 0.2 degrees
    (tests/test_torch_system.py's tolerances). On B's sixth frame both
    confirm the same merge, between the same keyframes, three keyframes
    after B's stereo init and before B's IMU init (B has 3 keyframes, the
    init needs 6 and 1 s). That is where they part, by design: an
    inertial map merges only once its own IMU is initialized (ORB-SLAM3's
    LoopClosing::Run aborts the merge: "IMU is not initilized, merge is
    aborted"); tpuslam merges it, the port records the merge as aborted.
  * tpuslam's fault (ROADMAP §3): its merge is visual (the young map's
    flags are down, and the store keeps one set of IMU flags for all maps,
    so the merged map says "not initialized" although A's keyframes are
    gravity-aligned and metric), tracking is lost on the next frame, and
    on the next keyframe its IMU stage runs the IMU init again over the
    merged chain: A's keyframes and B's, across the 100 s gap. That init
    moves A's keyframes by decimetres and writes a gyro bias of ~0.8 rad/s.
  * The port on the same frames: both maps stay, no IMU init runs over A's
    keyframes, A's keyframe poses do not move, and tracking stays OK.
    (tests/test_torch_vi_merge_port.py runs B on to the port's merge after
    B's own IMU init.)
"""

import jax
import numpy as np
import pytest
import torch

import tpuslam.engine.inertial as j_inertial
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
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import local_mapping
from tpuslam_torch.engine.config import (InertialConfig, LoopConfig, OrbConfig, SlamConfig,
                                         TrackingConfig)
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.place import load_orbvoc
from tpuslam_torch.solve import sim3 as t_sim3

import torch_records
from torch_vi_merge import (FAST_INIT, FEATURES, HEAVE_A, NOISE, heave_sessions, session_imu,
                            vocabulary_text)

torch.set_num_threads(2)
POS_TOL, ROT_TOL = 0.01, 0.2       # tests/test_torch_system.py's
PACKAGES = ("port", "tpuslam")


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _system(package, seq, voc):
    track = dict(max_frames_between_kf=3)
    bf = seq.fx * seq.baseline
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    if package == "port":
        cfg = SlamConfig(orb=OrbConfig(n_features=FEATURES), tracking=TrackingConfig(**track),
                         loop=LoopConfig(background_gba=False),
                         inertial=InertialConfig(**FAST_INIT))
        return System(Pinhole(cam, seq.width, seq.height), cfg, sensor=Sensor.IMU_STEREO,
                      imu_calib=ImuCalib(**NOISE), bf=bf, vocab=load_orbvoc(voc),
                      dtype=torch.float64, device="cpu")
    cfg = JSlamConfig(orb=JOrbConfig(n_features=FEATURES), tracking=JTrackingConfig(**track),
                      loop=JLoopConfig(background_gba=False),
                      inertial=JInertialConfig(**FAST_INIT))
    return JSystem(JPinhole(cam, seq.width, seq.height), cfg, sensor=JSensor.IMU_STEREO,
                   imu_calib=JImuCalib(**NOISE), bf=bf, vocab=j_load_orbvoc(voc))


def _run(package, voc):
    """One package's System over A, change_dataset(), then B, frame by
    frame. Returns its rows (session, frame, t, Tcw, state, map ids,
    keyframes), the merges corrected [(frame, kf, cand)], the IMU inits
    [(frame, chain, largest move of a keyframe of A, ok)], A's keyframe
    poses at the end of A, and what the tests read of its map and closer.
    The port takes tpuslam's Sim3 RANSAC draws."""
    seq, sessions = heave_sessions()
    slam = _system(package, seq, voc)
    frame = [0]
    rec = dict(rows=[], merges=[], inits=[])
    key = [jax.random.PRNGKey(7)]

    def draw(n_valid, n_hyp, generator=None):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))

    def init_probe(real):
        def run_imu_init(m, *a, **kw):
            chain = [int(k) for k in m.temporal_chain()]
            before = {k: m.kf_center(k).copy() for k in chain}
            ok = real(m, *a, **kw)
            a_kfs = [k for k in chain if m.kf_time[k] < sessions[1].t0]
            moved = max((float(np.linalg.norm(m.kf_center(k) - before[k])) for k in a_kfs),
                        default=0.0)
            rec["inits"].append((frame[0], chain, moved, bool(ok)))
            return ok
        return run_imu_init

    with pytest.MonkeyPatch.context() as mp:
        if package == "port":
            mp.setattr(t_sim3, "draw_samples", draw)
            mp.setattr(local_mapping, "run_imu_init", init_probe(local_mapping.run_imu_init))
        else:
            mp.setattr(j_inertial, "run_imu_init", init_probe(j_inertial.run_imu_init))
        real = slam.loop_closer._correct_loop

        def correct(kf, cand, *a, merge=False, **kw):
            if merge:
                rec["merges"].append((frame[0], int(kf), int(cand)))
            return real(kf, cand, *a, merge=merge, **kw)

        slam.loop_closer._correct_loop = correct
        for s, sess in enumerate(sessions):
            if s:
                rec["a_kfs"] = {int(k): (slam.map.kf_R[k].copy(), slam.map.kf_t[k].copy())
                                for k in slam.map.valid_kf_ids()}
                slam.change_dataset()
            for i, t in enumerate(sess.timestamps()):
                Tcw = slam.track_stereo(sess.frame(i), sess.frame(i, right=True), float(t),
                                        imu=session_imu(sess, i))
                m = slam.map
                rec["rows"].append((s, i, float(t), None if Tcw is None else np.asarray(Tcw),
                                    slam.get_tracking_state().name, m.map_ids(),
                                    len(m.valid_kf_ids(all_maps=True))))
                frame[0] += 1
    slam.shutdown()
    m = slam.map
    rec["map"] = {f: np.array(getattr(m, f)[: m.n_kf]) for f in
                  ("kf_valid", "kf_map_id", "kf_frame_id", "kf_time", "kf_R", "kf_t", "kf_bg")}
    rec["merges_aborted"] = list(getattr(slam.loop_closer, "merges_aborted", []))
    return rec


def record_inputs(seq, voc):
    """Fingerprints of the inputs of tpuslam's recorded run
    (tests/torch_records.py): the heave sequence and the vocabulary."""
    return {"frames": torch_records.sequence_fingerprint(seq, seq.n_frames, right=True),
            "vocabulary": torch_records.text_digest(voc)}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """Both Systems over A, change_dataset(), then B: tpuslam's from its
    record (tests/torch_records.py), compared with the port's frame by frame
    (neither System reads the other). Per package, _run's record."""
    seq, _ = heave_sessions()
    voc = vocabulary_text(seq, str(tmp_path_factory.mktemp("voc") / "voc.txt"))
    jax_side = torch_records.recorded("vi_merge", record_inputs(seq, voc))
    port = _run("port", voc)
    return {"port": port, "tpuslam": jax_side.result()}


def _parting_frame(rec):
    (frame, _, _), = rec["tpuslam"]["merges"]
    return frame


def test_lockstep_until_the_merge_decision(lockstep):
    rec = lockstep
    rows_p, rows_j = rec["port"]["rows"], rec["tpuslam"]["rows"]
    part = _parting_frame(rec)
    assert HEAVE_A < part < len(rows_j), part
    for a, b in zip(rows_p[:part], rows_j[:part]):
        where = a[:2]
        assert a[4:] == b[4:], (where, a[4:], b[4:])        # state, maps, keyframes
        assert (a[3] is None) == (b[3] is None), where
        if a[3] is not None:
            assert np.linalg.norm(a[3][:3, 3] - b[3][:3, 3]) < POS_TOL, where
            assert _rot_deg(a[3][:3, :3], b[3][:3, :3]) < ROT_TOL, where
    # A's IMU initializes on the same frame in both, over the same chain
    (fi, chain, _, ok), = [x for x in rec["port"]["inits"] if x[0] < HEAVE_A]
    assert ok and (fi, chain) == rec["tpuslam"]["inits"][0][:2]
    # the same merge, confirmed on the same frame: tpuslam corrects it, the
    # port aborts it because B has not initialized its IMU
    (_, kf, cand), = rec["tpuslam"]["merges"]
    aborted = rec["port"]["merges_aborted"]
    assert aborted[0] == (kf, cand), aborted
    m = rec["port"]["map"]
    assert m["kf_map_id"][kf] == 1 and m["kf_map_id"][cand] == 0
    assert m["kf_frame_id"][kf] == rec["tpuslam"]["map"]["kf_frame_id"][kf]
    assert rows_j[part][5] == [0] and rows_p[part][5] == [0, 1]


def test_tpuslam_merges_before_the_young_maps_imu_init(lockstep):
    """The fault of tpuslam's detection and store (ROADMAP §3): the merge
    runs without B's IMU init, and the IMU stage then initializes the merged
    map again over both sessions, rewriting A's gravity-aligned keyframes."""
    rec = lockstep
    jm, part = rec["tpuslam"]["map"], _parting_frame(rec)
    rows = rec["tpuslam"]["rows"]
    # the merge left one map whose flags say "not initialized"
    assert all(r[5] == [0] for r in rows[part:])
    # tracking is lost right after the merge
    assert "RECENTLY_LOST" in [r[4] for r in rows[part:]]
    # the IMU init runs again, over A's keyframes and B's across the gap
    again = [x for x in rec["tpuslam"]["inits"] if x[0] > part]
    assert again, rec["tpuslam"]["inits"]
    fi, chain, moved, ok = again[0]
    a_kfs = set(rec["tpuslam"]["a_kfs"])
    assert ok and a_kfs <= set(chain) and len(chain) > len(a_kfs)
    times = jm["kf_time"][chain]
    assert times.max() - times.min() > 90.0
    assert moved > 0.1, moved          # decimetres: A's map is rewritten
    assert np.abs(jm["kf_bg"][chain[-1]]).max() > 0.1, jm["kf_bg"][chain[-1]]


def test_the_port_keeps_both_maps_until_the_young_maps_imu_init(lockstep):
    rec = lockstep
    rows = rec["port"]["rows"]
    part = _parting_frame(rec)
    assert rec["port"]["merges"] == []
    assert all(r[4] == "OK" for r in rows[part:]) and all(r[5] == [0, 1] for r in rows[part:])
    # the IMU init ran once, over A's keyframes; none over a chain with both
    assert [x[2] for x in rec["port"]["inits"]][1:] == [0.0] * (len(rec["port"]["inits"]) - 1)
    assert all(max(x[1]) < min(rec["port"]["a_kfs"]) or set(x[1]) <= set(rec["port"]["a_kfs"])
               for x in rec["port"]["inits"])
    m = rec["port"]["map"]
    for k, (R, t) in rec["port"]["a_kfs"].items():
        assert m["kf_valid"][k] and m["kf_map_id"][k] == 0
        assert np.array_equal(m["kf_R"][k], R) and np.array_equal(m["kf_t"][k], t), k
    assert len(rec["port"]["merges_aborted"]) >= 1
