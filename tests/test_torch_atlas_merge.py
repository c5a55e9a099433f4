"""Two stereo sessions over one place merged into one Atlas map: tpuslam's
System and the port's, on the CPU.

One rendered room (376x240, 700 features, 10 fps, 0.5 m/s, baseline 0.1 m)
gives two sessions, as EuRoC's MH01 and MH02 do: A is frames 0-15 from its
own first camera; B is frames 6-21, stamped 100 s after A's start (later
than all of A's), so it opens its map at a pose A passed through, ~0.3 m
from A's origin. Both trees' ground truth is in the room's world frame.
The vocabulary is trained here on ORB descriptors of frames of the room,
written in the reference's text format and loaded by both packages.

  * Lockstep at System level: both Systems (STEREO, the same vocabulary,
    synchronous GBA so that the run is deterministic, the port's Sim3
    RANSAC handed tpuslam's draws) track A, `change_dataset()`, then B.
    On every frame: the same map ids and loop count, poses within 1 cm and
    0.2 degrees (tests/test_torch_system.py's tolerances). The merge: on the
    same frame, between the same current and candidate keyframes; the
    merged map afterwards has the same keyframes and map labels, keyframe
    poses within 1 cm and 0.2 degrees and point counts within 5 % (looser
    than test_torch_loop.py's 1e-6: the Systems' solvers differ in
    precision and their f32 and f64 rounding add up over 21 frames, the
    per-frame tolerance above).
  * Gates for each package: exactly one merge, inside B (maps 2 -> 1);
    OK at the end, with no keyframe, point observation or tracker keyframe
    left in the young map; B's frames in B's own frame before the merge and in A's
    after it; one unscaled alignment of both sessions' rows to both trees'
    ground truth with ATE under 5 cm (PERF.md §2's stereo gate).
  * The control, for each package: the same run without a vocabulary ends
    with 2 maps and a joint ATE above 10 cm, so the gate tells a merge from
    none.
  * `run.main --path A,B --vocab voc.txt` of both packages on the two
    written trees (the port on `--device cpu`, the default background
    GBA): one map, OK, the summed frame count, joint ATE from the
    trajectory file under 5 cm.

tpuslam's three runs (the lockstep run, the control and run.main) are read
from their record (tests/torch_records.py, written by
tests/make_tpuslam_records.py, which checks the frames' and the vocabulary's
fingerprints); the two packages' Systems never read each other, so they are
compared afterwards.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from tpuslam import run as j_run
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.place import load_orbvoc as j_load_orbvoc
from tpuslam_torch import run
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.frontend import Frontend
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import associate, ate_rmse
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.place import load_orbvoc, save_orbvoc_text, train_vocabulary
from tpuslam_torch.solve import sim3 as t_sim3

import torch_records
from test_torch_cli import _script

torch.set_num_threads(2)
FPS, N_FEATURES = 10.0, 700
N_A, START_B, N_B, T0_B = 16, 6, 16, 100.0
ATE_GATE, CONTROL_ATE = 0.05, 0.10
POS_TOL, ROT_TOL = 0.01, 0.2       # tests/test_torch_system.py's
PACKAGES = ("port", "tpuslam")


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _make_room(voc):
    """The sequence, its rendered frames, sessions A and B (views of it) and
    the vocabulary's text file, written to voc."""
    seq = SyntheticSequence(seed=0, n_frames=START_B + N_B, fps=FPS, speed=0.5, baseline=0.1)
    frames = [(seq.frame(i), seq.frame(i, right=True)) for i in range(seq.n_frames)]
    view = _script().SessionView
    sessions = [view(seq, 0, N_A, 0.0), view(seq, START_B, N_B, T0_B)]
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    fe = Frontend(cam, OrbConfig(n_features=N_FEATURES), device="cpu")
    bits = [f.bits[f.valid] for f in (fe.process(frames[i][0]) for i in (0, 4, 8, 12))]
    save_orbvoc_text(train_vocabulary(np.concatenate(bits), k=8, L=3, iters=5, device="cpu"),
                     voc)
    return seq, frames, sessions, voc


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    return _make_room(str(tmp_path_factory.mktemp("voc") / "voc.txt"))


def record_inputs(room):
    """Fingerprints of the inputs of tpuslam's recorded runs of this room
    (tests/torch_records.py): the frames and the vocabulary."""
    seq, _, _, voc = room
    return {"frames": torch_records.sequence_fingerprint(seq, seq.n_frames, right=True),
            "vocabulary": torch_records.text_digest(voc)}


def _system(package, seq, voc):
    loop = dict(background_gba=False)
    track = dict(min_stereo_init_features=200)
    if package == "port":
        cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                         tracking=TrackingConfig(**track), loop=LoopConfig(**loop))
        return System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), cfg,
                      sensor=Sensor.STEREO, bf=seq.fx * seq.baseline, device="cpu",
                      vocab=load_orbvoc(voc) if voc else None)
    cfg = JSlamConfig(orb=JOrbConfig(n_features=N_FEATURES),
                      tracking=JTrackingConfig(**track), loop=JLoopConfig(**loop))
    return JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), cfg,
                   sensor=JSensor.STEREO, bf=seq.fx * seq.baseline,
                   vocab=j_load_orbvoc(voc) if voc else None)


def _drive(systems, room):
    """Feed session A, change_dataset(), then B to every System, frame by
    frame. Returns per System the rows (session, frame, time, Tcw, map ids,
    loops closed) and the merges [(frame number, kf, cand)], where the frame
    number counts over both sessions."""
    seq, frames, sessions, _ = room
    rows = [[] for _ in systems]
    merges = [[] for _ in systems]
    n_seen = [0]
    for slam, got in zip(systems, merges):
        real = slam.loop_closer._correct_loop if slam.loop_closer is not None else None

        def correct(kf, cand, *a, merge=False, _real=real, _got=got, **kw):
            if merge:
                _got.append((n_seen[0], int(kf), int(cand)))
            return _real(kf, cand, *a, merge=merge, **kw)

        if real is not None:
            slam.loop_closer._correct_loop = correct
    for s, sess in enumerate(sessions):
        if s:
            for slam in systems:
                slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            left, right = frames[sess.start + i]
            for slam, out in zip(systems, rows):
                Tcw = slam.track_stereo(left, right, float(t))
                lc = slam.loop_closer
                out.append((s, i, float(t), None if Tcw is None else np.asarray(Tcw),
                            slam.map.map_ids(), lc.n_loops_closed if lc is not None else 0))
            n_seen[0] += 1
    for slam in systems:
        slam.shutdown()
    return rows, merges


def _joint_ate(sessions, traj):
    """One unscaled alignment of every trajectory row (t, x, y, z, ...) to the
    ground truth of both sessions, in the room's world frame."""
    t_gt = np.concatenate([s.timestamps() for s in sessions])
    xyz = []
    for s in sessions:
        for t in s.timestamps():
            Rcw, tcw = s.gt_pose_cw(t)
            xyz.append(-Rcw.T @ tcw)
    traj = np.asarray(traj, np.float64)
    i_e, i_g = associate(traj[:, 0], t_gt)
    assert len(i_e) == len(traj)
    return ate_rmse(traj[i_e, 1:4], np.asarray(xyz)[i_g], with_scale=False)[0]


def _expected_tcw(sessions, s_origin, s, t):
    """Ground-truth Tcw of session s's frame at time t, in the map whose
    origin is session s_origin's first camera."""
    R0, t0 = sessions[s_origin].gt_pose_cw(sessions[s_origin].timestamps()[0])
    R, tt = sessions[s].gt_pose_cw(t)
    return R @ R0.T, tt - R @ R0.T @ t0


def _summary(slam, rows, merges):
    """What the tests read of a System after its run (picklable)."""
    m, tr = slam.map, slam.tracker
    kfs = m.valid_kf_ids(all_maps=True)
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    return dict(rows=rows, merges=merges, kfs=kfs, kf_map_id=m.kf_map_id[kfs],
                centers=np.array([m.kf_center(k) for k in kfs]), kf_R=m.kf_R[kfs],
                n_points=len(pts), state=slam.get_tracking_state().name,
                loop_edges=[tuple(e[:2]) for e in slam.loop_closer.loop_edges]
                if slam.loop_closer is not None else [],
                map_ids=m.map_ids(), current_map=m.current_map_id,
                maps_created=m.n_maps_created, traj=slam.trajectory_tum(),
                young_left=not (all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
                                and all(m.kf_valid[k] and m.kf_map_id[k] == 0
                                        for k in (tr.ref_kf, tr.last_kf))))


def _control(package, room):
    seq = room[0]
    slam = _system(package, seq, None)
    rows, _ = _drive([slam], room)
    return dict(map_ids=[r[4] for r in rows[0]][-1], state=slam.get_tracking_state().name,
                traj=slam.trajectory_tum())


def _run_main(package, room, out_dir):
    """run.main --path A,B --vocab of one package on the two sessions written
    as EuRoC trees under out_dir: its report and trajectory rows."""
    seq, frames, sessions, voc = room
    script = _script()
    paths = []
    for name, sess in zip(("MH01", "MH02"), sessions):
        images = [tuple(np.clip(x, 0, 255).astype(np.uint8) for x in frames[sess.start + i])
                  for i in range(sess.n_frames)]
        yaml_path = script.write_euroc(sess, os.path.join(out_dir, name),
                                       n_features=N_FEATURES, images=images)
        paths.append(os.path.join(out_dir, name))
    out = os.path.join(out_dir, f"traj_{package}.txt")
    argv = ["--dataset", "euroc", "--path", ",".join(paths), "--settings", yaml_path,
            "--sensor", "stereo", "--vocab", voc, "--output", out]
    rep = (run.main(argv + ["--device", "cpu"]) if package == "port" else j_run.main(argv))
    return rep, np.loadtxt(out, ndmin=2)


def _tpuslam_side(room):
    """tpuslam's three runs of this file (its record's runs,
    tests/torch_records.py): the lockstep run, the control without a
    vocabulary and run.main on the written trees."""
    slam = _system("tpuslam", room[0], room[3])
    (rows,), (merges,) = _drive([slam], room)
    with tempfile.TemporaryDirectory() as out_dir:
        return dict(lockstep=_summary(slam, rows, merges), control=_control("tpuslam", room),
                    run_main=_run_main("tpuslam", room, out_dir))


@pytest.fixture(scope="module")
def lockstep(room):
    """Both packages' runs with the vocabulary, tpuslam's (with its control
    and run.main) from its record (tests/torch_records.py), compared
    afterwards (neither System reads the other); the port's Sim3 RANSAC
    takes tpuslam's samples (its LoopCloser's PRNGKey(7), split once per
    try)."""
    seq, _, _, voc = room
    jax_side = torch_records.recorded("atlas_merge", record_inputs(room))
    key = [jax.random.PRNGKey(7)]

    def draw(n_valid, n_hyp, generator=None):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))

    slam = _system("port", seq, voc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_sim3, "draw_samples", draw)
        (rows,), (merges,) = _drive([slam], room)
    tpuslam = jax_side.result()
    return dict(port=_summary(slam, rows, merges), tpuslam=tpuslam["lockstep"],
                tpuslam_control=tpuslam["control"], tpuslam_run_main=tpuslam["run_main"])


def test_sessions_track_in_lockstep(lockstep):
    rows = {p: lockstep[p]["rows"] for p in PACKAGES}
    assert len(rows["port"]) == len(rows["tpuslam"]) == N_A + N_B
    for a, b in zip(rows["port"], rows["tpuslam"]):
        where = a[:2]
        assert a[4] == b[4], (where, a[4], b[4])          # map ids
        assert a[5] == b[5], (where, a[5], b[5])          # loops closed
        assert a[3] is not None and b[3] is not None, where
        assert np.linalg.norm(a[3][:3, 3] - b[3][:3, 3]) < POS_TOL, where
        assert _rot_deg(a[3][:3, :3], b[3][:3, :3]) < ROT_TOL, where


def test_the_same_merge_and_merged_map(lockstep):
    t, j = lockstep["port"], lockstep["tpuslam"]
    assert t["merges"] == j["merges"] and len(t["merges"]) == 1, (t["merges"], j["merges"])
    (n, kf, cand), = t["merges"]
    assert n >= N_A, "the merge fires inside session B"
    kfs = list(t["kfs"])
    assert t["kf_map_id"][kfs.index(kf)] == t["kf_map_id"][kfs.index(cand)] == 0
    assert np.array_equal(t["kfs"], j["kfs"])
    assert np.array_equal(t["kf_map_id"], j["kf_map_id"])
    for k, ct, cj, Rt, Rj in zip(kfs, t["centers"], j["centers"], t["kf_R"], j["kf_R"]):
        assert np.linalg.norm(ct - cj) < POS_TOL, k
        assert _rot_deg(Rt, Rj) < ROT_TOL, k
    assert abs(t["n_points"] - j["n_points"]) <= 0.05 * j["n_points"], (t["n_points"],
                                                                         j["n_points"])
    assert t["loop_edges"] == j["loop_edges"] == [(cand, kf)]


@pytest.mark.parametrize("package", PACKAGES)
def test_one_merge_and_the_joint_gates(lockstep, room, package):
    sessions = room[2]
    run_ = lockstep[package]
    out = run_["rows"]
    maps = [r[4] for r in out]
    assert all(mp == [0] for mp in maps[:N_A])
    (n, _, _), = run_["merges"]
    # the second session opens map 1 and is merged into map 0 on frame n
    assert all(mp == [0, 1] for mp in maps[N_A:n]) and n > N_A
    assert all(mp == [0] for mp in maps[n:])
    assert [r[5] for r in out] == [0] * n + [1] * (N_A + N_B - n)
    assert run_["state"] == State.OK.name
    # nothing is left in the young map: keyframes, the points' keyframes,
    # the tracker's keyframes, the current map
    assert run_["map_ids"] == [0] and run_["current_map"] == 0 and run_["maps_created"] == 2
    assert not run_["young_left"]
    # B's frames are in B's own frame before the merge and in A's after it
    for k, (s, i, t, Tcw, _, _) in enumerate(out):
        origin = 0 if (s == 0 or k >= n) else 1
        R, tt = _expected_tcw(sessions, origin, s, t)
        c_est = -Tcw[:3, :3].T @ Tcw[:3, 3]
        assert np.linalg.norm(c_est - (-R.T @ tt)) < ATE_GATE, (s, i, origin)
    traj = run_["traj"]
    assert len(traj) == N_A + N_B
    assert _joint_ate(sessions, traj) < ATE_GATE


@pytest.mark.parametrize("package", PACKAGES)
def test_without_a_vocabulary_the_sessions_stay_apart(room, lockstep, package):
    sessions = room[2]
    out = lockstep["tpuslam_control"] if package == "tpuslam" else _control("port", room)
    assert out["map_ids"] == [0, 1]
    assert out["state"] == State.OK.name
    assert _joint_ate(sessions, out["traj"]) > CONTROL_ATE


@pytest.mark.parametrize("package", PACKAGES)
def test_run_main_merges_the_second_session(room, lockstep, tmp_path, package):
    sessions = room[2]
    rep, traj = (lockstep["tpuslam_run_main"] if package == "tpuslam"
                 else _run_main("port", room, str(tmp_path)))
    assert rep["maps"] == 1 and rep["state"] == "OK" and rep["frames"] == N_A + N_B, rep
    assert len(traj) == N_A + N_B
    assert _joint_ate(sessions, traj) < ATE_GATE
