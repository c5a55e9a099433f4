"""Two stereo sessions merged into one Atlas map with the mapper on its own
thread (bench.py's configuration: async mapping and pipelined tracking):
tpuslam's System and the port's, on the CPU.

tests/test_torch_atlas_merge.py's room, sessions and vocabulary (its
`room` fixture), with `async_mapping=True` and `TrackingConfig(
pipelined=True)`. Serialized async: each System's worker is flushed after
every `track_stereo` call, so the worker's code runs (the mapper's per-stage
locking, the loop closer under the map lock, the merge on the worker
thread) in a fixed order and both packages are deterministic. The pipeline
keeps one frame in flight: the keyframe that confirms the merge is made when
frame n - 1 completes inside call n, the worker merges after that call, and
frame n, dispatched in call n against the map before the merge, completes
in call n + 1 after it.

  * Lockstep: both Systems (synchronous GBA, the port's Sim3 RANSAC handed
    tpuslam's draws) merge on the same call, between the same current and
    candidate keyframes, with the same map ids and loop count on every
    frame; the merged map has the same keyframes and labels, keyframe poses
    within 1 cm and 0.2 degrees and point counts within 5 %
    (test_torch_atlas_merge.py's tolerances); every trajectory row but
    frame n's within 1 cm of the other package's.
  * The frame in flight across the merge: tpuslam logs frame n's pose,
    computed in the young map's old frame, relative to its reference
    keyframe after the merge moved it, so its row lands ~0.3 m off
    (tpuslam's fault). The port moves a frame whose anchor keyframe moved
    while it was in flight with that keyframe (Tracker._reanchor), so after
    one unscaled alignment of all rows frame n's row is within 5 cm of the
    ground truth, as the joint ATE is.
  * Gates for each package: one merge, inside B (maps 2 -> 1), OK at the
    end with nothing left in the young map, no worker errors.

tpuslam's run is read from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py). The route with real concurrency (`run.main
--async-mapping --pipelined`) is tests/test_torch_async_merge_cli.py.
"""

import jax
import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.place import load_orbvoc as j_load_orbvoc
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import horn_align
from tpuslam_torch.place import load_orbvoc
from tpuslam_torch.solve import sim3 as t_sim3

from test_torch_atlas_merge import (ATE_GATE, N_A, N_B, N_FEATURES, PACKAGES, POS_TOL, ROT_TOL,
                                    _drive, _joint_ate, _rot_deg)
from test_torch_atlas_merge import record_inputs
from test_torch_atlas_merge import room  # noqa: F401  (the fixture)
import torch_records
from torch_async import serialized

torch.set_num_threads(2)
STALE_ROW = 0.2   # m: tpuslam's row of the frame in flight across the merge is further off


def _async_system(package, seq, voc):
    loop = dict(background_gba=False)
    track = dict(min_stereo_init_features=200, pipelined=True)
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    if package == "port":
        cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                         tracking=TrackingConfig(**track), loop=LoopConfig(**loop))
        return serialized(System(Pinhole(cam, seq.width, seq.height), cfg,
                                 sensor=Sensor.STEREO, bf=seq.fx * seq.baseline, device="cpu",
                                 vocab=load_orbvoc(voc), async_mapping=True))
    cfg = JSlamConfig(orb=JOrbConfig(n_features=N_FEATURES),
                      tracking=JTrackingConfig(**track), loop=JLoopConfig(**loop))
    return serialized(JSystem(JPinhole(cam, seq.width, seq.height), cfg,
                              sensor=JSensor.STEREO, bf=seq.fx * seq.baseline,
                              vocab=j_load_orbvoc(voc), async_mapping=True))


def _run(package, room):
    """One package's serialized async, pipelined run of the two sessions
    (the port's Sim3 RANSAC handed tpuslam's samples: its LoopCloser's
    PRNGKey(7), split once per try). Returns the rows and merges of
    test_torch_atlas_merge._drive and what the tests read of the System."""
    seq, _, _, voc = room
    key = [jax.random.PRNGKey(7)]

    def draw(n_valid, n_hyp, generator=None):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))

    slam = _async_system(package, seq, voc)
    with pytest.MonkeyPatch.context() as mp:
        if package == "port":
            mp.setattr(t_sim3, "draw_samples", draw)
        (rows,), (merges,) = _drive([slam], room)
    m, tr = slam.map, slam.tracker
    kfs = m.valid_kf_ids(all_maps=True)
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    return dict(rows=rows, merges=merges, kfs=kfs, kf_map_id=m.kf_map_id[kfs],
                centers=np.array([m.kf_center(k) for k in kfs]), kf_R=m.kf_R[kfs],
                n_points=len(pts), loop_edges=[e[:2] for e in slam.loop_closer.loop_edges],
                traj=slam.trajectory_tum(), state=slam.get_tracking_state().name,
                errors=[repr(e) for e in slam.async_mapper.errors],
                alive=slam.async_mapper.worker.is_alive(), map_ids=m.map_ids(),
                current_map=m.current_map_id, maps_created=m.n_maps_created,
                young_left=not (all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
                                and all(m.kf_valid[k] and m.kf_map_id[k] == 0
                                        for k in (tr.ref_kf, tr.last_kf))))


@pytest.fixture(scope="module")
def lockstep(room):
    """Both packages' serialized async runs, tpuslam's from its record
    (tests/torch_records.py)."""
    jax_side = torch_records.recorded("async_merge", record_inputs(room))
    port = _run("port", room)
    return {"port": port, "tpuslam": jax_side.result()}


def _row_errors(sessions, traj):
    """Per trajectory row, the distance of its camera center from the
    ground truth's after one unscaled alignment of all rows."""
    times = [(s, t) for s, sess in enumerate(sessions) for t in sess.timestamps()]
    traj = np.asarray(traj, np.float64)
    assert len(traj) == len(times) and np.allclose(traj[:, 0], [t for _, t in times])
    gt = []
    for s, t in times:
        R, tt = sessions[s].gt_pose_cw(t)
        gt.append(-R.T @ tt)
    return horn_align(traj[:, 1:4], np.asarray(gt), with_scale=False)[3]


def test_serialized_async_merges_as_tpuslam(lockstep):
    t, j = lockstep["port"], lockstep["tpuslam"]
    assert t["merges"] == j["merges"] and len(t["merges"]) == 1, (t["merges"], j["merges"])
    (n, kf, cand), = t["merges"]
    assert n > N_A, "the merge fires inside session B"
    for a, b in zip(t["rows"], j["rows"]):
        assert a[4] == b[4] and a[5] == b[5], (a[:2], a[4:], b[4:])   # map ids, loops
    kfs = list(t["kfs"])
    assert t["kf_map_id"][kfs.index(kf)] == t["kf_map_id"][kfs.index(cand)] == 0
    assert np.array_equal(t["kfs"], j["kfs"]) and np.array_equal(t["kf_map_id"], j["kf_map_id"])
    for k, ct, cj, Rt, Rj in zip(kfs, t["centers"], j["centers"], t["kf_R"], j["kf_R"]):
        assert np.linalg.norm(ct - cj) < POS_TOL, k
        assert _rot_deg(Rt, Rj) < ROT_TOL, k
    assert abs(t["n_points"] - j["n_points"]) <= 0.05 * j["n_points"], (t["n_points"],
                                                                         j["n_points"])
    assert t["loop_edges"] == j["loop_edges"] == [(cand, kf)]
    traj = {p: np.asarray(r["traj"]) for p, r in lockstep.items()}
    assert len(traj["port"]) == len(traj["tpuslam"]) == N_A + N_B
    for i, (a, b) in enumerate(zip(traj["port"], traj["tpuslam"])):
        if i != n:
            assert np.linalg.norm(a[1:4] - b[1:4]) < POS_TOL, i


@pytest.mark.parametrize("package", PACKAGES)
def test_the_frame_in_flight_across_the_merge(lockstep, room, package):
    run = lockstep[package]
    sessions = room[2]
    (n, _, _), = run["merges"]
    err = _row_errors(sessions, run["traj"])
    assert np.delete(err, n).max() < 2 * ATE_GATE, err
    if package == "tpuslam":
        # its fault: frame n's pose, computed before the merge, logged after it
        assert err[n] > STALE_ROW, err[n]
    else:
        assert err[n] < ATE_GATE, err[n]
        assert _joint_ate(sessions, run["traj"]) < ATE_GATE


@pytest.mark.parametrize("package", PACKAGES)
def test_serialized_async_merge_gates(lockstep, package):
    run = lockstep[package]
    (n, _, _), = run["merges"]
    maps = [r[4] for r in run["rows"]]
    assert all(mp == [0] for mp in maps[:N_A])
    assert all(mp == [0, 1] for mp in maps[N_A:n]) and all(mp == [0] for mp in maps[n:])
    assert [r[5] for r in run["rows"]] == [0] * n + [1] * (N_A + N_B - n)
    assert run["state"] == State.OK.name
    assert run["errors"] == [] and not run["alive"]
    assert run["map_ids"] == [0] and run["current_map"] == 0 and run["maps_created"] == 2
    assert not run["young_left"]
