"""Two monocular sessions over one place merged into one Atlas map:
tpuslam's System and the port's, on the CPU.

tests/torch_mono_merge.py's room: A is frames 0-19, B frames 16-29 from
100 s (376x240, 650 features, a keyframe at least every 3 frames). Each
mono map's unit is its own two-view init's median depth: the merge is a
Sim3 with a free scale (`fix_scale` off), 1.176 B units per A unit.

  * Lockstep to the merge decision: both MONOCULAR Systems (the same
    vocabulary, synchronous GBA; the port's two-view and Sim3 RANSACs
    handed tpuslam's draws) track A, `change_dataset()`, then B. tpuslam
    runs in a process of its own (tests/torch_child.py) with its young
    map's two-view init held to the port's repair (tpuslam's initial BA
    solves every map's points: tests/test_torch_mono_merge_replay.py shows
    it). On every frame before the merge: the same state, map ids and
    keyframe count, poses within 1 cm and 0.2 degrees in each map's own
    units (tests/test_torch_system.py's tolerances). The merge: on the same
    frame, between the same current and candidate keyframes, with Sim3
    scales within 1 % and more than 10 % from 1.
  * The port's gates after the whole route: exactly one merge (maps 2 ->
    1), OK at the end, nothing left in the young map, every frame after the
    merge OK, one Sim3 alignment of both sessions' rows with a scaled ATE
    under tests/test_e2e_mono.py's 0.10, and the two sessions' Horn scales,
    each aligned alone, within 5 % of each other: B was brought to A's
    scale.
  * The control: the port without a vocabulary ends with 2 maps, OK, a
    joint scaled ATE over the gate, and the two sessions' Horn scales
    further apart than the 5 % the merged run must meet (1.061: a
    session's Horn scale averages its map's scale over all its frames, the
    Sim3 at the merge measures the two maps at B's third keyframe).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.engine.tracking as j_tracking
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.place import load_orbvoc as j_load_orbvoc
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.ops import twoview
from tpuslam_torch.solve import sim3 as t_sim3

import torch_child
from torch_mono_merge import (ATE_GATE, MAX_KF_FRAMES, N_A, N_B, N_FEATURES, SCALE_AGREE,
                              SCALE_RATIO, camera_of, drive, init_ba_on_its_points,
                              port_system, room, session_gates, vocabulary)

torch.set_num_threads(2)
POS_TOL, ROT_TOL = 0.01, 0.2       # tests/test_torch_system.py's
SIM3_SCALE_TOL = 0.01


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _tpuslam_to_the_merge(voc):
    """tpuslam's MONOCULAR System over A, change_dataset(), then B up to
    the frame of its merge (in a process of its own)."""
    seq, frames, sessions = room()
    cam, w, h = camera_of(seq)
    slam = JSystem(JPinhole(cam, w, h),
                   JSlamConfig(orb=JOrbConfig(n_features=N_FEATURES),
                               tracking=JTrackingConfig(max_frames_between_kf=MAX_KF_FRAMES),
                               loop=JLoopConfig(background_gba=False)),
                   sensor=JSensor.MONOCULAR, vocab=j_load_orbvoc(voc))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_tracking.Tracker, "_initial_ba",
                   init_ba_on_its_points(j_tracking.Tracker._initial_ba))
        rows, merges = drive(slam, frames, sessions, stop_after_merge=True)
    return rows, merges


class _Draws:
    """tpuslam's RANSAC samples for the port: the two-view init's
    PRNGKey(0) choice per attempt, and the loop closer's PRNGKey(7) split
    once per Sim3 try."""

    def __init__(self):
        self.key = jax.random.PRNGKey(7)

    def twoview(self, valid, generator=None, n_hyp=twoview.N_HYP):
        p = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid, np.float32)
        key = jax.random.PRNGKey(generator.initial_seed() if generator is not None else 0)
        return torch.as_tensor(np.asarray(jax.random.choice(
            key, len(p), shape=(n_hyp, 8), p=jnp.asarray(p / max(p.sum(), 1.0)))))

    def sim3(self, n_valid, n_hyp, generator=None):
        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))


@pytest.fixture(scope="module")
def the_room(tmp_path_factory):
    seq, frames, sessions = room()
    voc = vocabulary(seq, frames, str(tmp_path_factory.mktemp("voc") / "voc.txt"))
    return seq, frames, sessions, voc


def _port_without_a_vocabulary():
    """The control: the port's run of both sessions with no vocabulary (in
    a process of its own)."""
    seq, frames, sessions = room()
    slam = port_system(seq)
    rows, _ = drive(slam, frames, sessions)
    return rows[-1], session_gates(sessions, slam.trajectory_tum())


@pytest.fixture(scope="module")
def lockstep(the_room):
    """tpuslam's run to its merge and the port's control (each in a process
    of its own, tests/torch_child.py) beside the port's whole route, the
    port handed tpuslam's draws."""
    seq, frames, sessions, voc = the_room
    jax_side = torch_child.start(_tpuslam_to_the_merge, voc)
    control = torch_child.start(_port_without_a_vocabulary)
    draws = _Draws()
    slam = port_system(seq, voc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twoview, "draw_samples", draws.twoview)
        mp.setattr(t_sim3, "draw_samples", draws.sim3)
        rows, merges = drive(slam, frames, sessions)
    return dict(port=(slam, rows, merges), tpuslam=jax_side.result(), control=control.result())


def test_lockstep_to_the_merge_decision(lockstep):
    _, rows, merges = lockstep["port"]
    j_rows, j_merges = lockstep["tpuslam"]
    assert len(merges) >= 1 and len(j_merges) == 1, (merges, j_merges)
    (n, kf, cand, s), (jn, jkf, jcand, js) = merges[0], j_merges[0]
    print(f"merge: port frame {n} kf {kf} onto {cand}, Sim3 scale {s:.5f}; "
          f"tpuslam frame {jn} kf {jkf} onto {jcand}, scale {js:.5f}")
    assert (n, kf, cand) == (jn, jkf, jcand)
    assert N_A < n and abs(s / js - 1.0) < SIM3_SCALE_TOL
    assert min(s, js) > SCALE_RATIO
    assert len(j_rows) == n + 1
    for a, b in zip(rows[:n], j_rows[:n]):
        where = a[:2]
        assert a[4:] == b[4:], (where, a[4:], b[4:])      # state, map ids, keyframes
        assert (a[3] is None) == (b[3] is None), where
        if a[3] is not None:
            assert np.linalg.norm(a[3][:3, 3] - b[3][:3, 3]) < POS_TOL, where
            assert _rot_deg(a[3][:3, :3], b[3][:3, :3]) < ROT_TOL, where


def test_one_merge_and_the_joint_gates(lockstep, the_room):
    sessions = the_room[2]
    slam, rows, merges = lockstep["port"]
    assert len(merges) == 1, merges
    (n, _, _, s), = merges
    maps = [r[5] for r in rows]
    # A's map, then B's map opened by its two-view init, merged on frame n
    assert all(mp in ([], [0]) for mp in maps[:N_A]) and n > N_A
    assert all(mp in ([0], [0, 1]) for mp in maps[N_A:n]) and maps[n - 1] == [0, 1]
    assert all(mp == [0] for mp in maps[n:])
    # every frame from the merge on is tracked: none lost or relocalized
    assert [r[4] for r in rows[n:]] == [State.OK.name] * (N_A + N_B - n)
    assert slam.get_tracking_state() == State.OK
    m, tr = slam.map, slam.tracker
    assert m.map_ids() == [0] and m.current_map_id == 0 and m.n_maps_created == 2
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    assert all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
    assert all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf))
    gates = session_gates(sessions, slam.trajectory_tum())
    print(f"merge on frame {n} (B's {n - N_A}), Sim3 scale {s:.5f}: {gates}")
    assert gates["ate"] < ATE_GATE
    sa, sb = gates["scales"]
    assert abs(sb / sa - 1.0) < SCALE_AGREE, gates


def test_without_a_vocabulary_the_maps_keep_their_scales(lockstep):
    last, gates = lockstep["control"]
    assert last[5] == [0, 1] and last[4] == State.OK.name
    print(f"without a vocabulary: {gates}")
    sa, sb = gates["scales"]
    assert abs(sa / sb - 1.0) > SCALE_AGREE, gates
    assert gates["ate"] > ATE_GATE
