"""The port's monocular System with a vocabulary on the CPU: the loop run
of tests/test_e2e_loop.py (a 92-frame circle at 376x240, 800 features,
the test's tracking and loop thresholds, a vocabulary trained with the
port's train_vocabulary on frames of the same room), BoW relocalization,
and the async mapper with a loop closer.

Gates (tests/test_e2e_loop.py): final state OK, at least one loop closed,
one map after shutdown, scaled ATE under 5 % of the circumference, map
invariants; the spanning tree intact. Relocalization: an unseen
second-lap frame found by BoW + PnP on a first-lap keyframe, within 20 cm
and 3 degrees of ground truth after the scaled alignment. Async:
only the state after flush() is asserted, never quality during the race.
"""

import numpy as np
import pytest
import torch

from tpuslam.eval.ate import ate_rmse, horn_align
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.frontend import Frontend
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import Frame, State
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.place import train_vocabulary

torch.set_num_threads(2)


def _setup(n_frames=92):
    seq = SyntheticSequence(n_frames=n_frames, fps=8, speed=1.0, kind="loop")
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    cfg = SlamConfig(orb=OrbConfig(n_features=800),
                     tracking=TrackingConfig(max_frames_between_kf=4, min_matches_init=60,
                                             motion_model_radius=25.0, time_recently_lost=2.0),
                     loop=LoopConfig(min_proj_matches=35, min_bow_matches=15))
    fe = Frontend(cam, cfg.orb, device="cpu")
    descs = []
    for i in (0, 10, 20, 30):
        f = fe.process(seq.frame(i))
        descs.append(f.bits[f.valid])
    return seq, cam, cfg, fe, train_vocabulary(np.concatenate(descs), k=8, L=3, iters=5,
                                          device="cpu")


@pytest.fixture(scope="module")
def loop_run():
    seq, cam, cfg, fe, vocab = _setup()
    slam = System(cam, cfg, sensor=Sensor.MONOCULAR, vocab=vocab, device="cpu")
    for i, t in enumerate(seq.timestamps()):
        slam.track_monocular(seq.frame(i), t)
    slam.shutdown()
    return seq, slam, fe


def test_loop_closed(loop_run):
    _, slam, _ = loop_run
    assert slam.get_tracking_state() == State.OK
    assert slam.loop_closer.n_loops_closed >= 1
    assert len(slam.map.map_ids()) == 1
    assert slam.map.check_essential_graph() == []


def test_trajectory_after_loop(loop_run):
    seq, slam, _ = loop_run
    traj = slam.trajectory_tum()
    assert len(traj) >= seq.n_frames - 10
    est = np.array([r[1:4] for r in traj])
    gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.05 * 2 * np.pi * 1.6, rmse


def test_map_consistent_after_loop(loop_run):
    _, slam, _ = loop_run
    m = slam.map
    for j in m.valid_mp_ids():
        for kf, slot in m.mp_obs[int(j)].items():
            assert m.kf_mp[kf, slot] == j and m.kf_valid[kf]
    for k in m.valid_kf_ids():
        for s in np.nonzero(m.kf_mp[k] >= 0)[0]:
            j = int(m.kf_mp[k, s])
            assert m.mp_valid[j] and m.mp_obs[j].get(int(k)) == s
    assert set(slam.loop_closer.db.kf_bow) <= set(int(k) for k in m.valid_kf_ids())


def test_bow_relocalization(loop_run):
    """A second-lap frame the System never saw (5 s past the run's end,
    rendered afresh) relocalizes through the BoW candidates + PnP RANSAC +
    pose LM (no reference-KF neighbourhood) on a keyframe of the first
    lap, within 20 cm and 3 degrees of ground truth after the run's
    trajectory is Sim3-aligned onto it (mono map units are arbitrary; the
    trajectory's own scaled ATE is ~5 cm here)."""
    seq, slam, fe = loop_run
    tr, m = slam.tracker, slam.map
    lap_s = 2 * np.pi * 1.6 / seq.traj.speed
    i = seq.n_frames + 40
    t = i / seq.fps
    frame = Frame(fe.process(seq.frame(i)), t, 10_000 + i)
    assert tr._relocalize_bow(frame)
    assert tr.n_inliers >= 15 and m.kf_valid[tr.ref_kf] and m.kf_time[tr.ref_kf] < lap_s
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
    R, tt, s, _ = horn_align(est, gt, with_scale=True)
    Rcw, tcw = seq.gt_pose_cw(t)
    c = s * R @ (-frame.R.T @ frame.t) + tt
    assert np.linalg.norm(c - (-Rcw.T @ tcw)) < 0.20
    Rwc = R @ frame.R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(Rwc @ Rcw) - 1) / 2, -1, 1)))
    assert ang < 3.0, ang


def test_async_mapper_with_loop_closer_state_after_flush():
    seq, cam, cfg, _, vocab = _setup(n_frames=24)
    slam = System(cam, cfg, sensor=Sensor.MONOCULAR, vocab=vocab, async_mapping=True,
                  device="cpu")
    assert slam.async_mapper.loop_closer is slam.loop_closer
    assert slam.tracker.loop_closer is None          # the worker runs it
    for i, t in enumerate(seq.timestamps()):
        slam.track_monocular(seq.frame(i), t)
    slam.async_mapper.flush()                        # raises a worker error
    slam.shutdown()
    # only what flush() makes deterministic: the tracking state and the map's
    # size race with the mapper thread (a run under load has ended
    # RECENTLY_LOST), the worker's outcome and the map's invariants do not
    assert slam.async_mapper.errors == []
    assert not slam.async_mapper.worker.is_alive()
    m = slam.map
    for j in m.valid_mp_ids():
        for kf, slot in m.mp_obs[int(j)].items():
            assert m.kf_mp[kf, slot] == j and m.kf_valid[kf]
    for k in m.valid_kf_ids():
        for s in np.nonzero(m.kf_mp[k] >= 0)[0]:
            j = int(m.kf_mp[k, s])
            assert m.mp_valid[j] and m.mp_obs[j].get(int(k)) == s
    # every live keyframe went through the closer (a keyframe culled while
    # still queued is transformed too, as in tpuslam; candidates skip it)
    assert slam.loop_closer.kf_bow
    assert set(int(k) for k in m.valid_kf_ids()) <= set(slam.loop_closer.kf_bow)
    assert m.check_essential_graph() == []
