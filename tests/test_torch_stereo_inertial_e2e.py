"""The port's stereo-inertial System alone, on the CPU.

  * The heave sequence (tests/torch_vi_heave.py) passes the stereo-inertial
    init gate (std |a| >= 0.25 m/s^2 over the raw samples) by frame 3, at
    10 fps and at 20 fps, where the renderer's own kinds never do
    (tests/test_torch_vi_engine.py).
  * 40 frames of it (376x240, 600 features, baseline 0.1 m, IMU at
    200 Hz, f32 solvers as on the card) must end OK with the IMU
    initialized, an unscaled ATE < 5 cm, a Horn scale within 3 % of 1, a
    gravity-aligned world (|R[2, 2]| > 0.99) and a median keyframe-velocity
    error < 0.2 m/s; the host path ran before the IMU init and the fused
    visual-inertial step after it.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import ate_rmse, horn_align
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.utils.timing import GLOBAL_TIMER

from test_torch_vi_system import NOISE, _gt_centers, _imu
from torch_vi_heave import heave_sequence

torch.set_num_threads(2)
GATE_STD = 0.25   # m/s^2, the tracker's stereo-inertial init gate


def _gate_frame(seq):
    """The first frame at which the samples since the start clear the gate
    (at least 10 of them, std |a| >= GATE_STD), as the tracker reads them."""
    times = seq.timestamps()
    acc = []
    for i in range(1, seq.n_frames):
        acc.extend(seq.imu_between(times[i - 1], times[i])[2])
        if len(acc) >= 10 and np.std(np.linalg.norm(acc, axis=1)) >= GATE_STD:
            return i
    return None


@pytest.mark.parametrize("fps", [10, 20])
def test_heave_sequence_passes_the_stereo_inertial_gate(fps):
    seq = heave_sequence(n_frames=8, fps=fps, speed=0.5, imu_rate=200.0)
    assert _gate_frame(seq) <= 3
    # over the 5.5 s of the longest run (chip_smoke.py) the camera keeps
    # well inside the 4 m room
    z = seq.traj.pos(np.linspace(0.0, 5.5, 551))[:, 2]
    assert 2.1 < z.min() and z.max() < 2.45
    # the heave's derivatives are the closed forms of its position
    t = np.linspace(0.3, 5.0, 9)
    h = 1e-5
    assert np.allclose((seq.traj.pos(t + h) - seq.traj.pos(t - h)) / (2 * h), seq.traj.vel(t),
                       atol=1e-6)
    assert np.allclose((seq.traj.vel(t + h) - seq.traj.vel(t - h)) / (2 * h), seq.traj.acc(t),
                       atol=1e-5)


def test_port_stereo_inertial_gates():
    seq = heave_sequence(n_frames=40, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1)
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=600),
                             tracking=TrackingConfig(max_frames_between_kf=3)),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE),
                  bf=seq.fx * seq.baseline, device="cpu")
    GLOBAL_TIMER.samples.clear()
    times = seq.timestamps()
    init_at = None
    for i in range(seq.n_frames):
        slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                          imu=_imu(seq, times, i))
        if init_at is None and slam.map.imu_initialized:
            init_at = i
            n_fused_at_init = len(GLOBAL_TIMER.samples.get("track_fused_vi", []))
    slam.shutdown()
    m = slam.map
    assert m.imu_initialized and init_at is not None
    assert slam.get_tracking_state() == State.OK
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = _gt_centers(seq, traj)
    assert ate_rmse(est, gt)[0] < 0.05
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.03, s
    assert abs(R[2, 2]) > 0.99, R
    errs = [np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
            for k in m.valid_kf_ids()]
    assert np.median(errs) < 0.2, np.median(errs)
    # the host path before the IMU init, the fused visual-inertial step after
    assert len(GLOBAL_TIMER.samples.get("track", [])) >= 10
    assert len(GLOBAL_TIMER.samples["track_fused_vi"]) - n_fused_at_init >= 5
