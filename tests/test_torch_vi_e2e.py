"""The port's mono-inertial System alone against the gates of
tests/test_e2e_mono_inertial.py, on the CPU: its 55 frames (vi_excite,
376x240, 600 features, IMU at 200 Hz, f32 solvers as on the card) must
end with the IMU initialized, state OK, a Horn scale within 0.4 of 1, a
scaled ATE < 6 cm, a gravity-aligned world (|R[2, 2]| > 0.99) and a median
keyframe-velocity error < 0.2 m/s; the host tracking path ran before the
init and the fused visual-inertial step after it.
"""

import numpy as np
import pytest
import torch

from tpuslam.eval.ate import ate_rmse, horn_align
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.utils.timing import GLOBAL_TIMER

from test_torch_vi_system import NOISE, _gt_centers, _imu

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """tests/test_e2e_mono_inertial.py's run on the port alone, with the
    tracker's stage samples."""
    seq = SyntheticSequence(n_frames=55, fps=10, speed=0.5, imu_rate=200.0, kind="vi_excite")
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=600),
                             tracking=TrackingConfig(max_frames_between_kf=3)),
                  sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(**NOISE), device="cpu")
    GLOBAL_TIMER.samples.clear()
    times = seq.timestamps()
    for i in range(seq.n_frames):
        slam.track_monocular(seq.frame(i), times[i], imu=_imu(seq, times, i))
    slam.shutdown()
    samples = {k: len(GLOBAL_TIMER.samples.get(k, []))
               for k in ("track_fused_vi", "track", "imu_stage")}
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    return seq, slam, samples, est, _gt_centers(seq, traj)


def test_port_mono_inertial_gates(run):
    """tests/test_e2e_mono_inertial.py's run and gates on the port alone."""
    seq, slam, _, est, gt = run
    assert slam.map.imu_initialized
    assert slam.get_tracking_state() == State.OK
    rmse, scale = ate_rmse(est, gt, with_scale=True)
    assert abs(scale - 1.0) < 0.4, scale
    assert rmse < 0.06, rmse
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    assert abs(R[2, 2]) > 0.99, R


def test_keyframe_velocities(run):
    seq, slam, _, est, gt = run
    m = slam.map
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    errs = [np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
            for k in m.valid_kf_ids()]
    assert np.median(errs) < 0.2, np.median(errs)


def test_both_tracking_paths_ran(run):
    """The host path before the init, the fused visual-inertial step after
    it."""
    samples = run[2]
    assert samples["track_fused_vi"] >= 10
    assert samples["track"] >= 10
    assert samples["imu_stage"] > 0
