"""The async-mapping handshake of the inertial tracker against tpuslam's,
deterministic and without a thread.

With async mapping, the mapper thread initializes the IMU and runs the
visual-inertial BAs while the tracker goes on; each of them bumps the map's
`map_version`. Before tracking the next frame the tracker calls
`_sync_imu_from_map` (ref Tracking::UpdateFrameIMU, Tracking.cc:2993): it
takes the last keyframe's biases, drops its marginalization prior, and
rebases the last frame by IMU-predicting it from the last keyframe's new
state. Here both packages' trackers sit on the same initialized map
(tests/test_engine_vi.py::_build_map, 8 keyframes, IMU at 400 Hz), the map
is rescaled and rotated as the IMU init does (`apply_scaled_rotation`),
and both handshakes must agree: biases, the cleared prior, the last
frame's pose and velocity; for a mono and a stereo tracker, with the last
frame after the last keyframe (the IMU-predicted rebase) and on it.
"""

import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.tracking import Frame as JFrame
from tpuslam.engine.tracking import Tracker as JTracker
from tpuslam.io.synthetic import SyntheticSequence as JSyntheticSequence
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import SlamConfig
from tpuslam_torch.engine.tracking import Frame, Tracker

from test_engine_vi import CX, CY, FX, FY
from test_torch_vi_engine import _pair

torch.set_num_threads(2)


def _tilt_yaw(tilt, yaw):
    """Rx(tilt) @ Rz(yaw): a gravity alignment that also turns the world."""
    c, s = np.cos(tilt), np.sin(tilt)
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    c, s = np.cos(yaw), np.sin(yaw)
    return Rx @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("after_kf", [True, False], ids=["after_kf", "on_kf"])
@pytest.mark.parametrize("sensor", ["mono", "stereo"])
def test_sync_imu_from_map_matches_tpuslam(sensor, after_kf):
    jm, tm_, jcalib, calib, kfs = _pair()
    # the raw samples the tracker holds since the keyframe before the last
    seq = JSyntheticSequence(n_frames=8, fps=4.0, imu_rate=400.0)
    times = seq.timestamps()
    kf = kfs[-1]
    t_last = times[-1] + (0.1 if after_kf else 0.0)
    samples = np.column_stack(seq.imu_between(times[-2], t_last)).tolist()
    Rcw, tcw = seq.gt_pose_cw(t_last)
    bf = FX * 0.1 if sensor == "stereo" else 0.0
    trackers = (
        JTracker(JPinhole([FX, FY, CX, CY], 400, 400), JSlamConfig(), jm, sensor=sensor,
                 imu_calib=jcalib, bf=bf),
        Tracker(Pinhole([FX, FY, CX, CY], 400, 400), SlamConfig(), tm_, sensor=sensor,
                imu_calib=calib, bf=bf, device="cpu", dtype=torch.float64))
    for tr, m, frame_cls in zip(trackers, (jm, tm_), (JFrame, Frame)):
        m.imu_initialized = True
        m.kf_bg[kf] = [1e-3, -2e-3, 5e-4]
        m.kf_ba[kf] = [2e-2, 1e-2, -3e-2]
        tr.last_kf = kf
        tr.imu_since_kf = [list(r) for r in samples]
        tr.last_frame = frame_cls(None, t_last, 99, R=Rcw.copy(), t=tcw.copy(),
                                  v=seq.traj.vel(t_last))
        tr.bg, tr.ba = np.full(3, 0.5), np.full(3, -0.5)
        tr.prior = dict(H=np.eye(15))
        tr.map_version_seen = m.map_version
        # the mapper's IMU init: gravity-align and rescale the world
        m.apply_scaled_rotation(_tilt_yaw(0.15, 0.3), 1.7)
        tr._sync_imu_from_map()
    jt, tt = trackers
    for tr in trackers:
        assert tr.prior is None
        np.testing.assert_array_equal(tr.bg, [1e-3, -2e-3, 5e-4])
        np.testing.assert_array_equal(tr.ba, [2e-2, 1e-2, -3e-2])
    jl, tl = jt.last_frame, tt.last_frame
    np.testing.assert_allclose(tl.R, jl.R, atol=1e-9)
    np.testing.assert_allclose(tl.t, jl.t, atol=1e-6)
    np.testing.assert_allclose(tl.v, jl.v, atol=1e-6)
    # the rebase moved the last frame into the rescaled world
    assert np.linalg.norm(tl.t - tcw) > 0.1
    if not after_kf:
        np.testing.assert_array_equal(tl.R, tm_.kf_R[kf])
        np.testing.assert_array_equal(tl.v, tm_.kf_vel[kf])
    # with the map unchanged since the last solve the handshake does nothing
    for tr in trackers:
        tr.bg = np.zeros(3)
        tr.map_version_seen = (jm if tr is jt else tm_).map_version
        tr._sync_imu_from_map()
        assert not tr.bg.any()
