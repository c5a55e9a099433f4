"""The port's stereo-inertial System against tpuslam's, on the CPU.

tpuslam's IMU_STEREO System and the port's track the same frames of the
heave sequence (tests/torch_vi_heave.py: 376x240, 600 features, 10 fps,
baseline 0.1 m, IMU at 200 Hz, a keyframe at least every 3 frames) for 30
frames: the stereo init on the gate, the host path until the mapper
initializes the IMU (about frame 27, its 10th keyframe), then the fused
visual-inertial step. Both Systems get the same numpy images and IMU
arrays.

  * On every frame the tracking state is equal.
  * The stereo init happens on the same frame, by frame 3.
  * Until the IMU init: the same keyframe count, poses within 1 cm and
    0.2 degrees (tests/test_torch_vi_system.py's tolerances).
  * The IMU initializes within 1 frame in both Systems; afterwards both
    maps are gravity-aligned (|R[2, 2]| > 0.99), both Horn scales within
    3 % of 1 and of each other, and the mappers record the same IMU events.
"""

import numpy as np
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.eval.ate import horn_align
from tpuslam_torch.imu.preintegration import ImuCalib

from test_torch_vi_system import NOISE, _gt_centers, _imu, _rot_deg
from torch_vi_heave import heave_sequence

torch.set_num_threads(2)
N_FRAMES = 30


def test_slice_matches_tpuslam_stereo_inertial_system():
    seq = heave_sequence(n_frames=N_FRAMES, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1)
    cam, bf = [seq.fx, seq.fy, seq.cx, seq.cy], seq.fx * seq.baseline
    js = JSystem(JPinhole(cam, seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=600),
                             tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=JSensor.IMU_STEREO, imu_calib=JImuCalib(**NOISE), bf=bf)
    ts = System(Pinhole(cam, seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=600),
                           tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE), bf=bf,
                dtype=torch.float64, device="cpu")
    times = seq.timestamps()
    ok_at, init_at = {}, {}
    for i in range(N_FRAMES):
        left, right, imu = seq.frame(i), seq.frame(i, right=True), _imu(seq, times, i)
        Tj = js.track_stereo(left, right, times[i], imu=imu)
        Tt = ts.track_stereo(left, right, times[i], imu=imu)
        assert ts.get_tracking_state().name == js.get_tracking_state().name, i
        assert (Tt is None) == (Tj is None), i
        for name, slam in (("jax", js), ("port", ts)):
            if slam.get_tracking_state().name == "OK":
                ok_at.setdefault(name, i)
            if slam.map.imu_initialized:
                init_at.setdefault(name, i)
        if not init_at:
            assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
    assert ok_at["port"] == ok_at["jax"] <= 3, ok_at
    assert set(init_at) == {"jax", "port"}, init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 1, init_at
    assert max(init_at.values()) < N_FRAMES - 1, init_at   # a few fused VI frames ran
    scales = []
    for slam in (js, ts):
        traj = slam.trajectory_tum()
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(seq, traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.03, (R, s)
        scales.append(s)
    assert abs(scales[1] / scales[0] - 1.0) < 0.03, scales
    ev_j, ev_t = js.local_mapper.debug_events, ts.local_mapper.debug_events
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j]
    assert ev_t[0]["event"] == "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]
