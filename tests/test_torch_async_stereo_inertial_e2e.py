"""The port's stereo-inertial System with the mapper on its own thread,
with real concurrency, on the CPU.

tests/test_torch_stereo_inertial_e2e.py's run (40 frames of the heave
sequence of tests/torch_vi_heave.py, 376x240, 600 features, baseline 0.1 m,
IMU at 200 Hz, f32 solvers as on the card) with `async_mapping=True`, under
tests/test_async_mapping.py's bounded back-pressure (tests/torch_async.py's
`paced`). Only the state after `flush()` is asserted, not quality while the
mapper races (tpuslam's tests/test_async_mapping.py::test_async_mono_quality
asserts on a race): the IMU initialized on the worker thread, at least one
handshake rebased the last frame, OK at the end and no worker error. The
same route serialized and held against tpuslam is
tests/test_torch_async_stereo_inertial.py.
"""

import pytest
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.imu.preintegration import ImuCalib

from test_torch_vi_system import NOISE, _imu
from torch_async import count_rebases, paced
from torch_vi_heave import heave_sequence

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """The port's async run, flushed and shut down, with its handshake
    rebases."""
    seq = heave_sequence(n_frames=40, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1)
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=600),
                             tracking=TrackingConfig(max_frames_between_kf=3)),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE),
                  bf=seq.fx * seq.baseline, async_mapping=True, device="cpu")
    rebases = count_rebases(slam.tracker)
    times = seq.timestamps()
    for i in range(seq.n_frames):
        paced(slam)
        slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                          imu=_imu(seq, times, i))
    slam.async_mapper.flush()          # raises a worker error
    slam.shutdown()
    return slam, rebases


def test_port_async_stereo_inertial_state_after_flush(run):
    slam, _ = run
    assert slam.async_mapper.errors == [] and not slam.async_mapper.worker.is_alive()
    assert slam.get_tracking_state().name == "OK"


def test_the_imu_initializes_on_the_mapping_thread(run):
    slam, _ = run
    assert slam.map.imu_initialized
    assert slam.local_mapper.debug_events[0]["event"] == "imu_init"


def test_the_handshake_rebased_the_last_frame(run):
    assert run[1][0] >= 1
