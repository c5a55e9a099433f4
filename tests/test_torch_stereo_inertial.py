"""The port's stereo-inertial System against tpuslam's, on the CPU.

tpuslam's IMU_STEREO System and the port's track the same frames of the
heave sequence (tests/torch_vi_heave.py: 376x240, 600 features, 10 fps,
baseline 0.1 m, IMU at 200 Hz, a keyframe at least every 3 frames) for 30
frames: the stereo init on the gate, the host path until the mapper
initializes the IMU (about frame 27, its 10th keyframe), then the fused
visual-inertial step. Both Systems get the same numpy images and IMU
arrays; tpuslam's run is read from its record (tests/torch_records.py,
written by tests/make_tpuslam_records.py) and compared frame by frame.

  * On every frame the tracking state is equal.
  * The stereo init happens on the same frame, by frame 3.
  * Until the IMU init: the same keyframe count, poses within 1 cm and
    0.2 degrees (tests/test_torch_vi_system.py's tolerances).
  * The IMU initializes within 1 frame in both Systems; afterwards both
    maps are gravity-aligned (|R[2, 2]| > 0.99), both Horn scales within
    3 % of 1 and of each other, and the mappers record the same IMU events.
"""

import numpy as np
import pytest
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
import torch_records

torch.set_num_threads(2)
N_FRAMES = 30


def _sequence():
    return heave_sequence(n_frames=N_FRAMES, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1)


def _run(slam, seq):
    """Drive one System: per frame its pose, state, keyframe count and IMU
    flag, then its trajectory and its mapper's IMU events."""
    times = seq.timestamps()
    rows = []
    for i in range(N_FRAMES):
        T = slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                              imu=_imu(seq, times, i))
        rows.append((T, slam.get_tracking_state().name, len(slam.map.valid_kf_ids()),
                     slam.map.imu_initialized))
    return dict(rows=rows, traj=slam.trajectory_tum(),
                events=list(slam.local_mapper.debug_events))


def _tpuslam_slice():
    """tpuslam's IMU_STEREO System over the slice (its record's run)."""
    seq = _sequence()
    js = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=600),
                             tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=JSensor.IMU_STEREO, imu_calib=JImuCalib(**NOISE),
                 bf=seq.fx * seq.baseline)
    return _run(js, seq)


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        _sequence(), N_FRAMES, right=True)}


@pytest.fixture(scope="module")
def slice_runs():
    """tpuslam's recorded run (tests/torch_records.py) and the port's;
    compared frame by frame afterwards (neither System reads the other)."""
    jax_side = torch_records.recorded("stereo_inertial", _record_inputs())
    seq = _sequence()
    ts = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=600),
                           tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE),
                bf=seq.fx * seq.baseline, dtype=torch.float64, device="cpu")
    port = _run(ts, seq)
    return seq, {"jax": jax_side.result(), "port": port}


def _first(rows, what):
    return next((i for i, r in enumerate(rows) if what(r)), None)


def test_slice_matches_tpuslam_stereo_inertial_system(slice_runs):
    _, runs = slice_runs
    rows_j, rows_t = runs["jax"]["rows"], runs["port"]["rows"]
    init = min(i for i in (_first(rows_j, lambda r: r[3]), _first(rows_t, lambda r: r[3]),
                           N_FRAMES) if i is not None)
    for i, ((Tj, state_j, n_kf_j, _), (Tt, state_t, n_kf_t, _)) in enumerate(zip(rows_j,
                                                                                 rows_t)):
        assert state_t == state_j, i
        assert (Tt is None) == (Tj is None), i
        if i < init:
            assert n_kf_t == n_kf_j, i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i


def test_the_stereo_and_imu_inits_agree(slice_runs):
    _, runs = slice_runs
    ok_at = {n: _first(r["rows"], lambda x: x[1] == "OK") for n, r in runs.items()}
    init_at = {n: _first(r["rows"], lambda x: x[3]) for n, r in runs.items()}
    assert ok_at["port"] == ok_at["jax"] <= 3, ok_at
    assert None not in init_at.values(), init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 1, init_at
    assert max(init_at.values()) < N_FRAMES - 1, init_at   # a few fused VI frames ran


def test_both_maps_are_metric_and_gravity_aligned(slice_runs):
    seq, runs = slice_runs
    scales = []
    for name in ("jax", "port"):
        traj = runs[name]["traj"]
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(seq, traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.03, (R, s)
        scales.append(s)
    assert abs(scales[1] / scales[0] - 1.0) < 0.03, scales


def test_the_mappers_record_the_same_imu_events(slice_runs):
    _, runs = slice_runs
    ev_j, ev_t = runs["jax"]["events"], runs["port"]["events"]
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j]
    assert ev_t[0]["event"] == "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]
