"""The port's mono-inertial System against tpuslam's, on the CPU.

  * The slice: tpuslam's IMU_MONOCULAR System and the port's on the same
    rendered frames and IMU samples (vi_excite, 376x240, 600 features,
    IMU at 200 Hz, a keyframe at least every 3 frames) until a few frames
    past IMU initialization. The port's two-view draw is tpuslam's own.
    Per frame the tracking state must be equal; for the first 22 frames
    also the keyframe count, the imu_initialized flag and the poses (within
    1 cm / 0.2 degrees). Both must initialize the IMU within 2 frames of
    each other, and after it both maps are gravity-aligned and metric,
    their Horn scales within 10 % of each other (a young scale estimate:
    1.30 and 1.22 on this run), and both mappers record the same IMU-init
    events (the imu_events of System.save_debug_data).
tpuslam's run is read from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py, which checks its inputs' fingerprints) and compared
with the port's frame by frame.
The port alone against the test's gates: tests/test_torch_vi_e2e.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.eval.ate import horn_align
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.ops import twoview

import torch_records

torch.set_num_threads(2)
# the slice: both Systems in lockstep (same keyframes, poses within 1 cm)
# up to LOCKSTEP; past it a keyframe decision on a borderline inlier count
# can differ (f64 rounding of the two BAs), so from there the run is held
# to the same IMU init (within 2 frames) and the same metric scale
N_SLICE, LOCKSTEP, SCALE_AGREE = 32, 22, 0.1
NOISE = dict(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5, freq=200.0)


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def jax_draw(valid, generator=None, n_hyp=twoview.N_HYP):
    """tpuslam's PRNGKey(seed) choice of two-view samples."""
    p = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid, np.float32)
    key = jax.random.PRNGKey(generator.initial_seed() if generator is not None else 0)
    return torch.as_tensor(np.asarray(jax.random.choice(
        key, len(p), shape=(n_hyp, 8), p=jnp.asarray(p / max(p.sum(), 1.0)))))


@pytest.fixture
def jax_init_draw(monkeypatch):
    """The port's two-view samples = tpuslam's PRNGKey(seed) choice."""
    monkeypatch.setattr(twoview, "draw_samples", jax_draw)


def _imu(seq, times, i):
    if i == 0:
        return None
    return np.column_stack(seq.imu_between(times[i - 1], times[i]))


def _gt_centers(seq, traj):
    return np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])


def _slice_sequence():
    return SyntheticSequence(n_frames=N_SLICE, fps=10, speed=0.5, imu_rate=200.0,
                             kind="vi_excite")


def _run(slam, seq):
    """Drive one System over the slice: per frame its pose, state, keyframe
    count and IMU flag, then its trajectory and its mapper's IMU events."""
    times = seq.timestamps()
    rows = []
    for i in range(seq.n_frames):
        T = slam.track_monocular(seq.frame(i), times[i], imu=_imu(seq, times, i))
        rows.append((T, slam.get_tracking_state().name, len(slam.map.valid_kf_ids()),
                     slam.map.imu_initialized))
    return dict(rows=rows, traj=slam.trajectory_tum(),
                events=list(slam.local_mapper.debug_events))


def _tpuslam_slice():
    """tpuslam's IMU_MONOCULAR System over the slice (its record's run)."""
    seq = _slice_sequence()
    js = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=600),
                             tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=JSensor.IMU_MONOCULAR, imu_calib=JImuCalib(**NOISE))
    return _run(js, seq)


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        _slice_sequence(), N_SLICE)}


@pytest.fixture(scope="module")
def slice_runs():
    """tpuslam's recorded run (tests/torch_records.py) and the port's, whose
    two-view draw is tpuslam's own; compared frame by frame afterwards
    (neither System reads the other)."""
    jax_side = torch_records.recorded("vi_system", _record_inputs())
    seq = _slice_sequence()
    ts = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=600),
                           tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(**NOISE),
                dtype=torch.float64, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twoview, "draw_samples", jax_draw)
        port = _run(ts, seq)
    return seq, {"jax": jax_side.result(), "port": port}


def test_slice_matches_tpuslam_mono_inertial_system(slice_runs):
    _, runs = slice_runs
    for i, (j, t) in enumerate(zip(runs["jax"]["rows"], runs["port"]["rows"])):
        (Tj, state_j, n_kf_j, init_j), (Tt, state_t, n_kf_t, init_t) = j, t
        assert state_t == state_j, i
        assert (Tt is None) == (Tj is None), i
        if i < LOCKSTEP:
            assert n_kf_t == n_kf_j, i
            assert init_t == init_j, i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i


def test_the_imu_initializes_within_two_frames(slice_runs):
    _, runs = slice_runs
    init_at = {name: next((i for i, r in enumerate(run["rows"]) if r[3]), None)
               for name, run in runs.items()}
    assert None not in init_at.values(), init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 2, init_at


def test_both_maps_are_metric_and_gravity_aligned(slice_runs):
    seq, runs = slice_runs
    scales = []
    for name in ("jax", "port"):
        traj = runs[name]["traj"]
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(seq, traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.4, (R, s)
        scales.append(s)
    assert abs(scales[1] / scales[0] - 1.0) < SCALE_AGREE, scales


def test_the_mappers_record_the_same_imu_events(slice_runs):
    """The mappers' debug records (System.save_debug_data's imu_events)."""
    _, runs = slice_runs
    ev_j, ev_t = runs["jax"]["events"], runs["port"]["events"]
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j] and ev_t[0]["event"] == \
        "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]
