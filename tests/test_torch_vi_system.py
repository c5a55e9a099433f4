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


def test_slice_matches_tpuslam_mono_inertial_system(jax_init_draw):
    seq = SyntheticSequence(n_frames=N_SLICE, fps=10, speed=0.5, imu_rate=200.0,
                            kind="vi_excite")
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    js = JSystem(JPinhole(cam, seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=600),
                             tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=JSensor.IMU_MONOCULAR, imu_calib=JImuCalib(**NOISE))
    ts = System(Pinhole(cam, seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=600),
                           tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(**NOISE),
                dtype=torch.float64, device="cpu")
    times = seq.timestamps()
    init_at = {}
    for i in range(seq.n_frames):
        img, imu = seq.frame(i), _imu(seq, times, i)
        Tj = js.track_monocular(img, times[i], imu=imu)
        Tt = ts.track_monocular(img, times[i], imu=imu)
        assert ts.get_tracking_state().name == js.get_tracking_state().name, i
        assert (Tt is None) == (Tj is None), i
        if i < LOCKSTEP:
            assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
            assert ts.map.imu_initialized == js.map.imu_initialized, i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
        for name, slam in (("jax", js), ("port", ts)):
            if slam.map.imu_initialized:
                init_at.setdefault(name, i)
    assert set(init_at) == {"jax", "port"}, init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 2, init_at
    scales = []
    for slam in (js, ts):
        traj = slam.trajectory_tum()
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(seq, traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.4, (R, s)
        scales.append(s)
    assert abs(scales[1] / scales[0] - 1.0) < SCALE_AGREE, scales
    # the mappers' debug records (System.save_debug_data's imu_events)
    ev_j, ev_t = js.local_mapper.debug_events, ts.local_mapper.debug_events
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j] and ev_t[0]["event"] == \
        "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]
