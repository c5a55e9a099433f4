"""The port's stereo System end to end, on the CPU.

  * The slice as a whole: tpuslam's System and the port's System track
    the same 8 rendered frames (376x240, 500 features, a keyframe every 2
    frames, so stereo init, keyframe insertion, triangulation, fusion and
    local BA all run); per frame the tracking state and the keyframe count
    must be equal and the poses within 1 cm / 0.2 degrees.
  * The port alone over 20 frames, with the gates of
    tests/test_e2e_stereo.py (state OK, >= 2 KFs, > 100 points, unscaled
    ATE < 5 cm, Horn scale within 3 % of 1), and the trajectory savers.
  * bench.py's configuration (async mapping + pipelined tracking): only
    the state after flush() is asserted, not quality during the race.
  * The parts that once raised as not ported now run (mono, RGB-D, the
    vocabulary and the fisheye rig: tests/test_torch_{mono,rgbd,loop_run,
    fisheye}.py): camera2 / Tlr build a fisheye stereo tracker, and the
    map checkpoint writes tpuslam's npz and loads into a fresh System.
"""

import numpy as np
import pytest
import torch

from tpuslam.cameras import KannalaBrandt8 as JKannalaBrandt8
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.eval.ate import ate_rmse
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import KannalaBrandt8, Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(2)


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@pytest.fixture(scope="module")
def seq20():
    seq = SyntheticSequence(n_frames=20, fps=10, speed=0.5, baseline=0.1)
    return seq, [(seq.frame(i), seq.frame(i, right=True)) for i in range(seq.n_frames)]


def _port(seq, n_features=700, **kw):
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    tc = dict(min_stereo_init_features=200)
    tc.update(kw.pop("tracking", {}))
    cfg = SlamConfig(orb=OrbConfig(n_features=n_features), tracking=TrackingConfig(**tc))
    return System(cam, cfg, sensor=Sensor.STEREO, bf=seq.fx * seq.baseline, device="cpu", **kw)


def test_slice_matches_tpuslam_system(seq20):
    seq, frames = seq20
    n = 8
    jcfg = JSlamConfig(orb=JOrbConfig(n_features=500),
                       tracking=JTrackingConfig(min_stereo_init_features=200,
                                                max_frames_between_kf=2))
    js = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), jcfg,
                 sensor=JSensor.STEREO, bf=seq.fx * seq.baseline)
    ts = _port(seq, 500, tracking=dict(max_frames_between_kf=2))
    n_ba = 0
    for i in range(n):
        Tj = js.track_stereo(*frames[i], i / seq.fps)
        Tt = ts.track_stereo(*frames[i], i / seq.fps)
        assert ts.get_tracking_state().name == js.get_tracking_state().name == "OK", i
        assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
        assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
        assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
        n_ba = ts.map.map_version
    assert len(ts.map.valid_kf_ids()) >= 3 and n_ba >= 2       # local BA ran
    n_pts = int(ts.map.mp_valid[: ts.map.n_mp].sum())
    assert abs(n_pts - int(js.map.mp_valid[: js.map.n_mp].sum())) <= 0.05 * n_pts
    for (a, b) in zip(ts.trajectory_tum(), js.trajectory_tum()):
        np.testing.assert_allclose(a, b, atol=0.01)


def _gt_xyz(seq, traj):
    return np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])


def test_port_system_tracks_20_frames(seq20, tmp_path):
    seq, frames = seq20
    slam = _port(seq)
    for i in range(seq.n_frames):
        slam.track_stereo(*frames[i], i / seq.fps)
    slam.shutdown()
    assert slam.get_tracking_state() == State.OK
    assert len(slam.map.valid_kf_ids()) >= 2
    assert slam.map.mp_valid[: slam.map.n_mp].sum() > 100
    traj = slam.trajectory_tum()
    assert len(traj) >= 15
    est = np.array([r[1:4] for r in traj])
    gt = _gt_xyz(seq, traj)
    rmse_s, scale = ate_rmse(est, gt, with_scale=True)
    assert abs(scale - 1.0) < 0.03, scale
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.05, rmse
    assert len(slam.get_tracked_map_points()) == 700
    assert slam.get_tracked_keypoints_un().shape == (700, 2)
    # the savers write what trajectory_tum holds
    slam.save_trajectory_tum(tmp_path / "t.txt")
    slam.save_trajectory_euroc(tmp_path / "e.txt")
    slam.save_trajectory_kitti(tmp_path / "k.txt")
    slam.save_keyframe_trajectory_tum(tmp_path / "kt.txt")
    slam.save_keyframe_trajectory_euroc(tmp_path / "ke.txt")
    tum = np.loadtxt(tmp_path / "t.txt")
    np.testing.assert_allclose(tum, np.array(traj), atol=1e-8)
    eu = np.loadtxt(tmp_path / "e.txt")
    np.testing.assert_allclose(eu[:, 1:4], tum[:, 1:4], atol=1e-8)
    np.testing.assert_allclose(eu[:, 4], tum[:, 7], atol=1e-8)        # qw first
    ki = np.loadtxt(tmp_path / "k.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(ki[:, :, 3], tum[:, 1:4], atol=1e-8)
    assert len(np.loadtxt(tmp_path / "kt.txt", ndmin=2)) == len(slam.map.valid_kf_ids())
    assert len(np.loadtxt(tmp_path / "ke.txt", ndmin=2)) == len(slam.map.valid_kf_ids())


def test_async_pipelined_state_after_flush(seq20):
    seq, frames = seq20
    slam = _port(seq, async_mapping=True, tracking=dict(pipelined=True))
    out = [slam.track_stereo(*frames[i], i / seq.fps) for i in range(12)]
    # frame 0 initializes; later frames are still in flight when
    # track_stereo returns, and land in the trajectory one frame later
    assert out[0] is not None and all(T is None for T in out[1:])
    slam.async_mapper.flush()          # raises a worker error
    slam.shutdown()
    assert slam.async_mapper.errors == []
    assert not slam.async_mapper.worker.is_alive()
    assert slam.get_tracking_state() == State.OK
    assert len(slam.tracker.trajectory) == 12 and slam.tracker._pending is None
    assert len(slam.map.valid_kf_ids()) >= 2
    assert slam.map.mp_valid[: slam.map.n_mp].sum() > 100
    assert slam.map.check_essential_graph() == []


def test_modes_and_resets(seq20):
    seq, frames = seq20
    slam = _port(seq, 500)
    for i in range(3):
        slam.track_stereo(*frames[i], i / seq.fps)
    slam.activate_localization_mode()
    n_kf = len(slam.map.valid_kf_ids())
    for i in range(3, 6):
        slam.track_stereo(*frames[i], i / seq.fps)
    assert len(slam.map.valid_kf_ids()) == n_kf and slam.tracker.only_tracking
    slam.deactivate_localization_mode()
    slam.change_dataset()
    slam.track_stereo(*frames[6], 0.6)
    assert slam.map.current_map_id == 1 and slam.get_tracking_state() == State.OK
    slam.reset_active_map()
    assert slam.get_tracking_state() == State.NO_IMAGES_YET
    assert len(slam.map.valid_kf_ids()) == 0
    slam.reset()
    assert slam.tracker.trajectory == [] and slam.map.mp_valid.sum() == 0


@pytest.mark.parametrize("what", ["Tlr", "camera2", "checkpoint", "load_checkpoint"])
def test_unported_parts_raise(what, tmp_path):
    cam = Pinhole([200.0, 200.0, 188.0, 120.0], 376, 240)
    if what in ("Tlr", "camera2"):
        # ported: the fisheye rig reaches the tracker as tpuslam's does
        # (camera2 without Tlr: the identity extrinsic, as there)
        fish = KannalaBrandt8([95.0, 95.0, 128.0, 128.0, 0.0, 0.0, 0.0, 0.0], 256, 256)
        Tlr = np.eye(4)
        Tlr[0, 3] = 0.2
        kw = {"camera2": fish} if what == "camera2" else {"camera2": fish, "Tlr": Tlr}
        slam = System(fish, sensor=Sensor.STEREO, bf=19.0, device="cpu", **kw)
        tr = slam.tracker
        assert tr.camera2 is fish and slam.camera2 is fish and tr.camspec.kind == "kb8"
        np.testing.assert_array_equal(tr.R_rl, np.eye(3))
        np.testing.assert_array_equal(tr.t_rl, -Tlr[:3, 3] if what == "Tlr" else np.zeros(3))
        jt = JSystem(JKannalaBrandt8(fish.full_params, 256, 256), sensor=JSensor.STEREO, bf=19.0,
                     **{k: (JKannalaBrandt8(fish.full_params, 256, 256) if k == "camera2" else v)
                        for k, v in kw.items()}).tracker
        np.testing.assert_array_equal(tr.t_rl, jt.t_rl)
        return
    # ported: save_checkpoint writes tpuslam's npz (keys and dtypes);
    # load_checkpoint gives a fresh System the saved map
    from tpuslam.map.store import FrameFeatures as JFrameFeatures

    from tpuslam_torch.map.store import FrameFeatures

    systems = (System(cam, sensor=Sensor.STEREO, device="cpu"),
               JSystem(JPinhole(cam.params, 376, 240), sensor=JSensor.STEREO))
    for slam, ff in zip(systems, (FrameFeatures, JFrameFeatures)):
        rng = np.random.RandomState(0)
        m = slam.map
        f = ff(xy=rng.rand(700, 2), und_xy=rng.rand(700, 2), norm_xy=rng.rand(700, 2),
               octave=np.zeros(700, np.int32), angle=rng.rand(700), response=rng.rand(700),
               bits=np.zeros((700, 256), np.uint8), packed=np.zeros((700, 8), np.uint32),
               valid=np.ones(700, bool))
        k0 = m.add_keyframe(np.eye(3), np.zeros(3), f, 0.0, 0)
        k1 = m.add_keyframe(np.eye(3), np.array([0.1, 0.0, 0.0]), f, 0.5, 5)
        for s in range(20):
            m.add_observation(m.add_point(rng.rand(3) + [0.0, 0.0, 3.0], k0, s), k1, s)
        m.update_connections(k1)
        slam.save_checkpoint(tmp_path / f"{type(f).__module__.split('.')[0]}.npz")
    port, ref = (np.load(tmp_path / f"{p}.npz") for p in ("tpuslam_torch", "tpuslam"))
    assert sorted(port.files) == sorted(ref.files)
    assert all(port[k].dtype == ref[k].dtype for k in ref.files)
    if what == "load_checkpoint":
        fresh = System(cam, sensor=Sensor.STEREO, device="cpu")
        fresh.load_checkpoint(tmp_path / "tpuslam_torch.npz")
        m, m2 = systems[0].map, fresh.map
        assert (m2.n_kf, m2.n_mp) == (2, 20) and m2.mp_obs == m.mp_obs and m2.covis == m.covis
        assert np.array_equal(m2.kf_t, m.kf_t) and np.array_equal(m2.kf_mp, m.kf_mp)
        assert np.array_equal(m2.kf_feats[1].xy, m.kf_feats[1].xy)
        assert fresh.keyframe_trajectory_tum() == systems[0].keyframe_trajectory_tum()


@pytest.mark.parametrize("what", ["IMU_MONOCULAR", "imu_calib", "IMU_STEREO", "imu"])
def test_inertial_parts_run(what):
    """The calls that raised before the IMU stack was ported now run: the
    inertial sensors build a visual-inertial tracker and mapper (and need
    an ImuCalib), imu_calib on a visual sensor is ignored as in tpuslam,
    and imu= samples reach the tracker's buffer."""
    cam = Pinhole([200.0, 200.0, 188.0, 120.0], 376, 240)
    img = np.zeros((240, 376), np.float32)
    imu = np.column_stack([np.arange(1, 4) * 0.005, np.zeros((3, 3)),
                           np.tile([0.0, 0.0, 9.81], (3, 1))])
    if what in Sensor.__members__:
        with pytest.raises(ValueError, match="imu_calib"):
            System(cam, sensor=Sensor[what], device="cpu")
        slam = System(cam, sensor=Sensor[what], imu_calib=ImuCalib(), bf=20.0, device="cpu")
        assert slam.tracker.use_imu and slam.local_mapper.imu_calib is not None
        if what == "IMU_MONOCULAR":
            slam.track_monocular(img, 0.0, imu=imu)
        else:
            slam.track_stereo(img, img, 0.0, imu=imu)
        # a blank image initializes nothing
        assert slam.get_tracking_state() in (State.NO_IMAGES_YET, State.NOT_INITIALIZED)
        assert len(slam.map.valid_kf_ids()) == 0
        return
    if what == "imu_calib":
        slam = System(cam, imu_calib=ImuCalib(), bf=20.0, device="cpu")
        assert not slam.tracker.use_imu and slam.local_mapper.imu_calib is None
        return
    slam = System(cam, sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(), device="cpu")
    slam.track_monocular(img, 0.02, imu=imu)
    assert np.array_equal(np.asarray(slam.tracker.imu_since_kf), imu)
