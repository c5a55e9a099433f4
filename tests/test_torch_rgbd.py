"""The port's RGB-D path on the CPU: the renderer's depth, rgbd_to_stereo,
Frontend.process_rgbd and System.track_rgbd, against tpuslam's and against
the gates of tests/test_e2e_rgbd.py.

  * Units: the rendered image and depth are bitwise tpuslam's (the same
    numpy code); rgbd_to_stereo equal; process_rgbd's keypoints,
    descriptors and depths equal to tpuslam's on >= 98 % of the keypoints
    (the ORB extractors agree to that, tests/test_torch_orb.py).
  * The slice: tpuslam's RGB-D System and the port's on the same 8
    rendered frames (376x240, 700 features, bf = fx * 0.08); per frame the
    tracking state and the keyframe count must be equal and the poses
    within 1 cm / 0.2 degrees.
  * The port alone over 25 frames, with the gates of tests/test_e2e_rgbd.py
    (state OK, >= 2 KFs, > 100 points, unscaled ATE < 5 cm, Horn scale
    within 3 % of 1, map depths within 5 % of the rendered depth).
"""

import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.frontend import Frontend as JFrontend
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.eval.ate import ate_rmse
from tpuslam.io.synthetic import SyntheticSequence as JSyntheticSequence
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.ops.stereo import rgbd_to_stereo as j_rgbd_to_stereo
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.frontend import Frontend
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.ops.stereo import depth_from_disparity, rgbd_to_stereo

torch.set_num_threads(2)


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=25, fps=10, speed=0.5)


def test_render_depth_is_tpuslams(seq):
    img, depth = seq.frame_rgbd(3)
    jimg, jdepth = JSyntheticSequence(n_frames=25, fps=10, speed=0.5).frame_rgbd(3)
    assert np.array_equal(img, jimg) and np.array_equal(depth, jdepth)
    assert np.array_equal(img, seq.frame(3)) and depth.dtype == np.float32
    assert (depth > 0).mean() > 0.99
    np.testing.assert_array_equal(seq.timestamps(), np.arange(25) / 10)


def test_rgbd_to_stereo_matches_tpuslam(rng):
    depth = np.zeros((10, 10), np.float32)
    depth[5, 5] = 2.0
    z, u_r = rgbd_to_stereo(np.array([[5.2, 4.9], [1.0, 1.0]]), depth, bf=10.0)
    assert z[0] == pytest.approx(2.0) and u_r[0] == pytest.approx(5.2 - 10.0 / 2.0)
    assert z[1] == 0.0 and u_r[1] == -1.0
    dmap = rng.uniform(0.5, 5.0, (40, 60)).astype(np.float32)
    dmap[rng.rand(40, 60) < 0.2] = 0.0
    xy = rng.uniform(-2, 62, (200, 2))
    for a, b in zip(rgbd_to_stereo(xy, dmap, 16.0, 0.5), j_rgbd_to_stereo(xy, dmap, 16.0, 0.5)):
        np.testing.assert_array_equal(a, b)
    disp = torch.tensor([0.0, 1e-4, 2.0, 8.0])
    np.testing.assert_allclose(depth_from_disparity(disp, 16.0).numpy(), [-1, -1, 8, 2])


def test_process_rgbd_matches_tpuslam(seq):
    img, depth = seq.frame_rgbd(0)
    bf = seq.fx * 0.08
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    tf = Frontend(Pinhole(cam, seq.width, seq.height), OrbConfig(n_features=700),
                  bf=bf, device="cpu").process_rgbd(img, depth)
    jf = JFrontend(JPinhole(cam, seq.width, seq.height), JOrbConfig(n_features=700),
                   bf=bf).process_rgbd(img, depth)

    def key(f):
        return {(round(float(x), 3), round(float(y), 3), int(o)): i
                for i, (x, y, o, v) in enumerate(zip(f.xy[:, 0], f.xy[:, 1], f.octave, f.valid))
                if v}

    kj, kt = key(jf), key(tf)
    shared = kj.keys() & kt.keys()
    assert len(shared) / max(len(kj), len(kt)) >= 0.98
    ij = np.array([kj[k] for k in shared])
    it = np.array([kt[k] for k in shared])
    assert np.mean(jf.bits[ij] == tf.bits[it]) >= 0.99
    np.testing.assert_allclose(tf.depth[it], jf.depth[ij], atol=1e-6)
    np.testing.assert_allclose(tf.u_right[it], jf.u_right[ij], atol=1e-4)
    assert (tf.depth[it] > 0).mean() > 0.95


def test_slice_matches_tpuslam_rgbd_system(seq):
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    bf = seq.fx * 0.08
    js = JSystem(JPinhole(cam, seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=700),
                             tracking=JTrackingConfig(min_stereo_init_features=200,
                                                      max_frames_between_kf=3)),
                 sensor=JSensor.RGBD, bf=bf)
    ts = System(Pinhole(cam, seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=700),
                           tracking=TrackingConfig(min_stereo_init_features=200,
                                                   max_frames_between_kf=3)),
                sensor=Sensor.RGBD, bf=bf, dtype=torch.float64, device="cpu")
    for i in range(8):
        img, depth = seq.frame_rgbd(i)
        Tj = js.track_rgbd(img, depth, i / seq.fps)
        Tt = ts.track_rgbd(img, depth, i / seq.fps)
        assert ts.get_tracking_state().name == js.get_tracking_state().name == "OK", i
        assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
        assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
        assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
    assert len(ts.map.valid_kf_ids()) >= 3
    assert ts.tracker._fused is None          # RGB-D stays on the host path
    for (a, b) in zip(ts.trajectory_tum(), js.trajectory_tum()):
        np.testing.assert_allclose(a, b, atol=0.01)


def test_port_rgbd_gates(seq):
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=700),
                             tracking=TrackingConfig(min_stereo_init_features=200)),
                  sensor=Sensor.RGBD, bf=seq.fx * 0.08, device="cpu")
    for i, t in enumerate(seq.timestamps()):
        slam.track_rgbd(*seq.frame_rgbd(i), t)
    slam.shutdown()
    m = slam.map
    assert slam.get_tracking_state() == State.OK
    assert len(m.valid_kf_ids()) >= 2 and m.mp_valid[: m.n_mp].sum() > 100
    traj = slam.trajectory_tum()
    assert len(traj) >= 15
    est = np.array([r[1:4] for r in traj])
    gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
    _, scale = ate_rmse(est, gt, with_scale=True)
    assert abs(scale - 1.0) < 0.03, scale
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.05, rmse
    kf = int(m.valid_kf_ids()[0])
    f = m.kf_feats[kf]
    errs = []
    for s in np.nonzero(m.kf_mp[kf] >= 0)[0][:200]:
        j = int(m.kf_mp[kf, s])
        if m.mp_valid[j] and f.depth[s] > 0:
            errs.append(abs((m.kf_R[kf] @ m.mp_pos[j] + m.kf_t[kf])[2] - f.depth[s]) / f.depth[s])
    assert len(errs) > 50 and np.median(errs) < 0.05
    with pytest.raises(ValueError):
        slam.track_monocular(seq.frame(0), 9.0)
