"""The port's fisheye (KB8) stereo System against tpuslam's, on the CPU.

  * The slice: tpuslam's System(camera2=, Tlr=) and the port's track the
    same 6 frames rendered by tpuslam (tests/test_e2e_fisheye.py's 256x256
    rig, 0.2 m baseline, 700 features; the port in f64 as tpuslam runs
    here). Per frame the tracking state and the keyframe count must be
    equal and the poses within 1 cm / 0.2 degrees; both frontends'
    process_stereo_fisheye give equal depths on at least 98 % of the
    keypoints either matched (rtol 1e-4: both triangulate in f64 from f32
    rays, whose last-bit differences depth/baseline ~ 15 amplifies); both
    save_debug_data dumps have the same keys, keyframes, maps and tracking
    state.
  * The port alone: the same System continued over the test's 16 frames
    (frames 6.. from the port's own renderer), held to
    tests/test_e2e_fisheye.py's four gates, with no frame routed to the
    pose-LM kernel's wrapper (the generic solver serves KB8).
  * The default sensor is MONOCULAR in both packages.
"""

import json

import numpy as np
import pytest
import torch

from tpuslam.cameras import KannalaBrandt8 as JKB8
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.io.synthetic import SyntheticSequence as JSyntheticSequence
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import KannalaBrandt8, Pinhole
from tpuslam_torch.engine import track_device
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import ate_rmse
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.solve import pose_opt_cuda

from test_e2e_fisheye import KB_L, KB_R

torch.set_num_threads(2)
N_SLICE, N_E2E = 6, 16
BASELINE = 0.2


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _trl():
    Trl = np.eye(4)
    Trl[:3, 3] = [-BASELINE, 0.0, 0.0]
    return Trl


@pytest.fixture(scope="module")
def fisheye_runs(tmp_path_factory):
    """Both Systems over the slice, then the port alone to N_E2E frames.
    Returns what the tests read."""
    jcam, jcam2 = JKB8(KB_L, 256, 256, lapping=(0, 255)), JKB8(KB_R, 256, 256, lapping=(0, 255))
    cam, cam2 = (KannalaBrandt8(KB_L, 256, 256, lapping=(0, 255)),
                 KannalaBrandt8(KB_R, 256, 256, lapping=(0, 255)))
    Trl = _trl()
    jseq = JSyntheticSequence(n_frames=N_SLICE, fps=10, speed=0.5, camera=jcam, camera2=jcam2,
                              Trl=Trl)
    seq = SyntheticSequence(n_frames=N_E2E, fps=10, speed=0.5, camera=cam, camera2=cam2, Trl=Trl)
    frames = [(jseq.frame(i), jseq.frame(i, right=True)) for i in range(N_SLICE)]
    frames += [(seq.frame(i), seq.frame(i, right=True)) for i in range(N_SLICE, N_E2E)]
    js = JSystem(jcam, JSlamConfig(orb=JOrbConfig(n_features=700),
                                   tracking=JTrackingConfig(min_stereo_init_features=150)),
                 sensor=JSensor.STEREO, bf=jcam.fx * BASELINE, camera2=jcam2,
                 Tlr=np.linalg.inv(Trl))
    ts = System(cam, SlamConfig(orb=OrbConfig(n_features=700),
                                tracking=TrackingConfig(min_stereo_init_features=150)),
                sensor=Sensor.STEREO, bf=cam.fx * BASELINE, camera2=cam2, Tlr=np.linalg.inv(Trl),
                dtype=torch.float64, device="cpu")
    kernel_route = []
    real = (pose_opt_cuda.pose_optimize_fused, track_device.pose_optimize_fused)

    def spy(*a, **kw):
        kernel_route.append(1)
        return real[0](*a, **kw)

    steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pose_opt_cuda, "pose_optimize_fused", spy)
        mp.setattr(track_device, "pose_optimize_fused", spy)
        for i in range(N_E2E):
            Tt = ts.track_stereo(*frames[i], i / seq.fps)
            if i < N_SLICE:
                Tj = js.track_stereo(*frames[i], i / seq.fps)
                steps.append(dict(
                    state=(js.get_tracking_state().name, ts.get_tracking_state().name),
                    n_kf=(len(js.map.valid_kf_ids()), len(ts.map.valid_kf_ids())),
                    T=(Tj, Tt)))
            if i == N_SLICE - 1:
                dumps = tmp_path_factory.mktemp("debug")
                js.save_debug_data(str(dumps / "jax.json"))
                ts.save_debug_data(str(dumps / "port.json"))
                debug = [json.loads((dumps / f"{w}.json").read_text()) for w in ("jax", "port")]
    return dict(seq=seq, frames=frames, js=js, ts=ts, steps=steps, debug=debug,
                kernel_route=kernel_route)


def test_slice_matches_tpuslam_fisheye_system(fisheye_runs):
    steps = fisheye_runs["steps"]
    assert steps[-1]["state"] == ("OK", "OK") and steps[-1]["n_kf"][0] >= 2
    for i, s in enumerate(steps):
        assert s["state"][0] == s["state"][1], i
        assert s["n_kf"][0] == s["n_kf"][1], i
        Tj, Tt = s["T"]
        assert (Tj is None) == (Tt is None), i
        if Tj is not None:
            assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
            assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i


@pytest.mark.parametrize("frame", [0, 5])
def test_process_stereo_fisheye_matches_tpuslam(fisheye_runs, frame):
    """Both frontends on the same pair: equal depths (and u_right = bf/z)
    on >= 98 % of the keypoints that either side matched across the rig."""
    js, ts = fisheye_runs["js"], fisheye_runs["ts"]
    img_l, img_r = fisheye_runs["frames"][frame]
    jf = js.tracker.frontend.process_stereo_fisheye(img_l, img_r, js.tracker.camera2,
                                                    js.tracker.R_rl, js.tracker.t_rl)
    tf = ts.tracker.frontend.process_stereo_fisheye(img_l, img_r, ts.tracker.camera2,
                                                    ts.tracker.R_rl, ts.tracker.t_rl)
    np.testing.assert_array_equal(tf.xy, jf.xy)
    either = (jf.depth > 0) | (tf.depth > 0)
    assert either.sum() > 150
    same = np.isclose(tf.depth, jf.depth, rtol=1e-4, atol=0) & (tf.depth > 0)
    assert same[either].mean() >= 0.98, same[either].mean()
    have = tf.depth > 0
    np.testing.assert_allclose(tf.u_right[have], ts.tracker.bf / tf.depth[have], rtol=1e-12)
    assert (tf.u_right[~have] == -1.0).all()


def test_save_debug_data_matches_tpuslam(fisheye_runs):
    jd, td = fisheye_runs["debug"]
    assert set(td) == set(jd)
    for key in ("keyframes", "maps", "tracking_state", "imu_events", "loops_closed",
                "imu_initialized"):
        assert td[key] == jd[key], key
    assert td["keyframes"] >= 2 and td["tracking_state"] == "OK"


def test_default_sensor_matches_tpuslam():
    cam = [200.0, 200.0, 188.0, 120.0]
    ts = System(Pinhole(cam, 376, 240), device="cpu")
    js = JSystem(JPinhole(cam, 376, 240))
    assert ts.sensor == Sensor.MONOCULAR and js.sensor.name == ts.sensor.name
    assert ts.tracker.sensor == js.tracker.sensor == "mono"


# ------------------------------------------- tests/test_e2e_fisheye.py's gates


def test_fisheye_routes_through_kb8(fisheye_runs):
    ts = fisheye_runs["ts"]
    assert ts.tracker.camera2 is not None and ts.tracker.camspec.kind == "kb8"
    assert fisheye_runs["kernel_route"] == []
    m = ts.map
    f = m.kf_feats[m.valid_kf_ids()[0]]
    assert f.depth is not None and (f.depth > 0).sum() > 50
    have = f.depth > 0
    np.testing.assert_allclose(f.u_right[have], ts.tracker.bf / f.depth[have], rtol=1e-5)


def test_fisheye_tracks(fisheye_runs):
    ts = fisheye_runs["ts"]
    assert ts.get_tracking_state() == State.OK
    assert len(ts.map.valid_kf_ids()) >= 2
    assert ts.map.mp_valid[: ts.map.n_mp].sum() > 100


def test_fisheye_metric_scale_and_ate(fisheye_runs):
    seq, ts = fisheye_runs["seq"], fisheye_runs["ts"]
    traj = ts.trajectory_tum()
    assert len(traj) >= 10
    est = np.array([r[1:4] for r in traj])
    gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
    _, scale = ate_rmse(est, gt, with_scale=True)
    assert abs(scale - 1.0) < 0.05, scale
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.08, rmse


def test_fisheye_depths_sane(fisheye_runs):
    m = fisheye_runs["ts"].map
    f = m.kf_feats[m.valid_kf_ids()[0]]
    d = f.depth[f.depth > 0]
    assert 0.5 < np.median(d) < 8.0
    assert (d < 15.0).mean() > 0.8
