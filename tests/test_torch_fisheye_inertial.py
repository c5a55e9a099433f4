"""The port's fisheye stereo-inertial System against tpuslam's, then alone,
on the CPU.

TUM-VI's main configuration: tpuslam's System(KB8, sensor=IMU_STEREO,
camera2=, Tlr=, imu_calib=) and the port's track the same frames of the
heave sequence (tests/torch_vi_heave.py) seen by the KB8 pair of
tests/test_e2e_fisheye.py (tests/torch_fisheye_rig.py: 256x256, baseline
0.2 m), 700 features, 10 fps, IMU at 200 Hz, a keyframe at least every 3
frames, a stereo init from 150 features (tests/test_e2e_fisheye.py's; the
256 px extractor keeps ~470). Every frame takes the host path in both
packages (the fused steps are pinhole-only): process_stereo_fisheye, the
camera-generic KB8 pose solve until the mapper initializes the IMU (its
10th keyframe), then the KB8 pose_inertial_solve. Both Systems get the
same numpy images and IMU arrays; the port runs in f64, as tpuslam does
here (the card runs f32: chip_smoke.py phase 13). tpuslam's run is read
from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py) and compared frame by frame.

  * The slice, 31 frames in lockstep: on every frame the tracking state is
    equal; the stereo init happens on the same frame, by frame 3; until
    the IMU init the same keyframe count and poses within 1 cm and 0.2
    degrees (tests/test_torch_vi_system.py's tolerances); the IMU
    initializes within 1 frame in both Systems, before the last 3 frames;
    afterwards both maps are gravity-aligned (|R[2, 2]| > 0.99), both Horn
    scales within 3 % of 1 and of each other, and the mappers record the
    same IMU events.
  * The port alone, the same System continued to 38 frames: OK, IMU
    initialized, an unscaled ATE < 8 cm (tests/test_e2e_fisheye.py's
    bound), a Horn scale within 3 % of 1, |R[2, 2]| > 0.99 and a median
    keyframe-velocity error < 0.2 m/s
    (tests/test_torch_stereo_inertial_e2e.py's gates).
  * Its routes: no frame reaches the pose-LM kernel's wrapper; every
    tracked frame before the IMU init runs camera-generic KB8 pose solves;
    every frame after it the visual solve of its motion-model step, then
    pose_inertial_solve with the KB8 camera once per pass of its local-map
    search (at least 2 passes).
"""

import numpy as np
import pytest
import torch

from tpuslam.cameras import KannalaBrandt8 as JKB8
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.engine import track_device
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import ate_rmse, horn_align
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.solve import pose_inertial, pose_opt_cuda, pose_opt_dispatch

from test_torch_vi_system import NOISE, _gt_centers, _imu, _rot_deg
import torch_records
from torch_fisheye_rig import BASELINE, kb8_rig
from torch_vi_heave import heave_sequence

torch.set_num_threads(2)
N_SLICE, N_FRAMES = 31, 38
TRACKING = dict(max_frames_between_kf=3, min_stereo_init_features=150)


def route_spies(mp, calls):
    """Count, in `calls`, the pose-LM kernel's wrapper ("kernel"), the
    camera-generic pose solves ("generic") and the camera kind of every
    pose_inertial_solve ("vi")."""
    real = (pose_opt_cuda.pose_optimize_fused, pose_opt_dispatch.pose_optimize,
            pose_inertial.pose_inertial_solve)

    def spy(key, fn):
        def wrapped(*a, **kw):
            if key == "vi":
                calls["vi"].append(kw["cam"].kind)
            else:
                calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    mp.setattr(pose_opt_cuda, "pose_optimize_fused", spy("kernel", real[0]))
    mp.setattr(track_device, "pose_optimize_fused", spy("kernel", real[0]))
    mp.setattr(pose_opt_dispatch, "pose_optimize", spy("generic", real[1]))
    mp.setattr(pose_inertial, "pose_inertial_solve", spy("vi", real[2]))


def _sequence():
    cam, cam2, Trl = kb8_rig()
    seq = heave_sequence(n_frames=N_FRAMES, fps=10, speed=0.5, imu_rate=200.0, camera=cam,
                         camera2=cam2, Trl=Trl)
    return seq, (cam, cam2, Trl)


def _tpuslam_slice():
    """tpuslam's System over the slice (in a process of its own): per frame
    its pose, state, keyframe count and IMU flag, then its trajectory and
    the mapper's events."""
    seq, (cam, cam2, Trl) = _sequence()
    jcams = [JKB8(list(c.full_params), c.width, c.height, lapping=c.lapping)
             for c in (cam, cam2)]
    js = JSystem(jcams[0], JSlamConfig(orb=JOrbConfig(n_features=700),
                                       tracking=JTrackingConfig(**TRACKING)),
                 sensor=JSensor.IMU_STEREO, imu_calib=JImuCalib(**NOISE), bf=cam.fx * BASELINE,
                 camera2=jcams[1], Tlr=np.linalg.inv(Trl))
    times = seq.timestamps()
    out = dict(T=[], state=[], n_kf=[], init=[])
    for i in range(N_SLICE):
        out["T"].append(js.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                                        imu=_imu(seq, times, i)))
        out["state"].append(js.get_tracking_state().name)
        out["n_kf"].append(len(js.map.valid_kf_ids()))
        out["init"].append(js.map.imu_initialized)
    return dict(out, traj=js.trajectory_tum(), events=list(js.local_mapper.debug_events))


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        _sequence()[0], N_SLICE, right=True)}


@pytest.fixture(scope="module")
def runs():
    """Both Systems in lockstep over the slice (tpuslam's from its record,
    tests/torch_records.py), then the port alone to N_FRAMES. Returns what
    the tests read."""
    jax_side = torch_records.recorded("fisheye_inertial", _record_inputs())
    seq, (cam, cam2, Trl) = _sequence()
    ts = System(cam, SlamConfig(orb=OrbConfig(n_features=700),
                                tracking=TrackingConfig(**TRACKING)),
                sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE), bf=cam.fx * BASELINE,
                camera2=cam2, Tlr=np.linalg.inv(Trl), dtype=torch.float64, device="cpu")
    times = seq.timestamps()
    port, rows, calls = [], [], {"kernel": 0, "generic": 0, "vi": []}
    with pytest.MonkeyPatch.context() as mp:
        route_spies(mp, calls)
        for i in range(N_FRAMES):
            left, right, imu = seq.frame(i), seq.frame(i, right=True), _imu(seq, times, i)
            before = (calls["generic"], len(calls["vi"]), ts.map.imu_initialized)
            Tt = ts.track_stereo(left, right, times[i], imu=imu)
            rows.append((before[2], calls["generic"] - before[0], len(calls["vi"]) - before[1],
                         ts.get_tracking_state().name))
            if i < N_SLICE:
                port.append((Tt, ts.get_tracking_state().name, len(ts.map.valid_kf_ids()),
                             ts.map.imu_initialized))
            if i == N_SLICE - 1:
                port_traj, port_events = ts.trajectory_tum(), list(ts.local_mapper.debug_events)
    ts.shutdown()
    j = jax_side.result()
    steps = [dict(T=(j["T"][i], Tt), state=(j["state"][i], state), n_kf=(j["n_kf"][i], n_kf),
                  init=(j["init"][i], init))
             for i, (Tt, state, n_kf, init) in enumerate(port)]
    return dict(seq=seq, ts=ts, steps=steps, rows=rows, calls=calls,
                slice_traj=(j["traj"], port_traj), events=(j["events"], port_events))


def test_slice_matches_tpuslam_fisheye_stereo_inertial_system(runs):
    ok_at, init_at = {}, {}
    for i, s in enumerate(runs["steps"]):
        assert s["state"][1] == s["state"][0], i
        Tj, Tt = s["T"]
        assert (Tt is None) == (Tj is None), i
        for k, name in enumerate(("jax", "port")):
            if s["state"][k] == "OK":
                ok_at.setdefault(name, i)
            if s["init"][k]:
                init_at.setdefault(name, i)
        if not init_at:
            assert s["n_kf"][1] == s["n_kf"][0], i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
    assert ok_at["port"] == ok_at["jax"] <= 3, ok_at
    assert set(init_at) == {"jax", "port"}, init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 1, init_at
    assert max(init_at.values()) < N_SLICE - 3, init_at   # KB8 VI frames ran
    scales = []
    for traj in runs["slice_traj"]:
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(runs["seq"], traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.03, (R, s)
        scales.append(s)
    assert abs(scales[1] / scales[0] - 1.0) < 0.03, scales
    ev_j, ev_t = runs["events"]
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j]
    assert ev_t[0]["event"] == "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]


def test_port_fisheye_stereo_inertial_gates(runs):
    seq, ts = runs["seq"], runs["ts"]
    m = ts.map
    assert ts.tracker.camspec.kind == "kb8" and ts.tracker.camera2 is not None
    assert m.imu_initialized and ts.get_tracking_state() == State.OK
    traj = ts.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = _gt_centers(seq, traj)
    assert len(traj) >= N_FRAMES - 3 and np.isfinite(est).all()
    assert ate_rmse(est, gt)[0] < 0.08
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    assert abs(s - 1.0) < 0.03, s
    assert abs(R[2, 2]) > 0.99, R
    errs = [np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
            for k in m.valid_kf_ids()]
    assert np.median(errs) < 0.2, np.median(errs)


def test_port_fisheye_stereo_inertial_routes(runs):
    calls, rows = runs["calls"], runs["rows"]
    assert calls["kernel"] == 0
    assert set(calls["vi"]) == {"kb8"}
    pre = [r for r in rows if not r[0] and r[3] == "OK"][1:]   # tracked, after the stereo init
    post = [r for r in rows if r[0]]
    assert len(pre) >= 20 and all(g >= 1 and v == 0 for _, g, v, _ in pre), pre
    assert len(post) >= 8 and all(g >= 1 and v >= 2 for _, g, v, _ in post), post
