"""The port's monocular and mono-inertial fisheye Systems against tpuslam's,
on the CPU.

TUM-VI's `--sensor mono` and `--sensor mono_imu` routes: a System on the
left KB8 camera of tests/torch_fisheye_rig.py (256x256, 700 features, a
keyframe at least every 3 frames). Every frame takes the host path in
both packages; the two-view init runs reconstruct_two_views on the
unprojected KB8 rays. The port's two-view RANSAC samples are tpuslam's own
draws (tests/test_torch_vi_system.py's jax_draw), both Systems get
the same numpy images and IMU arrays, and the port runs in f64, as
tpuslam does here (the card runs f32: chip_smoke.py phase 14). tpuslam's
mono-inertial run is read from its record (tests/torch_records.py, written
by tests/make_tpuslam_records.py) and compared frame by frame.

  * Monocular: tests/test_torch_fisheye_mono_slice.py.
  * Mono-inertial (vi_excite, IMU at 200 Hz, tests/test_torch_vi_system.py's
    noise), 31 frames in lockstep, a few past the IMU init: on every frame
    the same tracking state; the IMU initializes within 1 frame in both,
    both maps are gravity-aligned (|R[2, 2]| > 0.99) with Horn scales
    within 0.4 of 1, and the mappers record the same IMU events. The
    keyframe count and the poses (within 1 cm / 0.2 degrees) agree up to
    LOCKSTEP: on frame 7 tpuslam keeps 165 inliers and the port 166 (their
    f32 pose solves differ by ~1e-4 m), on either side of the keyframe
    threshold (0.9 x 184 = 165.6 tracked points of the reference
    keyframe), so from there their keyframes differ, as
    tests/test_torch_vi_system.py's do from frame 22.
  * The port alone, the same mono-inertial System continued to 44 frames:
    phase 7's gates (IMU initialized, OK, Horn scale within 0.4 of 1,
    scaled ATE < 6 cm, |R[2, 2]| > 0.99, median keyframe-velocity error
    < 0.2 m/s), and tests/test_torch_fisheye_inertial.py's routes.
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
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.eval.ate import ate_rmse, horn_align
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.ops import twoview

from test_torch_vi_system import NOISE, _gt_centers, _imu, _rot_deg, jax_draw
from test_torch_fisheye_inertial import route_spies
import torch_records
from torch_fisheye_rig import kb8_rig

torch.set_num_threads(2)
N_MONO, N_SLICE, N_MONO_VI = 13, 31, 44
LOCKSTEP = 7


def _systems(sensor, **imu):
    cam = kb8_rig()[0]
    jcam = JKB8(list(cam.full_params), cam.width, cam.height, lapping=cam.lapping)
    js = JSystem(jcam, JSlamConfig(orb=JOrbConfig(n_features=700),
                                   tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=getattr(JSensor, sensor),
                 **({"imu_calib": JImuCalib(**NOISE)} if imu else {}))
    ts = System(cam, SlamConfig(orb=OrbConfig(n_features=700),
                                tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=getattr(Sensor, sensor), dtype=torch.float64, device="cpu",
                **({"imu_calib": ImuCalib(**NOISE)} if imu else {}))
    return cam, js, ts


def _sequence(cam):
    return SyntheticSequence(n_frames=N_MONO_VI, fps=10, speed=0.5, imu_rate=200.0,
                             kind="vi_excite", camera=cam)


def _tpuslam_slice():
    """tpuslam's IMU_MONOCULAR System over the slice (in a process of its
    own): per frame its pose, state, keyframe count and IMU flag, then its
    trajectory and the mapper's events."""
    cam, js, _ = _systems("IMU_MONOCULAR", imu=True)
    seq = _sequence(cam)
    times = seq.timestamps()
    out = dict(T=[], state=[], n_kf=[], init=[])
    for i in range(N_SLICE):
        out["T"].append(js.track_monocular(seq.frame(i), times[i], imu=_imu(seq, times, i)))
        out["state"].append(js.get_tracking_state().name)
        out["n_kf"].append(len(js.map.valid_kf_ids()))
        out["init"].append(js.map.imu_initialized)
    return dict(out, traj=js.trajectory_tum(), events=list(js.local_mapper.debug_events))


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        _sequence(kb8_rig()[0]), N_SLICE)}


@pytest.fixture(scope="module")
def mono_vi_runs():
    """Both IMU_MONOCULAR Systems in lockstep over the slice (tpuslam's from
    its record, tests/torch_records.py), then the port alone to N_MONO_VI.
    Returns what the tests read."""
    jax_side = torch_records.recorded("fisheye_mono", _record_inputs())
    cam, _, ts = _systems("IMU_MONOCULAR", imu=True)
    seq = _sequence(cam)
    times = seq.timestamps()
    port, rows, calls = [], [], {"kernel": 0, "generic": 0, "vi": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twoview, "draw_samples", jax_draw)
        route_spies(mp, calls)
        for i in range(N_MONO_VI):
            img, imu = seq.frame(i), _imu(seq, times, i)
            before = (calls["generic"], len(calls["vi"]), ts.map.imu_initialized)
            Tt = ts.track_monocular(img, times[i], imu=imu)
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


def test_slice_matches_tpuslam_fisheye_mono_inertial_system(mono_vi_runs):
    init_at = {}
    for i, s in enumerate(mono_vi_runs["steps"]):
        assert s["state"][1] == s["state"][0], i
        Tj, Tt = s["T"]
        assert (Tt is None) == (Tj is None), i
        if i < LOCKSTEP:
            assert s["n_kf"][1] == s["n_kf"][0], i
            if Tj is not None:
                assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
                assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
        for k, name in enumerate(("jax", "port")):
            if s["init"][k]:
                init_at.setdefault(name, i)
    assert set(init_at) == {"jax", "port"}, init_at
    assert abs(init_at["jax"] - init_at["port"]) <= 1, init_at
    assert max(init_at.values()) < N_SLICE - 2, init_at
    for traj in mono_vi_runs["slice_traj"]:
        est = np.array([r[1:4] for r in traj])
        R, _, s, _ = horn_align(est, _gt_centers(mono_vi_runs["seq"], traj), with_scale=True)
        assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.4, (R, s)
    ev_j, ev_t = mono_vi_runs["events"]
    assert [e["event"] for e in ev_t] == [e["event"] for e in ev_j]
    assert ev_t[0]["event"] == "imu_init"
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]


def test_port_fisheye_mono_inertial_gates(mono_vi_runs):
    """tests/test_torch_vi_e2e.py's gates (phase 7's)."""
    seq, ts = mono_vi_runs["seq"], mono_vi_runs["ts"]
    m = ts.map
    assert ts.tracker.camspec.kind == "kb8"
    assert m.imu_initialized and ts.get_tracking_state() == State.OK
    traj = ts.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = _gt_centers(seq, traj)
    assert len(traj) >= N_MONO_VI - 6 and np.isfinite(est).all()
    rmse, scale = ate_rmse(est, gt, with_scale=True)
    assert abs(scale - 1.0) < 0.4, scale
    assert rmse < 0.06, rmse
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    assert abs(R[2, 2]) > 0.99, R
    errs = [np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
            for k in m.valid_kf_ids()]
    assert np.median(errs) < 0.2, np.median(errs)


def test_port_fisheye_mono_inertial_routes(mono_vi_runs):
    """As tests/test_torch_fisheye_inertial.py's routes."""
    calls, rows = mono_vi_runs["calls"], mono_vi_runs["rows"]
    assert calls["kernel"] == 0
    assert set(calls["vi"]) == {"kb8"}
    pre = [r for r in rows if not r[0] and r[3] == "OK"][1:]   # tracked, after the two-view init
    post = [r for r in rows if r[0]]
    assert len(pre) >= 15 and all(g >= 1 and v == 0 for _, g, v, _ in pre), pre
    assert len(post) >= 10 and all(g >= 1 and v >= 2 for _, g, v, _ in post), post
