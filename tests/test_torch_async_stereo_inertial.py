"""The port's stereo-inertial System with the mapper on its own thread
against tpuslam's, on the CPU, serialized, and the two faults of tpuslam's
async route that it shows.

tests/test_torch_stereo_inertial.py's run (the heave sequence of
tests/torch_vi_heave.py: 376x240, 600 features, 10 fps, baseline 0.1 m, IMU
at 200 Hz, a keyframe at least every 3 frames) with `async_mapping=True` in
both Systems, serialized by tests/torch_async.py's `lagged`: the worker is
held, and each keyframe is mapped inside the host extraction of the third
frame after the one that made it, after the tracker chose its path and
before it takes the map lock, as a busy mapping thread lands its work (on an
H100 the async IMU init came 1-4 frames after the synchronous one); anything
that waits for the worker lets it run. The worker's code then runs in a fixed
order (the mapper's per-stage locking and its IMU stage on the worker
thread, the tracker's handshake `_sync_imu_from_map` rebasing a last frame
that came after the keyframe, the keyframe's refresh reading the pose before
mapping) and both packages are deterministic. Session A ends with the three
frames from the one the IMU init lands in; `change_dataset()`, then 3 frames
of session B (the sequence continued), whose first finds the worker still
busy with A's last keyframes.

  * Lockstep until the IMU init lands: on every frame the same tracking
    state, the stereo init on the same frame, by frame 3, the same
    keyframe count, poses within 1 cm and 0.2 degrees
    (tests/test_torch_stereo_inertial.py's tolerances). The init lands on
    the same frame, over the same keyframes, and the mappers record the
    same IMU events on the same keyframes.
  * The IMU init lands while the tracker is between its choice of path and
    the map lock (the tracker checks `map.imu_initialized` before it takes
    the lock, and a host frame extracts before it too; the reference
    decides under the lock, Track(), Tracking.cc:921). tpuslam tracks that
    frame on the host path right after the handshake, and its inliers fall
    below half the median before the init within three frames (its fault;
    on the stereo-inertial merge of tests/torch_vi_merge.py's
    loop_sessions with real concurrency this lost tracking after the young
    map's init). The port decides again under the lock and takes the fused
    visual-inertial step; its inliers stay above half that median, its
    handshake rebased the last frame, and session A ends OK,
    gravity-aligned (|R[2, 2]| > 0.99) with a Horn scale within 3 % of 1.
  * A's last keyframe is still queued when B's first frame opens map 1, and
    `create_new_map` clears the store's one set of IMU flags. The reference
    maps a keyframe with its own map's flags (LocalMapping reads
    mpCurrentKeyFrame->GetMap()). tpuslam maps that keyframe of the
    initialized map 0 with map 1's flags: the visual local BA (its fault).
    The port's tracker lets the worker finish the old map's queue before it
    opens the new map: the local inertial BA.

tpuslam's run is read from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py) and the two are compared afterwards. The route with
real concurrency is tests/test_torch_async_stereo_inertial_e2e.py.
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
import torch_records
from torch_async import LAG, count_rebases, lagged
from torch_vi_heave import heave_sequence

torch.set_num_threads(2)
N_MAX, N_B = 44, 3     # the heave frames rendered; session B's frames
AFTER = 3              # frames watched from the one the IMU init lands in
PACKAGES = ("port", "tpuslam")


def _system(package, seq):
    cam, bf = [seq.fx, seq.fy, seq.cx, seq.cy], seq.fx * seq.baseline
    if package == "port":
        return System(Pinhole(cam, seq.width, seq.height),
                      SlamConfig(orb=OrbConfig(n_features=600),
                                 tracking=TrackingConfig(max_frames_between_kf=3)),
                      sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE), bf=bf,
                      dtype=torch.float64, device="cpu", async_mapping=True)
    return JSystem(JPinhole(cam, seq.width, seq.height),
                   JSlamConfig(orb=JOrbConfig(n_features=600),
                               tracking=JTrackingConfig(max_frames_between_kf=3)),
                   sensor=JSensor.IMU_STEREO, imu_calib=JImuCalib(**NOISE), bf=bf,
                   async_mapping=True)


def _run(package):
    """One package's run (see the module's docstring). Per frame: its pose,
    state, keyframe count, IMU flag before and after, inliers and fused VI
    steps; per mapped keyframe [kf, its map, the store's imu_initialized
    when its mapping began, the local BA's route]; then the end state."""
    seq = heave_sequence(n_frames=N_MAX, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1)
    slam = _system(package, seq)
    lm, m, tr = slam.local_mapper, slam.map, slam.tracker
    mapped, fused_vi = [], [0]
    real_map, real_fused_vi = lm.on_new_keyframe, tr._track_fused_vi

    def on_new_keyframe(kf, lock=None):
        mapped.append([int(kf), int(m.kf_map_id[kf]), bool(m.imu_initialized), None])
        return real_map(kf, lock=lock)

    def track_fused_vi(*a, **kw):
        fused_vi[0] += 1
        return real_fused_vi(*a, **kw)

    lm.on_new_keyframe, tr._track_fused_vi = on_new_keyframe, track_fused_vi
    for name in ("_local_ba", "_local_inertial_ba"):
        def ba(kf, *a, _real=getattr(lm, name), _name=name, **kw):
            mapped[-1][3] = _name
            return _real(kf, *a, **kw)
        setattr(lm, name, ba)
    lagged(slam)
    rebases = count_rebases(tr)
    times = seq.timestamps()
    rows, landed, n_a = [], None, None
    for i in range(N_MAX):
        before, n_vi = m.imu_initialized, fused_vi[0]
        T = slam.track_stereo(seq.frame(i), seq.frame(i, right=True), times[i],
                              imu=_imu(seq, times, i))
        rows.append(dict(T=T, state=slam.get_tracking_state().name,
                         n_kf=len(m.valid_kf_ids()), before=before, after=m.imu_initialized,
                         inliers=tr.n_inliers, fused_vi=fused_vi[0] - n_vi))
        if landed is None and m.imu_initialized and not before:
            landed = i
        if n_a is None and landed is not None and i == landed + AFTER - 1:
            n_a = i + 1             # the keyframes of A's last frames are still queued
            traj = slam.trajectory_tum()
            slam.change_dataset()
        if n_a is not None and i == n_a + N_B - 1:
            break
    slam.shutdown()
    return dict(rows=rows, landed=landed, n_a=n_a, mapped=mapped,
                frame_of={k: int(m.kf_frame_id[k]) for k, *_ in mapped},
                init_kfs=[e["n_kfs"] for e in lm.debug_events if e["event"] == "imu_init"],
                events=[(e["event"], e["n_kfs"], e["t"]) for e in lm.debug_events],
                rebases=rebases[0], traj=traj, gt=_gt_centers(seq, traj), maps=m.n_maps_created,
                errors=[repr(e) for e in slam.async_mapper.errors],
                alive=slam.async_mapper.worker.is_alive())


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        heave_sequence(n_frames=N_MAX, fps=10, speed=0.5, imu_rate=200.0, baseline=0.1), N_MAX,
        right=True)}


@pytest.fixture(scope="module")
def runs():
    """Both packages' runs, tpuslam's from its record (tests/torch_records.py)."""
    jax_side = torch_records.recorded("async_stereo_inertial", _record_inputs())
    port = _run("port")
    return {"port": port, "tpuslam": jax_side.result()}


def test_lockstep_to_the_imu_init(runs):
    t, j = runs["port"], runs["tpuslam"]
    assert t["landed"] == j["landed"] is not None, (t["landed"], j["landed"])
    ok_at = {}
    for name, run in runs.items():
        assert run["errors"] == [] and not run["alive"], name
        ok_at[name] = next(i for i, r in enumerate(run["rows"]) if r["state"] == "OK")
    assert ok_at["port"] == ok_at["tpuslam"] <= 3, ok_at
    for i in range(t["landed"]):
        a, b = t["rows"][i], j["rows"][i]
        assert a["state"] == b["state"] and a["n_kf"] == b["n_kf"], i
        assert (a["T"] is None) == (b["T"] is None), i
        if a["T"] is not None:
            assert np.linalg.norm(a["T"][:3, 3] - b["T"][:3, 3]) < 0.01, i
            assert _rot_deg(a["T"][:3, :3], b["T"][:3, :3]) < 0.2, i
    assert t["init_kfs"] == j["init_kfs"] and len(t["init_kfs"]) == 1
    assert t["events"] == j["events"] and t["events"][0][0] == "imu_init"


@pytest.mark.parametrize("package", PACKAGES)
def test_the_imu_init_landing_after_the_choice_of_path(runs, package):
    run = runs[package]
    rows, landed = run["rows"], run["landed"]
    ref = np.median([r["inliers"] for r in rows[3:landed]])
    watched = rows[landed:landed + AFTER]
    worst = min(r["inliers"] for r in watched)
    print(package, "the IMU init landed in frame", landed, "inliers before (median)", ref,
          "then", [r["inliers"] for r in watched])
    assert not rows[landed]["before"] and rows[landed]["after"]
    if package == "tpuslam":
        # its fault: the host path after the handshake, and the track decays
        assert rows[landed]["fused_vi"] == 0 and worst < 0.5 * ref, watched
        return
    assert rows[landed]["fused_vi"] == 1 and worst > 0.5 * ref, watched
    assert all(r["state"] == "OK" for r in rows[landed:run["n_a"]]) and run["rebases"] >= 1
    est = np.array([r[1:4] for r in run["traj"]])
    R, _, s, _ = horn_align(est, run["gt"], with_scale=True)
    assert abs(R[2, 2]) > 0.99 and abs(s - 1.0) < 0.03, (R, s)


@pytest.mark.parametrize("package", PACKAGES)
def test_a_queued_keyframe_of_the_old_map_is_mapped_with_its_flags(runs, package):
    run = runs[package]
    assert run["maps"] == 2, run["maps"]          # B's first frame opened map 1
    mapped = run["mapped"]
    # A's last keyframe, made within LAG frames of the boundary, still queued
    # when B's first frame opened map 1
    kf, _, init, route = [x for x in mapped if x[1] == 0][-1]
    assert run["frame_of"][kf] >= run["n_a"] - LAG, (kf, run["frame_of"], run["n_a"])
    if package == "tpuslam":
        # its fault: the keyframe of the initialized map 0 sees map 1's flags
        assert not init and route == "_local_ba", mapped
    else:
        assert init and route == "_local_inertial_ba", mapped
