"""The port's inertial engine against tpuslam's, on the CPU, on the small
map of tests/test_engine_vi.py::_build_map (8 keyframes, 60 points, perfect
IMU at 400 Hz), carried into the port with map_state / map_from_numpy.

  * preintegrate_window (f32, tpuslam's cast): within 1e-5 relative.
  * window / full / local inertial BA, f64: poses, velocities, biases and
    points within 1e-7 of tpuslam's map after the same call.
  * run_imu_init on the map moved into a rotated, scaled visual frame:
    scale and the gravity-aligned map within 1e-5 of tpuslam's (its
    preintegrations are re-run in f32 on both sides), and the scale
    recovered.
  * The inertial GBA (tests/test_gba_inertial.py's scenario): the loop
    closer snapshots the FullInertialBA, solves it like tpuslam (states
    within 1e-7) and stages velocities and biases with the poses.
  * The IMU guards of tests/test_imu_guards.py on the port's System, and
    why no rendered sequence passes the stereo-inertial init gate.
  * In a process group of more than one rank the large VI BA and the
    inertial GBA take the distributed FullInertialBA and land on the
    single-rank route's result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.core import lie as JL
from tpuslam.engine import inertial as JEI
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.local_mapping import LocalMapper as JLocalMapper
from tpuslam.engine.loop_closing import LoopCloser as JLoopCloser
from tpuslam.place import train_vocabulary as j_train_vocabulary
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import inertial as TEI
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.loop_closing import LoopCloser
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.tracking import Frame, State
from tpuslam_torch.imu import preintegration as TP
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.store import FrameFeatures, SlamMap, map_from_numpy, map_state
from tpuslam_torch.parallel import launch
from tpuslam_torch.place import train_vocabulary

import torch_dist_jobs as jobs
from test_engine_vi import CX, CY, FX, FY, _build_map, _Cam

torch.set_num_threads(2)
F64 = dict(device="cpu", dtype=torch.float64)
STATE = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


def _pair(seed=0):
    """tpuslam's map, the port's copy of it and both calibrations."""
    jm, jcalib, kfs, *_ = _build_map(np.random.RandomState(seed))
    calib = ImuCalib(noise_gyro=jcalib.noise_gyro, noise_acc=jcalib.noise_acc,
                     walk_gyro=jcalib.walk_gyro, walk_acc=jcalib.walk_acc, freq=jcalib.freq)
    return jm, map_from_numpy(*map_state(jm)), jcalib, calib, kfs


def _cam():
    return Pinhole([FX, FY, CX, CY], 400, 400)


def _same(jm, tm_, atol, fields=STATE + ("mp_pos",)):
    for f in fields:
        a, b = getattr(tm_, f), getattr(jm, f)
        n = tm_.n_kf if f.startswith("kf") else tm_.n_mp
        np.testing.assert_allclose(a[:n], b[:n], atol=atol, rtol=0, err_msg=f)


def _perturb(rng, ms, kfs):
    for k in kfs[1:]:
        dR = np.asarray(JL.so3_exp(jnp.asarray(rng.randn(3) * 0.01)))
        dt, dv = rng.randn(3) * 0.03, rng.randn(3) * 0.05
        for m in ms:
            m.kf_R[k] = dR @ m.kf_R[k]
            m.kf_t[k] = m.kf_t[k] + dt
            m.kf_vel[k] = m.kf_vel[k] + dv


def test_preintegrate_window_matches_tpuslam(rng):
    samples = np.column_stack([np.arange(1, 41) * 0.005, rng.randn(40, 3) * 0.1,
                               rng.randn(40, 3) + [0, 0, 9.81]])
    jcalib, calib = _pair()[2:4]
    bg, ba = rng.randn(3) * 1e-3, rng.randn(3) * 1e-2
    jpre, jraw = JEI.preintegrate_window(samples, 0.012, 0.1973, bg, ba, jcalib)
    tpre, traw = TEI.preintegrate_window(samples, 0.012, 0.1973, bg, ba, calib, device="cpu")
    for a, b in zip(traw, jraw):
        assert np.array_equal(a, b)
    for k in jpre:
        assert tpre[k].dtype == np.float32
        scale = max(float(np.abs(jpre[k]).max()), 1e-30)
        assert np.abs(tpre[k] - jpre[k]).max() <= 1e-5 * scale, k


@pytest.mark.parametrize("case", ["fixed_point", "perturbed", "temporal_window"])
def test_window_inertial_ba_matches_tpuslam(case):
    """tests/test_engine_vi.py's three window solves, f64, on both maps."""
    jm, tm_, jcalib, calib, kfs = _pair()
    if case == "perturbed":
        _perturb(np.random.RandomState(1), (jm, tm_), kfs)
    opt, fixed = (kfs[2:], kfs[:2]) if case == "temporal_window" else (kfs, [])
    kw = dict(opt_kfs=opt, fixed_kfs=fixed, n_iters=25 if case == "perturbed" else 8,
              fix_first=case != "temporal_window")
    JEI.window_inertial_ba(jm, _Cam(), jcalib, np.ones(8), **kw)
    TEI.window_inertial_ba(tm_, _cam(), calib, np.ones(8), **kw, **F64)
    _same(jm, tm_, 1e-7)
    assert tm_.map_version == jm.map_version
    # tpuslam's own gates on the port's result
    assert np.abs(tm_.kf_bg[kfs]).max() < 1e-3 and np.abs(tm_.kf_ba[kfs]).max() < 5e-2


def test_full_and_local_inertial_ba_match_tpuslam():
    jm, tm_, jcalib, calib, kfs = _pair()
    _perturb(np.random.RandomState(2), (jm, tm_), kfs)
    JEI.full_inertial_ba(jm, _Cam(), jcalib, np.ones(8), n_iters=12)
    TEI.full_inertial_ba(tm_, _cam(), calib, np.ones(8), n_iters=12, **F64)
    _same(jm, tm_, 1e-7)
    JEI.local_inertial_ba(jm, kfs[-1], _Cam(), jcalib, np.ones(8), window=4)
    TEI.local_inertial_ba(tm_, kfs[-1], _cam(), calib, np.ones(8), window=4, **F64)
    _same(jm, tm_, 1e-7)


def _to_visual_frame(m, kfs, R_vw, s):
    """Move a metric map into a rotated visual frame scaled by 1 / s (what a
    mono map is before IMU init): X' = R_vw X / s."""
    for k in kfs:
        m.kf_R[k] = m.kf_R[k] @ R_vw.T
        m.kf_t[k] = m.kf_t[k] / s
        m.kf_vel[k] = 0.0
    n = m.n_mp
    m.mp_pos[:n] = m.mp_pos[:n] @ R_vw.T / s


def test_run_imu_init_matches_tpuslam():
    jm, tm_, jcalib, calib, kfs = _pair()
    R_vw = np.asarray(JL.so3_exp(jnp.asarray([0.25, -0.15, 0.4])))
    for m in (jm, tm_):
        _to_visual_frame(m, kfs, R_vw, 2.5)
    # 1.75 s of gentle arc leave log s weakly observed: both defer at the
    # default observability gate, and both initialize once it is lifted
    assert not JEI.run_imu_init(jm, jcalib, mono=True)
    assert not TEI.run_imu_init(tm_, calib, mono=True, device="cpu")
    _same(jm, tm_, 0.0)
    assert JEI.run_imu_init(jm, jcalib, mono=True, max_logs_sigma=10.0)
    assert TEI.run_imu_init(tm_, calib, mono=True, max_logs_sigma=10.0, device="cpu")
    assert tm_.imu_initialized and tm_.map_version == jm.map_version
    _same(jm, tm_, 1e-5)
    # the map is metric again: the keyframes' spacing is the truth's
    def steps(m, R, t):
        c = np.array([-R[k].T @ t[k] for k in kfs])
        return np.median(np.linalg.norm(np.diff(c, axis=0), axis=1))

    truth = _pair()[0]
    assert abs(steps(tm_, tm_.kf_R, tm_.kf_t) / steps(truth, truth.kf_R, truth.kf_t) - 1) < 0.02
    # refinement (biases pinned) agrees too
    JEI.run_imu_init(jm, jcalib, mono=True, opt_bias=False)
    TEI.run_imu_init(tm_, calib, mono=True, opt_bias=False, device="cpu")
    _same(jm, tm_, 1e-5)


def _closers(jm, tm_, jcalib, calib):
    descs = (np.random.RandomState(3).rand(120, 256) > 0.5).astype(np.uint8)
    jcfg = JSlamConfig(loop=JLoopConfig(background_gba=False))
    cfg = SlamConfig(loop=LoopConfig(background_gba=False))
    from tpuslam.cameras import Pinhole as JPinhole

    jcam = JPinhole([FX, FY, CX, CY], 400, 400)
    jlc = JLoopCloser(jcam, jcfg, jm, j_train_vocabulary(descs, k=5, L=2, iters=3),
                      local_mapper=JLocalMapper(jcam, jcfg, jm, imu_calib=jcalib, mono=True))
    lm = LocalMapper(_cam(), cfg, tm_, imu_calib=calib, mono=True, **F64)
    tlc = LoopCloser(_cam(), cfg, tm_, train_vocabulary(descs, k=5, L=2, iters=3, device="cpu"),
                     local_mapper=lm, **F64)
    return jlc, tlc


def _add_child_kf(m, parent, t_new, v_new):
    P = m.n_feat
    f = FrameFeatures(xy=np.zeros((P, 2)), und_xy=np.zeros((P, 2)), norm_xy=np.zeros((P, 2)),
                      octave=np.zeros(P, np.int32), angle=np.zeros(P), response=np.ones(P),
                      bits=np.zeros((P, 256), np.uint8), packed=np.zeros((P, 8), np.uint32),
                      valid=np.zeros(P, bool))
    knew = m.add_keyframe(m.kf_R[parent].copy(), t_new, f, 99.0, 99)
    m.kf_parent[knew] = parent
    m.kf_vel[knew] = v_new
    return knew


def test_inertial_gba_routes_solves_and_stages_like_tpuslam():
    """tests/test_gba_inertial.py's scenario on both sides: the snapshot is
    the FullInertialBA, the chunked solve (21 iterations) agrees with
    tpuslam's, and the apply stages velocities and biases; a keyframe made
    during the solve rides its parent's correction."""
    jm, tm_, jcalib, calib, kfs = _pair()
    rng = np.random.RandomState(4)
    for m in (jm, tm_):
        m.imu_initialized = m.inertial_ba1 = m.inertial_ba2 = True
    gt = {f: getattr(tm_, f)[kfs].copy() for f in ("kf_R", "kf_t", "kf_vel")}
    _perturb(rng, (jm, tm_), kfs)
    pts = tm_.valid_mp_ids()
    dX = rng.randn(len(pts), 3) * 0.02
    jm.mp_pos[pts] += dX
    tm_.mp_pos[pts] += dX
    jlc, tlc = _closers(jm, tm_, jcalib, calib)
    jsnap, tsnap = jlc._snapshot_gba(fix_kf=kfs[0]), tlc._snapshot_gba(fix_kf=kfs[0])
    assert tsnap["kind"] == jsnap["kind"] == "vi"
    assert np.array_equal(tsnap["kfs"], jsnap["kfs"]) and np.array_equal(tsnap["fixed"],
                                                                         jsnap["fixed"])
    v_new = np.array([0.3, -0.1, 0.2])
    knew = [_add_child_kf(m, kfs[-1], m.kf_t[kfs[-1]] + [0.05, 0.0, 0.0], v_new)
            for m in (jm, tm_)]
    R_old = tm_.kf_R[kfs[-1]].copy()
    jsol, tsol = jlc._solve_gba_vi(jsnap, n_iters=21), tlc._solve_gba_vi(tsnap, n_iters=21)
    assert len(tsol) == len(jsol) == 6
    for a, b in zip(tsol, jsol):
        np.testing.assert_allclose(a, b[:len(a)], atol=1e-7)
    jlc._apply_gba(jsnap, jsol)
    tlc._apply_gba(tsnap, tsol)
    _same(jm, tm_, 1e-7)
    assert np.abs(tm_.kf_R[kfs] - gt["kf_R"]).max() < 5e-3
    assert np.abs(tm_.kf_t[kfs] - gt["kf_t"]).max() < 1e-2
    assert np.abs(tm_.kf_vel[kfs] - gt["kf_vel"]).max() < 6e-2
    np.testing.assert_allclose(tm_.kf_vel[knew[1]], tm_.kf_R[kfs[-1]].T @ R_old @ v_new,
                               atol=1e-9)


def test_multi_rank_vi_ba_is_distribution():
    """In a process group of more than one rank, window_inertial_ba with
    DIST_VIBA_MIN_OBS = 0 routes its solve to the distributed FullInertialBA
    (rank 0 dispatches, rank 1 serves) and lands within 5e-3 of the
    single-rank route (tests/test_dist_viba.py::test_engine_routes_to_dist_viba,
    its map from seed 7)."""
    _, tm_, _, calib, kfs = _pair(7)
    state = map_state(tm_)
    TEI.window_inertial_ba(tm_, _cam(), calib, np.ones(8), opt_kfs=kfs, fixed_kfs=[],
                           n_iters=12, fix_first=True, **F64)
    lead, follower = launch.run(jobs.window_viba, 2, args=(state, _cam(), calib, kfs, 12),
                                timeout=120.0)
    assert lead["viba"] == follower["served"] == 1
    assert lead["foreign"] == follower["foreign"] == []
    for i, k in enumerate(kfs):
        assert np.abs(tm_.kf_t[k] - lead["kf_t"][i]).max() < 5e-3, k
        assert np.abs(tm_.kf_R[k] - lead["kf_R"][i]).max() < 5e-3, k


def test_inertial_gba_over_ranks_lands_on_the_single_rank_route():
    """The loop closer's chunked FullInertialBA (tests/test_gba_inertial.py's
    scenario, 21 iterations in 3 chunks) in a group of 2 ranks with
    DIST_VIBA_MIN_OBS = 0: each chunk is a distributed solve, and the
    solved states land within 5e-3 of the single-rank route's."""
    _, tm_, _, calib, kfs = _pair()
    tm_.imu_initialized = tm_.inertial_ba1 = tm_.inertial_ba2 = True
    _perturb(np.random.RandomState(4), (tm_,), kfs)
    state = map_state(tm_)
    lc = jobs.inertial_closer(state, _cam(), calib)
    single = lc._solve_gba_vi(lc._snapshot_gba(fix_kf=kfs[0]), n_iters=21)
    lead, follower = launch.run(jobs.inertial_gba, 2, args=(state, _cam(), calib, kfs[0], 21),
                                timeout=120.0)
    assert lead["viba"] == follower["served"] == 3
    assert lead["foreign"] == follower["foreign"] == []
    for name, a, b in zip(("R", "t", "X", "v", "bg", "ba"), lead["solved"], single):
        assert np.abs(a - b).max() < 5e-3, name


def test_map_state_carries_the_inertial_fields():
    jm, tm_, *_ = _pair()
    back = map_from_numpy(*map_state(tm_))
    for k in range(1, tm_.n_kf):
        for name in jm.kf_preint[k]:
            assert np.array_equal(back.kf_preint[k][name], jm.kf_preint[k][name])
        for a, b in zip(back.kf_imu[k], jm.kf_imu[k]):
            assert np.array_equal(a, b)
    assert back.kf_preint[0] is None and len(back.kf_imu) == len(back.kf_R)


# ------------------------------------------------------------------ IMU guards
def _guard_system(rng, sensor=Sensor.IMU_MONOCULAR, **cfg_kw):
    cam = Pinhole([200.0, 200.0, 100.0, 75.0], 200, 150)
    slam = System(cam, SlamConfig(orb=OrbConfig(n_features=300), **cfg_kw), sensor=sensor,
                  imu_calib=ImuCalib(), bf=20.0 if sensor == Sensor.IMU_STEREO else 0.0,
                  device="cpu")
    return slam, (rng.rand(150, 200) * 255).astype(np.float32)


def _fake_last_frame(tr, t, fid):
    f = FrameFeatures(xy=np.zeros((4, 2)), und_xy=np.zeros((4, 2)), norm_xy=np.zeros((4, 2)),
                      octave=np.zeros(4, np.int32), angle=np.zeros(4), response=np.ones(4),
                      bits=np.zeros((4, 256), np.uint8), packed=np.zeros((4, 8), np.uint32),
                      valid=np.ones(4, bool))
    tr.state = State.OK
    tr.last_frame = Frame(f, t, fid, R=np.eye(3), t=np.zeros(3), mp=np.full(4, -1, np.int32))


def test_backwards_timestamp_resets(rng):
    slam, img = _guard_system(rng)
    slam.track_monocular(img, 0.0, imu=np.zeros((0, 7)))
    _fake_last_frame(slam.tracker, 5.0, 1)
    slam.track_monocular(img, 4.0, imu=np.zeros((0, 7)))
    assert slam.tracker.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED)


def test_imu_gap_resets_or_opens_a_map(rng):
    """A > 1 s gap: an immature inertial map resets in place, a mature one
    (IMU initialized, VIBA1 done) opens a new Atlas map."""
    slam, img = _guard_system(rng)
    tr = slam.tracker
    slam.track_monocular(img, 0.0, imu=np.zeros((0, 7)))
    _fake_last_frame(tr, 1.0, 1)
    slam.track_monocular(img, 3.0, imu=np.zeros((0, 7)))
    assert tr.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED)
    _fake_last_frame(tr, 10.0, 2)
    slam.map.imu_initialized = slam.map.inertial_ba1 = True
    before = slam.map.current_map_id
    slam.track_monocular(img, 13.0, imu=np.zeros((0, 7)))
    assert slam.map.current_map_id != before


def test_bad_imu_flag_resets_active_map(rng):
    slam, img = _guard_system(rng)
    slam.track_monocular(img, 0.0, imu=np.zeros((0, 7)))
    slam.tracker.state = State.OK
    slam.map.bad_imu = True
    slam.track_monocular(img, 0.1, imu=np.zeros((0, 7)))
    assert not slam.map.bad_imu
    assert slam.tracker.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED)


def test_imu_init_scale_gate(monkeypatch):
    """A scale under 0.1 refuses the init and raises bad_imu (tpuslam's
    LocalMapping.cc:1314 gate), on a 3-keyframe chain."""
    m = SlamMap(n_feat=8)
    f = FrameFeatures(xy=np.zeros((8, 2)), und_xy=np.zeros((8, 2)), norm_xy=np.zeros((8, 2)),
                      octave=np.zeros(8, np.int32), angle=np.zeros(8), response=np.ones(8),
                      bits=np.zeros((8, 256), np.uint8), packed=np.zeros((8, 8), np.uint32),
                      valid=np.ones(8, bool))
    calib = ImuCalib()
    prev = -1
    for k in range(3):
        kf = m.add_keyframe(np.eye(3), np.array([0.1 * k, 0, 0]), f, 0.5 * k, k)
        m.kf_prev[kf] = prev
        if prev >= 0:
            samples = [[0.5 * (k - 1) + 0.1 * i, 0, 0, 0, 0.2, 0, 9.81] for i in range(1, 6)]
            m.kf_preint[kf], m.kf_imu[kf] = TEI.preintegrate_window(
                samples, 0.5 * (k - 1), 0.5 * k, np.zeros(3), np.zeros(3), calib, device="cpu")
        prev = kf

    def fake_solve(*a, **k):
        return {n: torch.as_tensor(v) for n, v in dict(
            scale=0.05, Rwg=np.eye(3), v=np.zeros((3, 3)), bg=np.zeros(3), ba=np.zeros(3),
            cost=0.0, logs_sigma=0.01).items()}

    monkeypatch.setattr(TEI, "inertial_init_solve", fake_solve)
    assert not TEI.run_imu_init(m, calib, mono=True, device="cpu")
    assert m.bad_imu and not m.imu_initialized


def test_stereo_imu_low_accel_refusal(rng):
    """Stereo-inertial initialization waits while |a| shows no excitation
    (tpuslam's gate: std |a| >= 0.25 m/s^2 over the raw samples)."""
    slam, img = _guard_system(rng, Sensor.IMU_STEREO,
                              tracking=TrackingConfig(min_stereo_init_features=1))
    imu = np.array([[0.01 * i, 0, 0, 0, 0.0, 0.0, 9.81] for i in range(1, 30)])
    slam.track_stereo(img, np.roll(img, 3, axis=1), 0.3, imu=imu)
    assert slam.tracker.state != State.OK
    assert len(slam.map.valid_kf_ids()) == 0


@pytest.mark.parametrize("kind", ["forward_arc", "vi_excite", "loop"])
def test_no_rendered_sequence_excites_the_stereo_inertial_gate(kind):
    """Why stereo-inertial has no end-to-end run: over 8 s of every
    trajectory kind of the renderer, the std of |a| stays far below the
    0.25 m/s^2 gate that tpuslam and the port share (the motion is lateral
    to gravity and hardly changes |a|), and the reference's own form of the
    gate (the mean acceleration of consecutive frame windows differing by
    0.5 m/s^2, Tracking.cc:1363) fails as well."""
    seq = SyntheticSequence(n_frames=80, fps=10, speed=0.5, imu_rate=200.0, kind=kind)
    times = seq.timestamps()
    norms, avg_a = [], []
    for t0, t1 in zip(times[:-1], times[1:]):
        ts, ws, accs = seq.imu_between(t0, t1)
        dts = np.diff(np.concatenate([[t0], ts]))
        pre = TP.preintegrate(*(torch.as_tensor(x) for x in (ws, accs, dts)),
                              torch.zeros(3, dtype=torch.float64),
                              torch.zeros(3, dtype=torch.float64), 0.0, 0.0, 0.0, 0.0)
        avg_a.append(pre["dV"].numpy() / float(pre["dT"]))
        norms.append(np.linalg.norm(accs, axis=1))
    assert np.std(np.concatenate(norms)) < 0.02
    assert np.linalg.norm(np.diff(avg_a, axis=0), axis=1).max() < 0.1
