"""The inertial mapper's whole schedule at System level: the port against
tpuslam, on the CPU.

scripts/vi_f32_experiment.py's run (vi_excite at 0.3 m/s, 376x240, 600
features, IMU at 200 Hz, a keyframe at least every 3 frames) with the
schedule's times shortened (scripts/vi_f32_experiment_torch.py's
SHORT_SCHEDULE: VIBA1 0.5 s and VIBA2 1.0 s after the IMU init for the
reference's 5 s and 15 s, every other InertialConfig field at its default;
chip_smoke.py's phase 15 uses the same), so that within N_SCHEDULE frames
the mapper runs every branch of its IMU stage: the init, the scale
refinements (a joint full inertial BA, then run_imu_init(mono=True,
opt_bias=False)), VIBA1 (priors 1 / 1e5), VIBA2 (zero bias priors) and then
the local inertial BAs with zero priors.

  * The schedule in lockstep: tpuslam's IMU_MONOCULAR System and the port's
    (f64, as tpuslam runs here) on the same frames and IMU samples, the
    port's two-view draw tpuslam's own (tests/test_torch_vi_system.py's
    jax_draw); tpuslam's run is read from its record (tests/torch_records.py,
    written by tests/make_tpuslam_records.py) and compared frame by frame. Every frame the same tracking state; up to LOCKSTEP also the
    keyframe count and the poses (1 cm, 0.2 degrees). There they part on a
    borderline decision: on frame 7 keyframe 2's fuse predicts the level
    of point 104 in keyframe 0 as ceil(log(1.44) / log(1.2)) on a ratio
    that is exactly 1.44 in f32; torch's f32 log gives 2.0000002 (level
    3), XLA's 2.0 (level 2), so the port fuses 104 onto a level-4 feature
    that held point 273 and tpuslam onto a level-2 one. With one point
    fewer behind the reference keyframe, on frame 11 both track 172
    inliers: tpuslam makes a keyframe (172 < 0.9 x 192 = 172.8), the port
    does not (172 >= 0.9 x 191 = 171.9). Both record imu_init,
    viba1 and viba2 in that order, each within 0.3 s of the other
    package's; their scale refinements (counted by wrapping run_imu_init)
    agree within 1; each runs at least 3 local inertial BAs with zero
    priors after VIBA2. At the end each is OK with inertial_ba2 set, a
    scaled ATE under 0.15 (the script's gate), |R[2, 2]| > 0.99, finite
    keyframe poses, velocities and biases, a largest |R^T R - I| under
    1e-4, and the two Horn scales within 10 % of each other.
  * Each branch on the same inputs, past the frame where the runs part:
    tpuslam's map and mapper state just before its first init, scale
    refinement, VIBA1, VIBA2 and zero-prior local inertial BA are carried
    into the port, whose branch then lands on tpuslam's keyframe states,
    points, gravity alignment and scale at the solvers' tolerance (TOL).
  * The script's own cases (its lines, --stereo, tpuslam's --stereo fault)
    are in tests/test_torch_vi_schedule_script.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine import inertial as j_inertial
from tpuslam.engine.config import InertialConfig as JInertialConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import inertial as t_inertial
from tpuslam_torch.engine import local_mapping
from tpuslam_torch.engine.config import InertialConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.eval.ate import ate_rmse, horn_align
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.map.store import SlamMap, map_from_numpy, map_state
from tpuslam_torch.ops import twoview

from test_torch_vi_system import NOISE, _gt_centers, _imu, _rot_deg, jax_draw
import torch_records
import torch_vi_merge_state

torch.set_num_threads(2)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import vi_f32_experiment_torch as script  # noqa: E402

SCHEDULE = script.SHORT_SCHEDULE
N_SCHEDULE = 50
LOCKSTEP = 11
EVENTS = ["imu_init", "viba1", "viba2"]
BRANCHES = ["imu_init", "refinement", "viba1", "viba2", "zero_prior_local_ba"]
SCHEDULE_STATE = ("imu_init_time", "viba_stage", "_last_refine")
KF_STATE = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")
# same-input agreement of a branch, f64 on both sides: rotations (rad-like),
# metres, m/s, the biases, the map points (up to ~10 m deep after the
# init's x4.6 rescale) and the relative scale of a gravity alignment
TOL = dict(kf_R=1e-9, kf_t=1e-8, kf_vel=1e-8, kf_bg=1e-9, kf_ba=1e-9, mp_pos=1e-6, scale=1e-8)


def _config():
    """The script's configuration with the shortened schedule, tpuslam's and
    the port's."""
    return (JSlamConfig(orb=JOrbConfig(n_features=600),
                        tracking=JTrackingConfig(max_frames_between_kf=3,
                                                 min_stereo_init_features=200),
                        inertial=JInertialConfig(**SCHEDULE)),
            SlamConfig(orb=OrbConfig(n_features=600),
                       tracking=TrackingConfig(max_frames_between_kf=3,
                                               min_stereo_init_features=200),
                       inertial=InertialConfig(**SCHEDULE)))


def _scaled_rotations(mp, cls, got):
    """Wrap cls.apply_scaled_rotation (the gravity alignment and rescale of
    an IMU init or a scale refinement); append each call's (Rwg, s) to got."""
    real = cls.apply_scaled_rotation

    def spied(self, Rwg, s, velocities=None):
        got.append((np.array(Rwg, np.float64), float(s)))
        return real(self, Rwg, s, velocities=velocities)

    mp.setattr(cls, "apply_scaled_rotation", spied)


def _keep_branches(mapper, rotations, branches):
    """Wrap tpuslam's mapper: for the first IMU stage that takes each branch
    of the schedule (the init, a scale refinement, VIBA1, VIBA2) and the
    first local inertial BA with zero bias priors, keep the keyframe, the
    map and schedule state before the call (its inputs), and after it
    tpuslam's map, schedule state and gravity alignments (its result)."""
    stage, local_ba = mapper._imu_stage, mapper._local_inertial_ba

    def state():
        return map_state(mapper.map), {k: getattr(mapper, k) for k in SCHEDULE_STATE}

    def kept(name, kf, before, n_rot):
        branches.setdefault(name, dict(kf=kf, before=before, after=state(),
                                       rotations=rotations[n_rot:]))

    def staged(kf):
        before, n_ev, n_rot = state(), len(mapper.debug_events), len(rotations)
        stage(kf)
        if len(mapper.debug_events) > n_ev:
            kept(mapper.debug_events[-1]["event"], kf, before, n_rot)
        elif mapper._last_refine != before[1]["_last_refine"]:
            kept("refinement", kf, before, n_rot)

    def zero_prior_local_ba(kf, hold=None):
        if not mapper.map.inertial_ba2 or "zero_prior_local_ba" in branches:
            return local_ba(kf, hold=hold)
        before, n_rot = state(), len(rotations)
        local_ba(kf, hold=hold)
        kept("zero_prior_local_ba", kf, before, n_rot)

    mapper._imu_stage, mapper._local_inertial_ba = staged, zero_prior_local_ba


def _spy(mp, module, name, calls, key):
    """Wrap module.name; record each call's keyword arguments that the tests
    read (opt_bias, prior_g, prior_a) under key."""
    real = getattr(module, name)

    def spied(*a, **kw):
        calls[key].append({k: kw[k] for k in ("opt_bias", "prior_g", "prior_a") if k in kw})
        return real(*a, **kw)

    mp.setattr(module, name, spied)


def _end_state(slam):
    """What test_schedule_end_state reads of a System after its run."""
    m = slam.map
    kfs = m.valid_kf_ids()
    return dict(state=slam.get_tracking_state().name,
                flags=(m.imu_initialized, m.inertial_ba1, m.inertial_ba2),
                traj=slam.trajectory_tum(), n_kfs=len(kfs),
                finite={f: bool(np.isfinite(np.asarray(getattr(m, f))[kfs]).all())
                        for f in KF_STATE},
                orth=script.orthonormality_error(m))


def _tpuslam_run():
    """tpuslam's IMU_MONOCULAR System over the script's sequence (in a
    process of its own): per frame its pose, state, keyframe count and IMU
    flag; its IMU inits and local inertial BAs (their keyword arguments);
    each branch's inputs and result (_keep_branches); its events and end
    state."""
    seq = script.sequence(N_SCHEDULE, stereo=False)
    js = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                 _config()[0], sensor=JSensor.IMU_MONOCULAR, imu_calib=JImuCalib(**NOISE))
    times = seq.timestamps()
    calls = {"jax_init": [], "jax_lba": []}
    out, rotations, branches = dict(T=[], state=[], n_kf=[], init=[]), [], {}
    _keep_branches(js.local_mapper, rotations, branches)
    with pytest.MonkeyPatch.context() as mp:
        _scaled_rotations(mp, JSlamMap, rotations)
        # tpuslam's mapper imports these from engine.inertial at each call
        _spy(mp, j_inertial, "run_imu_init", calls, "jax_init")
        _spy(mp, j_inertial, "local_inertial_ba", calls, "jax_lba")
        for i in range(N_SCHEDULE):
            out["T"].append(js.track_monocular(seq.frame(i), times[i], imu=_imu(seq, times, i)))
            out["state"].append(js.get_tracking_state().name)
            out["n_kf"].append(len(js.map.valid_kf_ids()))
            out["init"].append(js.map.imu_initialized)
    return dict(out, calls=calls, branches=_pack(branches),
                events=list(js.local_mapper.debug_events), end=_end_state(js))


def _pack(branches):
    """The branches with their map states in tests/torch_vi_merge_state.py's
    layout (one table of the keyframes' features, the bits packed)."""
    states = torch_vi_merge_state.pack({f"{b}.{w}.": rec[w][0] for b, rec in branches.items()
                                        for w in ("before", "after")})
    return dict(states=states, rest={b: dict(rec, before=rec["before"][1], after=rec["after"][1])
                                     for b, rec in branches.items()})


def _unpack(packed):
    """_pack's branches back as _keep_branches keeps them."""
    return {b: dict(rec, **{w: (torch_vi_merge_state.unpack(packed["states"], f"{b}.{w}."),
                                rec[w])
                            for w in ("before", "after")})
            for b, rec in packed["rest"].items()}


def _record_inputs():
    """Fingerprints of the inputs of tpuslam's recorded run (tests/torch_records.py)."""
    return {"frames": torch_records.sequence_fingerprint(
        script.sequence(N_SCHEDULE, stereo=False), N_SCHEDULE)}


@pytest.fixture(scope="module")
def schedule_runs():
    """tpuslam's and the port's IMU_MONOCULAR Systems in lockstep over the
    script's sequence with the shortened schedule, tpuslam's from its record
    (tests/torch_records.py), compared frame by frame afterwards."""
    jax_side = torch_records.recorded("vi_schedule", _record_inputs())
    seq = script.sequence(N_SCHEDULE, stereo=False)
    ts = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), _config()[1],
                sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(**NOISE), dtype=torch.float64,
                device="cpu")
    times = seq.timestamps()
    calls = {"port_init": [], "port_lba": []}
    port = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twoview, "draw_samples", jax_draw)
        # the port's mapper binds these when engine.local_mapping is imported
        _spy(mp, local_mapping, "run_imu_init", calls, "port_init")
        _spy(mp, local_mapping, "local_inertial_ba", calls, "port_lba")
        for i in range(N_SCHEDULE):
            Tt = ts.track_monocular(seq.frame(i), times[i], imu=_imu(seq, times, i))
            port.append((Tt, ts.get_tracking_state().name, len(ts.map.valid_kf_ids()),
                         ts.map.imu_initialized))
    ts.shutdown()
    j = jax_side.result()
    steps = [dict(T=(j["T"][i], Tt), state=(j["state"][i], state), n_kf=(j["n_kf"][i], n_kf),
                  init=(j["init"][i], init))
             for i, (Tt, state, n_kf, init) in enumerate(port)]
    return dict(seq=seq, steps=steps, calls=dict(calls, **j["calls"]),
                branches=_unpack(j["branches"]),
                events={"jax": j["events"], "port": list(ts.local_mapper.debug_events)},
                end={"jax": j["end"], "port": _end_state(ts)})


def test_schedule_lockstep(schedule_runs):
    parted = None
    for i, s in enumerate(schedule_runs["steps"]):
        assert s["state"][1] == s["state"][0], i
        Tj, Tt = s["T"]
        assert (Tt is None) == (Tj is None), i
        same = s["n_kf"][0] == s["n_kf"][1] and s["init"][0] == s["init"][1]
        if Tj is not None:
            same = same and np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01 \
                and _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2
        if not same and parted is None:
            parted = i
    print(f"the two Systems first part on frame {parted}")
    assert parted is None or parted >= LOCKSTEP, parted


def test_schedule_events_match_tpuslam(schedule_runs):
    ev_j, ev_t = schedule_runs["events"]["jax"], schedule_runs["events"]["port"]
    print("tpuslam", [(e["event"], e["t"]) for e in ev_j])
    print("port   ", [(e["event"], e["t"]) for e in ev_t])
    assert [e["event"] for e in ev_j] == EVENTS
    assert [e["event"] for e in ev_t] == EVENTS
    for a, b in zip(ev_j, ev_t):
        assert abs(a["t"] - b["t"]) <= 0.3 + 1e-9, (a, b)
    assert [set(e) for e in ev_t] == [set(e) for e in ev_j]
    calls = schedule_runs["calls"]
    refine = {k: sum(1 for kw in calls[f"{k}_init"] if kw.get("opt_bias") is False)
              for k in ("jax", "port")}
    print("scale refinements", refine)
    assert min(refine.values()) >= 1 and abs(refine["jax"] - refine["port"]) <= 1, refine
    for k in ("jax", "port"):
        zero = [kw for kw in calls[f"{k}_lba"] if kw["prior_g"] == 0.0 and kw["prior_a"] == 0.0]
        # the zero-prior local BAs come only after VIBA2, every one of them
        n_before = sum(1 for kw in calls[f"{k}_lba"] if kw["prior_g"] > 0.0)
        assert calls[f"{k}_lba"][n_before:] == zero, k
        print(f"{k}: {len(zero)} local inertial BAs with zero priors after VIBA2")
        assert len(zero) >= 3, (k, len(zero))


@pytest.mark.parametrize("name", ["jax", "port"])
def test_schedule_end_state(schedule_runs, name):
    seq, end = schedule_runs["seq"], schedule_runs["end"][name]
    assert end["state"] == "OK"
    assert all(end["flags"])      # imu_initialized, inertial_ba1, inertial_ba2
    traj = end["traj"]
    est = np.array([r[1:4] for r in traj])
    gt = _gt_centers(seq, traj)
    rmse, scale = ate_rmse(est, gt, with_scale=True)
    R, _, s, _ = horn_align(est, gt, with_scale=True)
    other = schedule_runs["end"]["port" if name == "jax" else "jax"]["traj"]
    s_other = horn_align(np.array([r[1:4] for r in other]), _gt_centers(seq, other),
                         with_scale=True)[2]
    orth = end["orth"]
    print(f"{name}: scaled ATE {rmse:.4f} m, Horn scale {s:.4f}, |R[2,2]| {abs(R[2, 2]):.6f}, "
          f"max |R^T R - I| {orth:.3e} over {end['n_kfs']} keyframes")
    assert rmse < 0.15, rmse
    assert abs(s / s_other - 1.0) < 0.1, (s, s_other)
    assert abs(R[2, 2]) > 0.99, R
    for field in KF_STATE:
        assert end["finite"][field], field
    assert orth < 1e-4, orth


def _tpuslams_reintegrations(mp, after, diffs):
    """Wrap the port's reintegrate_kf (a refinement re-runs the f32
    preintegration of every window whose bias moved): keep the port's own
    result's largest difference from tpuslam's, relative to each quantity's
    size, then hand the solver tpuslam's preintegration, so that what is
    compared next is the solvers alone."""
    real = t_inertial.reintegrate_kf

    def swapped(m, kf, calib, device):
        real(m, kf, calib, device)
        theirs = {k: np.asarray(v) for k, v in after["kf_preint"][kf].items()}
        diffs.append(max(float(np.abs(np.asarray(m.kf_preint[kf][k], np.float64) - v).max())
                         / max(float(np.abs(v).max()), 1e-30) for k, v in theirs.items()))
        m.kf_preint[kf] = theirs

    mp.setattr(t_inertial, "reintegrate_kf", swapped)


@pytest.mark.parametrize("branch", BRANCHES)
def test_schedule_branch_on_tpuslams_inputs(schedule_runs, branch):
    """Each branch of the schedule on the same inputs: tpuslam's map and
    mapper state just before the branch ran in the lockstep run, carried into
    the port (map_state / map_from_numpy), then the port's branch, both f64.
    Where the branch re-runs a window's f32 preintegration (a refinement
    does, for every window), the port's agrees with tpuslam's to f32
    rounding (1e-5 of each quantity, as test_torch_vi_engine's
    preintegrate_window check) and the solve then takes tpuslam's: on its
    own the rounding moves a refinement's scale by ~1.6e-5. The keyframe
    poses, velocities and biases, the map points, the gravity alignment and
    scale of an init or a refinement, and the schedule state after it agree
    with tpuslam's to TOL."""
    rec = schedule_runs["branches"][branch]
    seq = schedule_runs["seq"]
    (after, _), schedule = rec["after"]
    m = map_from_numpy(*rec["before"][0])
    mapper = LocalMapper(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                         _config()[1], m, imu_calib=ImuCalib(**NOISE), mono=True, device="cpu",
                         dtype=torch.float64)
    for k, v in rec["before"][1].items():
        setattr(mapper, k, v)
    rotations, preint = [], []
    with pytest.MonkeyPatch.context() as mp:
        _scaled_rotations(mp, SlamMap, rotations)
        _tpuslams_reintegrations(mp, after, preint)
        if branch == "zero_prior_local_ba":
            mapper._local_inertial_ba(rec["kf"])
        else:
            mapper._imu_stage(rec["kf"])
    assert {k: getattr(mapper, k) for k in SCHEDULE_STATE} == schedule
    for f in ("imu_initialized", "inertial_ba1", "inertial_ba2", "bad_imu"):
        assert getattr(m, f) == after[f], f
    chain = m.temporal_chain()
    assert len(chain) >= 10
    worst = {f: float(np.abs(getattr(m, f)[chain] - after[f][chain]).max()) for f in KF_STATE}
    pts = np.flatnonzero(after["mp_valid"][: m.n_mp])
    worst["mp_pos"] = float(np.abs(m.mp_pos[pts] - after["mp_pos"][pts]).max())
    moved = {f: float(np.abs(after[f][chain] - rec["before"][0][0][f][chain]).max())
             for f in KF_STATE}
    print(f"{branch} on keyframe {rec['kf']} ({len(chain)} keyframes, {len(pts)} points, "
          f"{len(preint)} windows reintegrated, the port's within {max(preint, default=0):.2g} "
          f"of tpuslam's): port vs tpuslam {worst}; tpuslam moved them by {moved}")
    assert max(preint, default=0.0) <= 1e-5, preint
    assert preint or branch != "refinement"
    assert len(rotations) == len(rec["rotations"]) == (branch in ("imu_init", "refinement"))
    for (Rp, sp), (Rj, sj) in zip(rotations, rec["rotations"]):
        print(f"gravity alignment: |dRwg| {np.abs(Rp - Rj).max():.3g}, scale {sp:.12f} vs "
              f"{sj:.12f}")
        assert np.abs(Rp - Rj).max() < TOL["kf_R"] and abs(sp / sj - 1.0) < TOL["scale"]
    for f in worst:
        assert worst[f] < TOL[f], (f, worst[f], TOL[f])
