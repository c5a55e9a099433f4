"""The inertial merge after the young map's IMU init and VIBA1, replayed in
the port on tpuslam's inputs, on the CPU.

tests/data/vi_merge_b.npz (written by tests/make_vi_merge_data.py, which
says how) holds tpuslam's run of tests/torch_vi_merge.py's
`loop_sessions` up to its merge (376x240, 600 features, the short
schedule, f64): C initializes its IMU 2.6 s into C, runs VIBA1 and VIBA2,
and is merged into A on run frame 95 (keyframe 33 onto keyframe 1). The
file keeps tpuslam's map just before the `_try_loop(merge=True)` that
opened the merge's candidate and just before `_correct_loop(merge=True)`,
right after the visual-inertial weld BA and after the correction and its
synchronous GBA, with the closer's PRNG key, the BoW nodes and the
correction's arguments. Each state is carried into the port
(`map_from_numpy`) and the port's step runs on it in f64 with tpuslam's
RANSAC draws:

  * the detection: the same Sim3 before the gates, the same yaw
    projection (the rotation it removes, 0.164 rad), the same Sim3 kept and
    the same matched pairs;
  * the gates on the same inputs in both packages, with the Sim3 that the
    refinement returns replaced case by case: a scale outside (0.9, 1.1)
    after VIBA1 and before it, a rotation tilted 0.2 and 0.6 rad off the
    projection's axis, a map whose IMU is not initialized. The same
    decisions: rejected by the scale gate or the 0.35 rad check before the
    guided projection, or passed on to it with the same rotation;
  * the correction: the 4-DoF essential graph with A's keyframes fixed,
    the visual-inertial weld BA over the last 10 keyframes of the merged
    chain with the seam's old side fixed, and the FullInertialBA as the
    GBA land on tpuslam's keyframe poses, velocities and biases and points
    within TOL (tests/test_torch_vi_schedule.py's) after each;
  * tpuslam's yaw projection fault, in both packages (ROADMAP §3, listed,
    not repaired: the replay above holds the port to tpuslam's result).
    The Sim3 is camera-to-camera, and the gate projects its rotation onto
    the camera's optical axis, not the world correction onto gravity: on
    this merge the raw Sim3's world correction tilts gravity by 0.67
    degrees, the projected one by 1.34, and the candidate's refinement on
    the next keyframes brings back a full rotation (1.43 degrees).
"""

import os

import jax
import numpy as np
import pytest
import torch

import tpuslam.engine.loop_closing as j_loop
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine.config import InertialConfig as JInertialConfig
from tpuslam.engine.config import LoopConfig as JLoopConfig
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.local_mapping import LocalMapper as JLocalMapper
from tpuslam.imu.preintegration import ImuCalib as JImuCalib
from tpuslam.map.store import FrameFeatures as JFrameFeatures
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.place import load_orbvoc as j_load_orbvoc
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import loop_closing
from tpuslam_torch.engine.config import (InertialConfig, LoopConfig, OrbConfig, SlamConfig,
                                         TrackingConfig)
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.map.store import (ARRAY_FIELDS, GRAPH_FIELDS, INERTIAL_FIELDS,
                                     SCALAR_FIELDS, map_from_numpy, map_state)
from tpuslam_torch.place import load_orbvoc, save_orbvoc_text, train_vocabulary
from tpuslam_torch.solve import sim3 as t_sim3

import torch_vi_merge_state as state
from torch_vi_merge import (FEATURES, NOISE, SHORT_SCHEDULE, heave_sessions, joint_gates,
                            loop_sessions)

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "vi_merge_b.npz")
DATA_A = os.path.join(os.path.dirname(DATA), "vi_merge_a.npz")
# tests/test_torch_vi_schedule.py's: f64 solvers of both packages on the same inputs
TOL = dict(kf_R=1e-9, kf_t=1e-8, kf_vel=1e-8, kf_bg=1e-9, kf_ba=1e-9, mp_pos=1e-6)
SIM3_TOL = 1e-9
YAW_GATE = 0.35


@pytest.fixture(scope="module")
def data():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def rig(tmp_path_factory, data):
    """The sequence's camera and bf, and a vocabulary both closers can hold
    (the replayed steps never query it)."""
    seq = loop_sessions()[0]
    arrays, feats = state.unpack(data, "pre.")
    bits = np.concatenate([f["bits"][f["valid"]] for f in feats if f is not None][:4])
    voc = str(tmp_path_factory.mktemp("voc") / "voc.txt")
    save_orbvoc_text(train_vocabulary(bits, k=4, L=2, iters=2, device="cpu"), voc)
    return seq, voc


def _config(pkg):
    if pkg == "port":
        return SlamConfig(orb=OrbConfig(n_features=FEATURES),
                          tracking=TrackingConfig(max_frames_between_kf=3,
                                                  min_stereo_init_features=200),
                          loop=LoopConfig(background_gba=False),
                          inertial=InertialConfig(**SHORT_SCHEDULE))
    return JSlamConfig(orb=JOrbConfig(n_features=FEATURES),
                       tracking=JTrackingConfig(max_frames_between_kf=3,
                                                min_stereo_init_features=200),
                       loop=JLoopConfig(background_gba=False),
                       inertial=JInertialConfig(**SHORT_SCHEDULE))


def _tpuslam_map(arrays, feats):
    """tpuslam's SlamMap holding the state (map_from_numpy's steps)."""
    sf = np.asarray(arrays["scale_factors"])
    m = JSlamMap(int(arrays["kf_mp"].shape[1]), scale=float(sf[1]), n_levels=len(sf),
                 map_id=int(arrays["map_id"]))
    for k in ARRAY_FIELDS:
        setattr(m, k, np.array(arrays[k]))
    for k in GRAPH_FIELDS:
        setattr(m, k, [dict(d) if isinstance(d, dict) else d for d in arrays[k]])
    for k in SCALAR_FIELDS:
        setattr(m, k, arrays[k])
    cap = len(m.kf_R)
    m.kf_feats = [None if f is None else JFrameFeatures(**f) for f in feats]
    m.kf_feats += [None] * (cap - len(m.kf_feats))
    for k in INERTIAL_FIELDS:
        setattr(m, k, list(arrays[k]) + [None] * (cap - len(arrays[k])))
    m.rebuild_native()
    return m


def _closer(pkg, rig, arrays, feats):
    seq, voc = rig
    cam, bf = [seq.fx, seq.fy, seq.cx, seq.cy], seq.fx * seq.baseline
    if pkg == "port":
        camera, m = Pinhole(cam, seq.width, seq.height), map_from_numpy(arrays, feats)
        lm = LocalMapper(camera, _config(pkg), m, bf=bf, imu_calib=ImuCalib(**NOISE),
                         device="cpu", dtype=torch.float64)
        lc = loop_closing.LoopCloser(camera, _config(pkg), m, load_orbvoc(voc),
                                     fix_scale=True, local_mapper=lm, device="cpu",
                                     dtype=torch.float64)
    else:
        camera, m = JPinhole(cam, seq.width, seq.height), _tpuslam_map(arrays, feats)
        lm = JLocalMapper(camera, _config(pkg), m, imu_calib=JImuCalib(**NOISE), mono=False,
                          bf=bf)
        lc = j_loop.LoopCloser(camera, _config(pkg), m, j_load_orbvoc(voc), fix_scale=True,
                               local_mapper=lm)
    lm.loop_closer = lc
    return lc


class _draws:
    """tpuslam's Sim3 RANSAC draws for the port: its closer's key, split
    once per try."""

    def __init__(self, key):
        self.key = jax.numpy.asarray(key)

    def __call__(self, n_valid, n_hyp, generator=None):
        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))


def _tpuslams_yaw_only(kf, cand, s, R, t):
    """tpuslam's projection (loop_closing.py:263-278): R itself onto a
    rotation about the current camera's z axis, t kept."""
    yaw = np.arctan2(R[1, 0] - R[0, 1], R[0, 0] + R[1, 1])
    R_yaw = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                      [0.0, 0.0, 1.0]])
    return R_yaw, t, _removed(R, R_yaw)


def _try(pkg, rig, data, case=None, tpuslams_projection=False):
    """One package's _try_loop(merge=True) on tpuslam's state before the
    detection. case: (scale, tilt about the camera's x axis in rad,
    inertial_ba1, imu_initialized) put in place of what the refinement
    returns and of the map's flags; tpuslams_projection: the port projects
    as tpuslam does. Returns (the Sim3 before the gates, the result,
    whether the guided projection ran)."""
    arrays, feats = state.unpack(data, "try.")
    lc = _closer(pkg, rig, arrays, feats)
    if tpuslams_projection:
        lc._yaw_only = _tpuslams_yaw_only
    kf, cand = int(data["try_kf"]), int(data["try_cand"])
    lc.kf_nodes[kf], lc.kf_nodes[cand] = data["try_nodes_kf"], data["try_nodes_cand"]
    module = loop_closing if pkg == "port" else j_loop
    raw, proj = [None], [False]
    real_opt, real_proj = module.optimize_sim3, lc._search_by_projection

    def opt(*a, **kw):
        out = list(real_opt(*a, **kw))
        if case is not None:
            s, tilt = case[0], case[1]
            c, si = np.cos(tilt), np.sin(tilt)
            Rx = np.array([[1.0, 0.0, 0.0], [0.0, c, -si], [0.0, si, c]])
            R = np.asarray(out[1], np.float64) @ Rx
            if pkg == "port":
                out[0] = torch.as_tensor(s if s else float(out[0]), dtype=out[1].dtype)
                out[1] = torch.as_tensor(R, dtype=out[1].dtype)
            else:
                out[0] = jax.numpy.asarray(s if s else float(out[0]))
                out[1] = jax.numpy.asarray(R)
        raw[0] = (float(out[0]), np.asarray(out[1].cpu() if pkg == "port" else out[1],
                                            np.float64))
        return tuple(out)

    def search(*a, **kw):
        proj[0] = True
        return real_proj(*a, **kw)

    if case is not None:
        lc.map.inertial_ba1, lc.map.imu_initialized = case[2], case[3]
    lc._search_by_projection = search
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "optimize_sim3", opt)
        if pkg == "port":
            mp.setattr(t_sim3, "draw_samples", _draws(data["try_key"]))
        else:
            lc._rng_key = jax.numpy.asarray(data["try_key"])
        out = lc._try_loop(kf, cand, merge=True)
    return raw[0], out, proj[0]


def _removed(R_raw, R_kept):
    return float(np.arccos(np.clip((np.trace(R_raw.T @ R_kept) - 1.0) / 2.0, -1.0, 1.0)))


def _rot_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def _world_tilt_deg(R, Rkf, Rcand):
    """Degrees by which the world correction of a merge whose Sim3 has
    rotation R (current camera <- candidate camera) tilts the vertical."""
    Rw = (R @ Rcand).T @ Rkf
    return float(np.degrees(np.arccos(np.clip((Rw @ [0.0, 0.0, 1.0])[2], -1.0, 1.0))))


def _gt_relative(sessions, arrays, kf, cand):
    """Ground truth of the merge's Sim3 rotation (current camera <-
    candidate camera) from the two keyframes' stamps."""
    def pose(t):
        return (sessions[1] if t >= sessions[1].t0 else sessions[0]).gt_pose_cw(t)
    Rk, _ = pose(arrays["kf_time"][kf])
    Rc, _ = pose(arrays["kf_time"][cand])
    return Rk @ Rc.T


def test_the_detection_on_tpuslams_inputs(rig, data):
    """With tpuslam's projection the port lands on tpuslam's Sim3 and pairs;
    with its own, the Sim3 before the gates is the same and the one kept
    implies a world correction about the vertical."""
    (s_raw, R_raw), out, proj = _try("port", rig, data, tpuslams_projection=True)
    assert out is not None and proj
    s, R, t = out["sim3"]
    print(f"port vs tpuslam: Sim3 before the gates |dR| "
          f"{np.abs(R_raw - data['try_raw_R']).max():.3g}; kept |dR| "
          f"{np.abs(R - data['try_R']).max():.3g} |dt| {np.abs(t - data['try_t']).max():.3g}; "
          f"tpuslam's projection removed {_removed(R_raw, R):.6f} rad")
    assert s_raw == float(data["try_raw_s"]) == s == float(data["try_s"]) == 1.0
    assert np.abs(R_raw - data["try_raw_R"]).max() < SIM3_TOL
    assert np.abs(R - data["try_R"]).max() < SIM3_TOL
    assert np.abs(t - data["try_t"]).max() < SIM3_TOL
    assert abs(_removed(R_raw, R) - _removed(data["try_raw_R"], data["try_R"])) < SIM3_TOL
    assert sorted(map(tuple, np.asarray(out["match_pairs"]))) == sorted(
        map(tuple, data["try_pairs"]))
    (_, R_raw2), own, _ = _try("port", rig, data)
    assert np.abs(R_raw2 - R_raw).max() < SIM3_TOL and own is not None
    arrays, _ = state.unpack(data, "try.")
    kf, cand = int(data["try_kf"]), int(data["try_cand"])
    R_own = own["sim3"][1]
    Rk, Rc = arrays["kf_R"][kf], arrays["kf_R"][cand]
    R_gt = _gt_relative(loop_sessions()[1], arrays, kf, cand)
    errs = {what: _rot_deg(Rx.T @ R_gt) for what, Rx in
            (("before the gates", R_raw), ("tpuslam's", R), ("the port's", R_own))}
    print(f"rotation error of the Sim3 against ground truth (degrees): {errs}; world tilt of "
          f"the raw Sim3 {_world_tilt_deg(R_raw, Rk, Rc):.4f}, of the port's "
          f"{_world_tilt_deg(R_own, Rk, Rc):.2e}")
    assert _world_tilt_deg(R_own, Rk, Rc) < 1e-6
    assert errs["the port's"] < 1.0 < 5.0 < errs["tpuslam's"]


GATE_CASES = {
    # (scale, tilt, inertial_ba1, imu_initialized) -> the gate's decision
    "scale_after_viba1": ((1.2, 0.0, True, True), "scale"),
    "scale_before_viba1": ((1.2, 0.0, False, True), "projected"),
    "tilt_0.2": ((None, 0.2, True, True), "projected"),
    "tilt_0.6": ((None, 0.6, True, True), "0.35 rad"),
    "imu_not_initialized": ((None, 0.2, False, False), "untouched"),
    "as_detected": ((None, 0.0, True, True), "projected"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_the_inertial_gates_decide_as_tpuslams(rig, data, case):
    inputs, decision = GATE_CASES[case]
    got = {pkg: _try(pkg, rig, data, inputs, tpuslams_projection=True)
           for pkg in ("port", "tpuslam")}
    (raw_p, out_p, proj_p), (raw_j, out_j, proj_j) = got["port"], got["tpuslam"]
    assert np.abs(raw_p[1] - raw_j[1]).max() < SIM3_TOL and raw_p[0] == raw_j[0]
    assert proj_p == proj_j == (decision not in ("scale", "0.35 rad")), (proj_p, proj_j)
    assert (out_p is None) == (out_j is None)
    if decision in ("scale", "0.35 rad"):
        assert out_p is None
    kept = out_p["sim3"][1] if out_p is not None else None
    if out_p is not None:
        assert np.abs(kept - np.asarray(out_j["sim3"][1])).max() < SIM3_TOL
        assert (np.abs(raw_p[1] - kept).max() < 1e-12) == (decision == "untouched")
        if decision == "projected":
            assert abs(kept[2, 2] - 1.0) < 1e-12 and _removed(raw_p[1], kept) < YAW_GATE


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_the_ports_gates_project_the_world_correction(rig, data, case):
    """The port's own projection on the same cases: the scale gate and the
    untouched map as tpuslam's; a kept Sim3 implies a world correction
    about the vertical, and the 0.35 rad check measures the tilt it
    removed (the 0.6 rad tilt is rejected, the 0.2 rad one kept)."""
    inputs, decision = GATE_CASES[case]
    (_, R_raw), out, proj = _try("port", rig, data, inputs)
    assert proj == (decision not in ("scale", "0.35 rad")) and (out is None) == (not proj)
    if out is None:
        return
    arrays, _ = state.unpack(data, "try.")
    Rk, Rc = arrays["kf_R"][int(data["try_kf"])], arrays["kf_R"][int(data["try_cand"])]
    R = out["sim3"][1]
    if decision == "untouched":
        assert np.abs(R - R_raw).max() < 1e-12
    else:
        assert _world_tilt_deg(R, Rk, Rc) < 1e-6
        assert np.radians(_world_tilt_deg(R_raw, Rk, Rc)) < YAW_GATE


@pytest.fixture(scope="module")
def correction(rig, data):
    """The port's _correct_loop(merge=True) on tpuslam's state before the
    correction, with the essential graph's arguments and result, the weld's
    keyframes and the map right after it, and the GBA snapshot's kind."""
    arrays, feats = state.unpack(data, "pre.")
    lc = _closer("port", rig, arrays, feats)
    m, rec = lc.map, {}
    real_graph, real_weld, real_snap = (loop_closing.optimize_essential_graph,
                                        loop_closing.window_inertial_ba, lc._snapshot_gba)

    def graph(*a, **kw):
        out = real_graph(*a, **kw)
        rec["graph"] = (kw["four_dof"], list(kw["fix_kfs"]), kw["fix_kf"], out)
        return out

    def weld(*a, **kw):
        out = real_weld(*a, **kw)
        rec["weld"] = (list(kw["opt_kfs"]), list(kw["fixed_kfs"]), kw["n_iters"], map_state(m))
        return out

    def snapshot(fix_kf):
        snap = real_snap(fix_kf)
        rec["gba"] = (snap.get("kind"), list(snap["kfs"]))
        return snap

    lc._snapshot_gba = snapshot
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closing, "optimize_essential_graph", graph)
        mp.setattr(loop_closing, "window_inertial_ba", weld)
        lc._correct_loop(int(data["correct_kf"]), int(data["correct_cand"]),
                         float(data["correct_s"]), data["correct_R"], data["correct_t"],
                         [tuple(p) for p in data["correct_pairs"]], merge=True)
    return lc, rec


def _states_agree(got, want, kfs, what):
    worst = {f: float(np.abs(np.asarray(got[f])[kfs] - np.asarray(want[f])[kfs]).max())
             for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")}
    pts = np.flatnonzero(np.asarray(want["mp_valid"])[: int(want["n_mp"])])
    worst["mp_pos"] = float(np.abs(np.asarray(got["mp_pos"])[pts]
                                   - np.asarray(want["mp_pos"])[pts]).max())
    print(f"{what}: {len(kfs)} keyframes, {len(pts)} points, port vs tpuslam {worst}")
    for f, w in worst.items():
        assert w < TOL[f], (what, f, w, TOL[f])


def test_the_correction_on_tpuslams_inputs(correction, data):
    lc, rec = correction
    m = lc.map
    kf, cand = int(data["correct_kf"]), int(data["correct_cand"])
    four_dof, fixed, fix_kf, out = rec["graph"]
    assert four_dof and bool(data["graph_four_dof"]) and fix_kf == cand
    assert fixed == data["graph_fix_kfs"].tolist()
    assert sorted(out) == data["graph_kf"].tolist()
    for i, k in enumerate(data["graph_kf"]):
        s, R, t = out[int(k)]
        assert s == float(data["graph_s"][i])
        assert np.abs(R - data["graph_R"][i]).max() < TOL["kf_R"], k
        assert np.abs(t - data["graph_t"][i]).max() < TOL["kf_t"], k
    opt, weld_fixed, n_iters, after_weld = rec["weld"]
    assert opt == data["weld_opt"].tolist() and weld_fixed == data["weld_fixed"].tolist()
    assert n_iters == int(data["weld_iters"]) == 15
    want, _ = state.unpack(data, "weld.")
    _states_agree(after_weld[0], want, opt, "after the weld BA")
    assert rec["gba"] == (str(data["gba_kind"]), data["gba_kfs"].tolist()) and rec["gba"][0] == "vi"
    want, _ = state.unpack(data, "post.")
    got = map_state(m)[0]
    kfs = np.flatnonzero(want["kf_valid"][: want["n_kf"]])
    assert np.array_equal(got["kf_valid"][: want["n_kf"]], want["kf_valid"][: want["n_kf"]])
    assert np.array_equal(got["kf_map_id"][kfs], want["kf_map_id"][kfs])
    assert np.array_equal(got["mp_valid"], want["mp_valid"])
    for f in ("imu_initialized", "inertial_ba1", "inertial_ba2", "current_map_id"):
        assert got[f] == want[f], f
    _states_agree(got, want, kfs, "after the correction and the GBA")
    assert m.map_ids() == [0] and m.kf_map_id[kf] == 0 and lc.n_loops_closed == 1


def test_tpuslams_yaw_projection_turns_the_merge(rig, data):
    """The fault (ROADMAP §3; repaired in the port): tpuslam projects the
    camera-to-camera rotation onto the camera's optical axis, which throws
    away the heading difference of the two views and keeps a tilt; the
    candidate's refinement on the next keyframes starts from it and keeps
    it, and the merge transports C with it. On this merge the Sim3 before
    the gates is within 0.34 degrees of the truth, tpuslam's kept one and
    the one its correction uses 9.2 degrees off, and its merged map's joint
    unscaled ATE is 11.8 cm (the stereo-inertial gate: 5 cm)."""
    seq, sessions = loop_sessions()
    tr, _ = state.unpack(data, "try.")
    pre, _ = state.unpack(data, "pre.")
    post, feats = state.unpack(data, "post.")
    R_gt = _gt_relative(sessions, tr, int(data["try_kf"]), int(data["try_cand"]))
    R_gt2 = _gt_relative(sessions, pre, int(data["correct_kf"]), int(data["correct_cand"]))
    errs = (_rot_deg(data["try_raw_R"].T @ R_gt), _rot_deg(data["try_R"].T @ R_gt),
            _rot_deg(data["correct_R"].T @ R_gt2))
    m = map_from_numpy(post, feats)
    gates = joint_gates(m, [(m.kf_time[k], *m.kf_center(k)) for k in m.valid_kf_ids()],
                        sessions)
    print(f"tpuslam's Sim3 against ground truth (degrees): before the gates {errs[0]:.4f}, "
          f"kept {errs[1]:.4f}, corrected with {errs[2]:.4f}; its merged keyframes: {gates}")
    assert errs[0] < 1.0 and errs[1] > 5.0 and errs[2] > 5.0
    assert gates["ate"] > 0.05 and not gates["ok"]


class _Stop(Exception):
    pass


def _seam_rig():
    """tests/make_vi_merge_data.py's branch a: A frames 0-27, B 6-45."""
    return heave_sessions(28, 6, 40)


def _joint_kf_error(m, sessions):
    ks = m.valid_kf_ids(all_maps=True)
    got = joint_gates(m, [(m.kf_time[k], *m.kf_center(k)) for k in ks], sessions)
    return got["ate"]


@pytest.fixture(scope="module")
def seam(tmp_path_factory):
    """tests/data/vi_merge_a.npz's state before the port's merge of B into A
    (heave_sessions): each package's correction up to the end of its
    essential graph, and the port's with tpuslam's seam measurements
    (`_seam_poses` giving nothing). Returns the joint keyframe errors and
    keyframe poses right after each graph."""
    seq, sessions = _seam_rig()
    with np.load(DATA_A) as f:
        data = {k: f[k] for k in f.files}
    arrays, feats = state.unpack(data, "pre.")
    bits = np.concatenate([f["bits"][f["valid"]] for f in feats if f is not None][:4])
    voc = str(tmp_path_factory.mktemp("voc") / "voc.txt")
    save_orbvoc_text(train_vocabulary(bits, k=4, L=2, iters=2, device="cpu"), voc)
    rig = (seq, voc)
    assert data["loop_edges"].size == 0
    out = {}
    for what in ("port", "tpuslam", "port_as_tpuslam"):
        pkg = "tpuslam" if what == "tpuslam" else "port"
        lc = _closer(pkg, rig, arrays, feats)
        if what == "port_as_tpuslam":
            lc._seam_poses = lambda *a: {}
        module = loop_closing if pkg == "port" else j_loop
        real = module.optimize_essential_graph
        m = lc.map

        def graph(*a, _real=real, _m=m, _what=what, **kw):
            res = _real(*a, **kw)
            out[_what] = (_joint_kf_error(_m, sessions), _m.kf_R.copy(), _m.kf_t.copy(),
                          _m.valid_kf_ids(all_maps=True))
            raise _Stop
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "optimize_essential_graph", graph)
            with pytest.raises(_Stop):
                lc._correct_loop(int(data["correct_kf"]), int(data["correct_cand"]),
                                 float(data["correct_s"]), data["correct_R"],
                                 data["correct_t"], [tuple(p) for p in data["correct_pairs"]],
                                 merge=True)
    return out


def test_the_seam_is_measured_in_one_frame(seam):
    """The fault (ROADMAP §3; repaired in the port): the merge's essential
    graph measures each edge between the poses from before the correction,
    and across the seam those are in two frames (the young keyframe's in
    the young map's, the old one's in the merge map's), so the seam's
    covisibility edges pull the transported young map back towards where
    it was. On this merge tpuslam's graph leaves the keyframes 19 cm from
    ground truth on one alignment; the port's stays within 1 cm, and with
    tpuslam's measurements it lands on tpuslam's poses."""
    err = {k: v[0] for k, v in seam.items()}
    print(f"joint keyframe error after the essential graph (m): {err}")
    assert err["port"] < 0.01 < 0.1 < err["tpuslam"]
    _, Rp, tp, kfs = seam["port_as_tpuslam"]
    _, Rj, tj, kfs_j = seam["tpuslam"]
    assert np.array_equal(kfs, kfs_j)
    assert np.abs(Rp[kfs] - Rj[kfs]).max() < TOL["kf_R"]
    assert np.abs(tp[kfs] - tj[kfs]).max() < TOL["kf_t"]
