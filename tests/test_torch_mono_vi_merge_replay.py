"""The mono-inertial merge's correction replayed in the port on tpuslam's
state, on the CPU.

tests/data/mono_vi_merge.npz (written by tests/make_mono_vi_merge_data.py,
which says how) holds tpuslam's run of tests/torch_mono_vi_merge.py's two
sessions up to its merge (376x240, 600 features, f64; B, three frames after
its IMU init, merged into A, which has run VIBA2): the map just before
`_correct_loop(merge=True)` with its arguments, the essential graph's
result, the map right before and right after the visual-inertial weld BA
and after the correction and its synchronous GBA. The map is carried into the port
(`map_from_numpy`) and the port's correction runs on it in f64:

  * the Sim3's scale is exactly 1: an inertial map merges at a fixed scale
    (ROADMAP §3: the scale window (0.9, 1.1) can reject no merge);
  * the yaw removed: tpuslam corrects with a Sim3 whose world correction
    tilts the vertical (its fault, ROADMAP §3: it projects the
    camera-to-camera rotation, and its refinements bring back what the
    projection removed); the port projects that Sim3 onto a world
    correction about gravity alone, removing a rotation under the 0.35 rad
    gate;
  * tpuslam's correction on its own arguments and with its seam
    measurements (`_seam_poses` off): the transport, the seam fuse, the
    relabel and the 4-DoF essential graph with A's keyframes fixed land on
    tpuslam's keyframes and points within TOL
    (tests/test_torch_vi_schedule.py's), and the weld BA takes the same
    optimized and fixed keyframes;
  * F4 (ROADMAP §3) stops tpuslam's weld: its solve returns a NaN cost and
    writes nothing back; the port's weld on the same input takes its steps
    and brings the weld window's reprojection errors down;
  * the port's own correction (that Sim3 projected, its seam measured in
    one frame) ends no further from the ground truth than tpuslam's: the
    keyframes' scaled ATE after the graph and the weld and after the whole
    correction.
"""

import os

import numpy as np
import pytest
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import loop_closing
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.imu.preintegration import ImuCalib
from tpuslam_torch.map.store import map_from_numpy, map_state
from tpuslam_torch.eval.ate import horn_align
from tpuslam_torch.place import train_vocabulary

import torch_mono_vi_merge as mv
import torch_vi_merge_state as state
from test_torch_vi_merge_replay import _states_agree
from torch_vi_merge import NOISE

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mono_vi_merge.npz")
TOL = dict(kf_R=1e-9, kf_t=1e-8)       # tests/test_torch_vi_schedule.py's
YAW_GATE = 0.35


@pytest.fixture(scope="module")
def data():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


def _world_tilt(R, Rk, Rc):
    """Radians by which the world correction of a merge Sim3 with rotation R
    (current camera <- candidate camera) tilts the vertical."""
    W = Rc.T @ R.T @ Rk
    return float(np.arccos(np.clip(W[2, 2], -1.0, 1.0)))


def _replay(data, own):
    """The port's _correct_loop(merge=True) on tpuslam's state before the
    correction: own=False with tpuslam's Sim3 and seam measurements, True
    with the port's projection of the refinement's Sim3 and its own seam.
    Returns the closer and what it recorded: the graph's arguments and
    result, the map right before the weld, the weld's keyframes and the map
    right after it."""
    seq, _ = mv.sessions()
    arrays, feats = state.unpack(data, "pre.")
    bits = np.concatenate([f["bits"][f["valid"]] for f in feats if f is not None][:4])
    camera = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    m = map_from_numpy(arrays, feats)
    lm = LocalMapper(camera, mv.config(), m, imu_calib=ImuCalib(**NOISE), mono=True,
                     device="cpu", dtype=torch.float64)
    lc = loop_closing.LoopCloser(camera, mv.config(), m,
                                 train_vocabulary(bits, k=4, L=2, iters=2, device="cpu"),
                                 fix_scale=True, local_mapper=lm, device="cpu",
                                 dtype=torch.float64)
    lm.loop_closer = lc
    kf, cand = int(data["correct_kf"]), int(data["correct_cand"])
    s, R, t = float(data["correct_s"]), data["correct_R"], data["correct_t"]
    rec = {}
    if own:
        R, t, rec["removed"] = lc._yaw_only(kf, cand, s, R, t)
        rec["R"] = R
    else:
        lc._seam_poses = lambda *a: {}
    real_graph, real_weld = loop_closing.optimize_essential_graph, loop_closing.window_inertial_ba

    def graph(*a, **kw):
        out = real_graph(*a, **kw)
        rec["graph"] = (kw["four_dof"], list(kw["fix_kfs"]), kw["fix_kf"], out)
        return out

    def weld(*a, **kw):
        rec["preweld"] = map_state(m)[0]
        out = real_weld(*a, **kw)
        rec["weld"] = (list(kw["opt_kfs"]), list(kw["fixed_kfs"]), map_state(m)[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closing, "optimize_essential_graph", graph)
        mp.setattr(loop_closing, "window_inertial_ba", weld)
        lc._correct_loop(kf, cand, s, R, t, [tuple(p) for p in data["correct_pairs"]],
                         merge=True)
    return lc, rec


@pytest.fixture(scope="module")
def replays(data):
    return {own: _replay(data, own) for own in (False, True)}


def _kf_ate(st):
    """The keyframes' scaled ATE (m) against the ground truth."""
    _, sessions = mv.sessions()
    kfs = np.flatnonzero(st["kf_valid"][: st["n_kf"]])
    est = np.stack([-st["kf_R"][k].T @ st["kf_t"][k] for k in kfs])
    gt = np.stack([mv.gt_centre(sessions, float(st["kf_time"][k])) for k in kfs])
    return float(np.sqrt(np.mean(horn_align(est, gt, with_scale=True)[3] ** 2)))


def test_the_merge_is_at_scale_one(data):
    assert float(data["correct_s"]) == 1.0


def test_the_yaw_removed(replays, data):
    _, rec = replays[True]
    pre, _ = state.unpack(data, "pre.")
    Rk, Rc = pre["kf_R"][int(data["correct_kf"])], pre["kf_R"][int(data["correct_cand"])]
    tpuslams, port = (_world_tilt(x, Rk, Rc) for x in (data["correct_R"], rec["R"]))
    print(f"tpuslam's Sim3 tilts the vertical by {np.degrees(tpuslams):.4f} degrees; the "
          f"port's projection removes {np.degrees(rec['removed']):.4f} degrees and keeps "
          f"{np.degrees(port):.2e}")
    assert 0.005 < tpuslams < YAW_GATE
    assert rec["removed"] == pytest.approx(tpuslams, abs=1e-3) and port < 1e-6


def test_tpuslams_correction_on_its_arguments(replays, data):
    lc, rec = replays[False]
    m = lc.map
    kf, cand = int(data["correct_kf"]), int(data["correct_cand"])
    four_dof, fixed, fix_kf, out = rec["graph"]
    assert four_dof and bool(data["graph_four_dof"]) and fix_kf == cand
    assert fixed == data["graph_fix_kfs"].tolist()
    assert sorted(out) == data["graph_kf"].tolist()
    worst = [0.0, 0.0]
    for i, k in enumerate(data["graph_kf"]):
        s, R, t = out[int(k)]
        assert s == float(data["graph_s"][i]) == 1.0
        worst = [max(worst[0], float(np.abs(R - data["graph_R"][i]).max())),
                 max(worst[1], float(np.abs(t - data["graph_t"][i]).max()))]
    print(f"the essential graph: {len(out)} keyframes, {len(fixed)} fixed, port vs tpuslam "
          f"R {worst[0]:.2e}, t {worst[1]:.2e}")
    assert worst[0] < TOL["kf_R"] and worst[1] < TOL["kf_t"]
    opt, weld_fixed, _ = rec["weld"]
    print(f"the weld: {len(opt)} keyframes optimized, {len(weld_fixed)} fixed")
    assert opt == data["weld_opt"].tolist() and weld_fixed == data["weld_fixed"].tolist()
    want, _ = state.unpack(data, "preweld.")
    kfs = np.flatnonzero(want["kf_valid"][: want["n_kf"]])
    _states_agree(rec["preweld"], want, kfs, "before the weld BA")
    assert m.map_ids() == [0] and m.kf_map_id[kf] == 0 and lc.n_loops_closed == 1


def _reprojection_px(st, feats, kfs, cam):
    """Reprojection errors (px) of the keyframes' observed points."""
    errs = []
    for k in kfs:
        row = st["kf_mp"][k]
        slots = np.nonzero(row >= 0)[0]
        Xc = st["mp_pos"][row[slots]] @ st["kf_R"][k].T + st["kf_t"][k]
        uv = np.stack([cam[0] * Xc[:, 0] / Xc[:, 2] + cam[2],
                       cam[1] * Xc[:, 1] / Xc[:, 2] + cam[3]], 1)
        errs.append(np.linalg.norm(uv - feats[k]["und_xy"][slots], axis=1))
    return np.concatenate(errs)


def test_tpuslams_weld_takes_no_step(replays, data):
    """F4 (ROADMAP §3): tpuslam's visual-inertial weld BA on this merge
    returns a NaN cost (so3_log of its near-identity rotation residuals) and
    writes nothing back, so its weld leaves the seam as the graph left it.
    The port's weld on the same input (so3_log's Taylor branch) takes its
    steps and brings the weld window's reprojection errors down."""
    lc, rec = replays[False]
    pre, feats = state.unpack(data, "preweld.")
    post, _ = state.unpack(data, "weld.")
    for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba", "mp_pos"):
        assert np.array_equal(np.asarray(pre[f]), np.asarray(post[f])), f
    opt, _, after_weld = rec["weld"]
    cam = (lc.camera.fx, lc.camera.fy, lc.camera.cx, lc.camera.cy)
    before = _reprojection_px(pre, feats, opt, cam)
    port = _reprojection_px(after_weld, feats, opt, cam)
    print(f"the weld window's reprojection errors (px, median / p90): before the weld (and "
          f"after tpuslam's) {np.median(before):.3f} / {np.percentile(before, 90):.3f}, after "
          f"the port's {np.median(port):.3f} / {np.percentile(port, 90):.3f}")
    assert np.percentile(port, 90) < 0.5 * np.percentile(before, 90)
    assert np.median(port) < np.median(before)


def test_the_ports_correction_is_no_further_from_the_ground_truth(replays, data):
    lc, rec = replays[True]
    opt, weld_fixed, after_weld = rec["weld"]
    assert opt == data["weld_opt"].tolist() and weld_fixed == data["weld_fixed"].tolist()
    port = (_kf_ate(after_weld), _kf_ate(map_state(lc.map)[0]))
    tpuslams = (_kf_ate(state.unpack(data, "weld.")[0]),
                _kf_ate(state.unpack(data, "post.")[0]))
    print(f"the keyframes' scaled ATE after the graph and the weld / after the correction: port "
          f"{port[0] * 100:.3f} / {port[1] * 100:.3f} cm, tpuslam {tpuslams[0] * 100:.3f} / "
          f"{tpuslams[1] * 100:.3f} cm")
    assert port[1] <= tpuslams[1] and port[0] < 0.06
    assert lc.map.map_ids() == [0] and lc.n_loops_closed == 1
