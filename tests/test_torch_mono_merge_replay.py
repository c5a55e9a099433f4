"""The monocular Atlas merge replayed in the port on tpuslam's state, on the
CPU.

tests/data/mono_merge.npz (written by tests/make_mono_merge_data.py, which
says how) holds tpuslam's run of tests/torch_mono_merge.py's two sessions
up to its merge (376x240, 700 features, f64; B is merged on its frame 5,
its third keyframe onto one of A's, with a Sim3 scale of 1.208): the map
just before the young map's initial BA, and the map just before
`_correct_loop(merge=True)` with its arguments, the state at the essential
graph's call, the graph's result, and the map after the weld BA and after
the correction with its synchronous GBA. Each state is carried into the
port (`map_from_numpy`) and the port's step runs on it in f64:

  * the correction: the transport with the merge's scale, the seam fuse and
    the relabel land on tpuslam's keyframes, corrected seeds and points
    within 1e-8. tpuslam's 7-DoF essential graph returns its seeds: its
    `so3_log` gives NaN on the near-identity residuals of A's fixed
    keyframes (ROADMAP §3, F4), so its LM takes no step. From tpuslam's
    graph result, the port's weld BA and GBA land on tpuslam's within
    tests/test_torch_vi_schedule.py's tolerances;
  * the seam of a scaled merge (ROADMAP §3): tpuslam measures the seam's
    covisibility edges between a young keyframe posed in the young map's
    frame and units and an old one in A's. With those measurements the
    port's graph (which runs: no F4) pulls B's keyframes ~0.7-0.9 m off and
    its scale back towards 1; the port measures the seam in one frame and
    at one scale and leaves them where the transport put them;
  * the young map's initial BA (tpuslam's fault, repaired in the port):
    tpuslam's takes every valid point of the Atlas, so B's init solves A's
    points too, each of their observations read as one of B's second
    keyframe's, and writes them back; the port's solves the points of the
    two new keyframes and leaves A's map as it was.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.solve.pose_graph as j_pose_graph

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import loop_closing
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.tracking import Tracker
from tpuslam_torch.eval.ate import horn_align
from tpuslam_torch.map.store import map_from_numpy
from tpuslam_torch.place import load_orbvoc, save_orbvoc_text, train_vocabulary
from tpuslam_torch.solve import pose_graph

import torch_vi_merge_state as state
from torch_mono_merge import camera_of, config, gt_centers, room

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mono_merge.npz")
# tests/test_torch_vi_schedule.py's: f64 solvers of both packages on the same inputs
TOL = dict(kf_R=1e-9, kf_t=1e-8, mp_pos=1e-6)
TRANSPORT_TOL = 1e-8


@pytest.fixture(scope="module")
def data():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def rig(tmp_path_factory, data):
    """The room's sequence and sessions, and a vocabulary the closer can hold
    (the replayed steps never query it)."""
    seq, _, sessions = room()
    _, feats = state.unpack(data, "pre.")
    bits = np.concatenate([f["bits"][f["valid"]] for f in feats if f is not None][:4])
    voc = str(tmp_path_factory.mktemp("voc") / "voc.txt")
    save_orbvoc_text(train_vocabulary(bits, k=4, L=2, iters=2, device="cpu"), voc)
    return seq, sessions, voc


def _closer(rig, data):
    seq, _, voc = rig
    camera = Pinhole(*camera_of(seq))
    m = map_from_numpy(*state.unpack(data, "pre."))
    lm = LocalMapper(camera, config(), m, bf=0.0, mono=True, device="cpu",
                     dtype=torch.float64)
    lc = loop_closing.LoopCloser(camera, config(), m, load_orbvoc(voc), fix_scale=False,
                                 local_mapper=lm, device="cpu", dtype=torch.float64)
    lm.loop_closer = lc
    lc.loop_edges = []
    return lc


def _tpuslams_graph(data):
    """tpuslam's essential-graph result, {kf: (s, R, t)}."""
    return {int(k): (float(s), R, t) for k, s, R, t in
            zip(data["graph_kf"], data["graph_s"], data["graph_R"], data["graph_t"])}


def _correct(rig, data, tpuslams_seam=False, tpuslams_graph=False):
    """The port's _correct_loop(merge=True) on tpuslam's state before the
    correction; tpuslams_seam: with tpuslam's seam measurements;
    tpuslams_graph: tpuslam's graph result in place of the port's graph.
    Returns the closer and what it recorded: the map at the essential
    graph's call with the graph's arguments, its edges and result, and the
    map after the weld BA."""
    lc = _closer(rig, data)
    m, rec = lc.map, {}
    if tpuslams_seam:
        lc._seam_poses = lambda *a: {}
    real_graph, real_weld = loop_closing.optimize_essential_graph, loop_closing.window_ba
    real_solve = pose_graph.pose_graph_solve

    def solve(*a, **kw):
        rec["edges"] = [x.numpy() for x in a[:8]]
        return real_solve(*a, **kw)

    def graph(mm, loop_edges, corrected, fix_kf, **kw):
        rec["graph_in"] = (mm.kf_R.copy(), mm.kf_t.copy(), mm.mp_pos.copy(), dict(corrected),
                           fix_kf, list(kw["fix_kfs"]), kw["fix_scale"])
        if tpuslams_graph:
            out = _tpuslams_graph(data)
            for k, (s, R, t) in out.items():
                mm.kf_R[k], mm.kf_t[k] = R, t / s
        else:
            out = real_graph(mm, loop_edges, corrected, fix_kf, **kw)
        rec["graph"] = out
        return out

    def weld(mm, *a, **kw):
        out = real_weld(mm, *a, **kw)
        rec["weld"] = (list(a[4]), list(kw["fixed_kfs"]), mm.kf_R.copy(), mm.kf_t.copy(),
                       mm.mp_pos.copy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closing, "optimize_essential_graph", graph)
        mp.setattr(loop_closing, "window_ba", weld)
        mp.setattr(pose_graph, "pose_graph_solve", solve)
        lc._correct_loop(int(data["correct_kf"]), int(data["correct_cand"]),
                         float(data["correct_s"]), data["correct_R"], data["correct_t"],
                         [tuple(p) for p in data["correct_pairs"]], merge=True)
    return lc, rec


def _agree(kf_R, kf_t, mp_pos, data, prefix, tol, what):
    kfs = np.flatnonzero(data[prefix + "kf_valid"])
    pts = np.flatnonzero(data[prefix + "mp_valid"])
    worst = dict(kf_R=float(np.abs(kf_R[kfs] - data[prefix + "kf_R"][kfs]).max()),
                 kf_t=float(np.abs(kf_t[kfs] - data[prefix + "kf_t"][kfs]).max()),
                 mp_pos=float(np.abs(mp_pos[pts] - data[prefix + "mp_pos"][pts]).max()))
    print(f"{what}: {len(kfs)} keyframes, {len(pts)} points, port vs tpuslam {worst}")
    for f, w in worst.items():
        assert w < tol[f], (what, f, w, tol[f])


def test_the_correction_on_tpuslams_inputs(rig, data):
    lc, rec = _correct(rig, data, tpuslams_seam=True, tpuslams_graph=True)
    m = lc.map
    kf, cand = int(data["correct_kf"]), int(data["correct_cand"])
    R, t, X, corrected, fix_kf, fix_kfs, fix_scale = rec["graph_in"]
    assert fix_kf == cand and not fix_scale and not bool(data["graph_fix_scale"])
    assert fix_kfs == data["graph_fix_kfs"].tolist()
    assert sorted(corrected) == data["graph_corrected_kf"].tolist()
    for i, k in enumerate(data["graph_corrected_kf"]):
        s, Rc, tc = corrected[int(k)]
        assert abs(s - data["graph_corrected_s"][i]) < TRANSPORT_TOL
        assert np.abs(Rc - data["graph_corrected_R"][i]).max() < TRANSPORT_TOL
        assert np.abs(tc - data["graph_corrected_t"][i]).max() < TRANSPORT_TOL
    assert abs(float(data["correct_s"]) - 1.0) > 0.10, "a merge with a scale"
    _agree(R, t, X, data, "graph_in_", dict(kf_R=TRANSPORT_TOL, kf_t=TRANSPORT_TOL,
                                            mp_pos=TRANSPORT_TOL), "transported")
    # tpuslam's graph took no step: its result is its seeds
    seeds = {int(k): (data["graph_corrected_s"][i], data["graph_corrected_R"][i],
                      data["graph_corrected_t"][i])
             for i, k in enumerate(data["graph_corrected_kf"])}
    for k, (s, Rg, tg) in _tpuslams_graph(data).items():
        s0, R0, t0 = seeds.get(k, (1.0, data["graph_in_kf_R"][k], data["graph_in_kf_t"][k]))
        assert s == s0 and np.array_equal(Rg, R0) and np.array_equal(tg, t0), k
    weld_kfs, weld_fixed, R, t, X = rec["weld"]
    assert weld_kfs == data["weld_kfs"].tolist() and weld_fixed == data["weld_fixed"].tolist()
    _agree(R, t, X, data, "weld_", TOL, "after the weld BA")
    n_kf = len(data["post_kf_valid"])
    assert np.array_equal(m.kf_valid[:n_kf], data["post_kf_valid"])
    assert np.array_equal(m.kf_map_id[:n_kf][m.kf_valid[:n_kf]],
                          data["post_kf_map_id"][data["post_kf_valid"]])
    assert np.array_equal(m.mp_valid[: len(data["post_mp_valid"])], data["post_mp_valid"])
    _agree(m.kf_R, m.kf_t, m.mp_pos, data, "post_", TOL, "after the correction and the GBA")
    assert m.map_ids() == [0] and m.kf_map_id[kf] == 0 and lc.n_loops_closed == 1


def _young_errors(sessions, kf_time, kf_R, kf_t, old, young):
    """Camera-centre errors (m) of the young keyframes on the Sim3 that
    aligns the old side (fixed in the graph) to its ground truth."""
    def centres(ks):
        return np.array([-kf_R[k].T @ kf_t[k] for k in ks])

    R, t, s, _ = horn_align(centres(old), gt_centers(sessions, kf_time[old]), with_scale=True)
    est = s * centres(young) @ R.T + t
    return np.linalg.norm(est - gt_centers(sessions, kf_time[young]), axis=1)


def test_the_seam_of_a_scaled_merge(rig, data):
    """The young map's keyframes after the essential graph, against the
    ground truth on A's alignment: the port's (the seam measured in one
    frame, at one scale), the port's solver on tpuslam's seam measurements,
    and tpuslam's (its seeds: on the same edges its residuals are NaN where
    A's fixed keyframes meet, F4, and its LM rejects every step)."""
    _, sessions, _ = rig
    pre, _ = state.unpack(data, "pre.")
    old = data["graph_fix_kfs"]
    young = np.array([k for k in data["graph_kf"] if k not in set(old.tolist())])
    runs = {"port": _correct(rig, data)[1],
            "port_as_tpuslam": _correct(rig, data, tpuslams_seam=True)[1]}
    got, scales = {}, {}
    for what, res in [(k, v["graph"]) for k, v in runs.items()] + [
            ("tpuslam", _tpuslams_graph(data))]:
        R, t = np.array(pre["kf_R"]), np.array(pre["kf_t"])
        for k, (s, Rg, tg) in res.items():
            R[k], t[k] = Rg, tg / s
        got[what] = _young_errors(sessions, pre["kf_time"], R, t, old, young)
        scales[what] = [round(float(res[int(k)][0]), 5) for k in young]
    print(f"young keyframes {young.tolist()} after the essential graph, Sim3 scales {scales}, "
          f"centre errors on A's alignment (cm): "
          + "; ".join(f"{k} {np.round(v * 100, 3).tolist()}" for k, v in got.items()))
    seed = float(data["correct_s"])
    assert np.abs(got["port"] - got["tpuslam"]).max() < 1e-3
    assert all(abs(s / seed - 1.0) < 1e-3 for s in scales["port"])
    assert got["port"].max() < 0.03
    # tpuslam's measurements pull B back towards its own frame and scale
    assert got["port_as_tpuslam"].min() > 0.3
    assert all(abs(s - 1.0) < abs(seed - 1.0) / 2 for s in scales["port_as_tpuslam"])
    # tpuslam's residuals on the same edges
    edges = runs["port_as_tpuslam"]["edges"]
    s, R, t, ei, ej = edges[:5]
    res = np.asarray(j_pose_graph._edge_res(
        jnp.zeros(7), jnp.zeros(7), *[jnp.asarray(x) for x in (
            s[ei], R[ei], t[ei], s[ej], R[ej], t[ej], *edges[5:8])]))
    fixed = set(np.searchsorted(data["graph_kf"], old).tolist())
    nan = [(int(a), int(b)) for a, b, r in zip(ei, ej, res) if not np.isfinite(r).all()]
    print(f"tpuslam's residual is NaN on {len(nan)} of {len(ei)} edges, all between fixed "
          f"keyframes: {all(a in fixed and b in fixed for a, b in nan)}")
    assert nan and all(a in fixed and b in fixed for a, b in nan)


def test_the_young_maps_init_ba(rig, data):
    """tpuslam's initial BA of B's map solves every point of the Atlas: A's
    points move and B's second keyframe is pulled by A's observations. The
    port's solves B's points only, lands on tpuslam's BA held to that, and
    leaves A's points as they were; with tpuslam's choice of points it
    lands on tpuslam's own result."""
    seq, _, _ = rig
    kf0, kf1 = int(data["init_kf0"]), int(data["init_kf1"])
    camera = Pinhole(*camera_of(seq))
    got = {}
    for what in ("port", "port_as_tpuslam"):
        m = map_from_numpy(*state.unpack(data, "init."))
        if what == "port_as_tpuslam":
            m.points_in_kfs = lambda kfs, _m=m: _m.valid_mp_ids()
        tracker = SimpleNamespace(map=m, camera=camera, camspec=camera.spec,
                                  inv_sigma2=1.0 / m.scale_factors ** 2, device="cpu",
                                  dtype=torch.float64)
        before = m.mp_pos[: m.n_mp].copy()
        Tracker._initial_ba(tracker, kf0, kf1)
        got[what] = (m.kf_R[kf1].copy(), m.kf_t[kf1].copy(), before, m.mp_pos[: m.n_mp].copy())
    m = map_from_numpy(*state.unpack(data, "init."))
    mine = m.points_in_kfs([kf0, kf1])
    others = np.setdiff1d(m.valid_mp_ids(), mine)
    R1, t1, before, after = got["port"]
    moved = np.linalg.norm(data["init_faulty_mp_pos"][others] - before[others], axis=1)
    print(f"B's init: {len(mine)} points of its own, {len(others)} of A; tpuslam's BA moves "
          f"A's points by up to {moved.max():.4f} (median {np.median(moved):.4f}) of A's units")
    assert np.array_equal(after[others], before[others])
    assert np.abs(R1 - data["init_kf1_R"]).max() < TOL["kf_R"]
    assert np.abs(t1 - data["init_kf1_t"]).max() < TOL["kf_t"]
    assert np.abs(after[mine] - data["init_mp_pos"][mine]).max() < TOL["mp_pos"]
    assert moved.max() > 0.01
    R1, t1, _, after = got["port_as_tpuslam"]
    assert np.abs(R1 - data["init_faulty_kf1_R"]).max() < TOL["kf_R"]
    assert np.abs(t1 - data["init_faulty_kf1_t"]).max() < TOL["kf_t"]
    pts = np.concatenate([mine, others])
    assert np.abs(after[pts] - data["init_faulty_mp_pos"][pts]).max() < TOL["mp_pos"]
