"""The port's LoopCloser vs tpuslam's, on the CPU, at the map level (no
renderer): detection (BoW), temporal consistency, Sim3 refinement, loop
correction and the Atlas merge with the weld BA, and the background GBA;
plus the GBA-apply fault the port repairs.

Both sides build the same map in lockstep from numpy draws (a drifted
revisit of a landmark set, as tests/test_loop_closer.py and
tests/test_gba_background.py build it), with f64 solvers, and the port's
Sim3 RANSAC is handed tpuslam's own samples (its PRNGKey(7), split per
try). Tolerances: closure flags, pending state and map structure EQUAL;
corrected poses and points to 1e-6.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.core import lie as JL
from tpuslam.engine import config as j_cfg
from tpuslam.engine import local_mapping as j_lm
from tpuslam.engine import loop_closing as j_lc
from tpuslam.map import store as j_store
from tpuslam.place import train_vocabulary as j_train_vocabulary
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import config as t_cfg
from tpuslam_torch.engine import local_mapping as t_lm
from tpuslam_torch.engine import loop_closing as t_lc
from tpuslam_torch.map import store as t_store
from tpuslam_torch.place import train_vocabulary
from tpuslam_torch.solve import sim3 as t_sim3

torch.set_num_threads(2)
FX = FY = 250.0
CX = CY = 180.0
W = H = 360
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def jax_sim3_draws(monkeypatch):
    """The port's Sim3 RANSAC takes the samples tpuslam's LoopCloser
    draws: PRNGKey(7), split once per try."""
    key = [jax.random.PRNGKey(7)]

    def draw(n_valid, n_hyp, generator=None):
        key[0], sub = jax.random.split(key[0])
        return torch.as_tensor(np.asarray(
            jax.random.randint(sub, (n_hyp, 3), 0, max(int(n_valid), 1))))

    monkeypatch.setattr(t_sim3, "draw_samples", draw)


def _so3(w):
    return np.asarray(JL.so3_exp(jnp.asarray(w)))


def _project(R, t, X):
    Xc = X @ R.T + t
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], 1), Xc[:, 2]


class Side:
    """One implementation's map + local mapper + loop closer."""

    def __init__(self, port, vocab_descs, n_slots, **loop_kw):
        store, cfgm, lm, lc = ((t_store, t_cfg, t_lm, t_lc) if port
                               else (j_store, j_cfg, j_lm, j_lc))
        self.port, self.store = port, store
        vocab = (train_vocabulary if port else j_train_vocabulary)(
            vocab_descs, k=6, L=3, iters=4, **({"device": "cpu"} if port else {}))
        cam = (Pinhole if port else JPinhole)([FX, FY, CX, CY], W, H)
        cfg = cfgm.SlamConfig(loop=cfgm.LoopConfig(**loop_kw))
        self.m = store.SlamMap(n_feat=n_slots)
        self.lm = lm.LocalMapper(cam, cfg, self.m, **(F64 if port else {}))
        self.lc = lc.LoopCloser(cam, cfg, self.m, vocab, fix_scale=False, local_mapper=self.lm,
                                **(F64 if port else {}))
        self.lm.loop_closer = self.lc

    def feats(self, uv, z, bits, n_slots):
        pad = n_slots - len(uv)
        uvp = np.concatenate([uv, np.zeros((pad, 2))])
        return self.store.FrameFeatures(
            xy=uvp.copy(), und_xy=uvp.copy(), norm_xy=(uvp - [CX, CY]) / [FX, FY],
            octave=np.zeros(n_slots, np.int32), angle=np.zeros(n_slots),
            response=np.ones(n_slots),
            bits=np.concatenate([bits, np.zeros((pad, 256), np.uint8)]),
            packed=np.zeros((n_slots, 8), np.uint32),
            valid=np.concatenate([z > 0.2, np.zeros(pad, bool)]))


def _add_kf(sides, R, t, X, bits, stamp, reg, n_slots):
    """A keyframe observing X on every side (registered points reused)."""
    uv, z = _project(R, t, X)
    kfs = []
    for sd in sides:
        m = sd.m
        kf = m.add_keyframe(R, t, sd.feats(uv, z, bits, n_slots), float(stamp), stamp)
        for j in range(len(X)):
            if z[j] <= 0.2:
                continue
            key = (id(sd), j)
            if key in reg and m.mp_valid[m.resolve_replaced(reg[key])]:
                m.add_observation(m.resolve_replaced(reg[key]), kf, j)
                continue
            reg[key] = m.add_point(X[j], kf, j)
        m.update_connections(kf)
        kfs.append(kf)
    return kfs


def _revisit(rng, merge):
    """KFs 0..3 see landmark set A, 4..9 set B (or, for a merge, a new
    Atlas map opens); then three revisit KFs see A through a drifted pose
    and duplicate its landmarks (tests/test_loop_closer.py:46-151)."""
    P = 90
    Xa = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], 1)
    bits_a = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    Xb = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                   rng.uniform(4, 9, P)], 1) + np.array([0.0, 0.0, 30.0])
    bits_b = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    loop_kw = dict(min_kfs=4, min_bow_matches=15, min_ransac_inliers=12, min_sim3_inliers=15,
                   min_proj_matches=20, run_gba=not merge, background_gba=False,
                   min_refine_matches=20)
    vocab_descs = bits_a if merge else np.concatenate([bits_a, bits_b])
    sides = [Side(False, vocab_descs, P, **loop_kw), Side(True, vocab_descs, P, **loop_kw)]
    if merge:
        # the port's essential graph with tpuslam's seam measurements (the
        # port measures a scaled seam in one frame and at one scale:
        # tests/test_torch_mono_merge_replay.py)
        sides[1].lc._seam_poses = lambda *a: {}

    def noise(b):
        return (b ^ (rng.rand(*b.shape) < 0.02)).astype(np.uint8)

    reg = {}
    poses = [(_so3([0.0, 0.02 * k, 0.0]), np.array([0.05 * k, 0.0, 0.0])) for k in range(4)]
    for k, (R, t) in enumerate(poses):
        kfs = _add_kf(sides, R, t, Xa, noise(bits_a), k, reg, P)
        for sd, kf in zip(sides, kfs):
            sd.lc.on_new_keyframe(kf)
    if merge:
        for sd in sides:
            sd.m.create_new_map()
    else:
        for k in range(6):
            kfs = _add_kf(sides, np.eye(3), np.array([0.0, 0.0, -20.0 + 0.3 * k]), Xb,
                          noise(bits_b), 4 + k, reg, P)
            for sd, kf in zip(sides, kfs):
                sd.lc.on_new_keyframe(kf)
    drift_R, drift_t = _so3([0.02, -0.04, 0.03]), np.array([0.4, -0.3, 0.5])
    flags = [[], []]
    dup = {}
    Xdup = np.zeros_like(Xa)
    for r, (Rr, tr_) in enumerate(poses[:3]):
        Rd, td = drift_R @ Rr, drift_R @ tr_ + drift_t
        if r == 0:
            uv, z = _project(Rr, tr_, Xa)      # the true geometry of what it sees
            # the first view sees A through the true pose, unprojected with the drifted one
            X_first = (np.stack([(uv[:, 0] - CX) / FX, (uv[:, 1] - CY) / FY,
                                 np.ones(P)], 1) * z[:, None]) @ Rd - Rd.T @ td
            kfs = _add_kf_view(sides, Rd, td, X_first, uv, z, noise(bits_a), 10 + r, dup, P)
            Xdup[:] = X_first
        else:
            kfs = _add_kf(sides, Rd, td, Xdup, noise(bits_a), 10 + r, dup, P)
        for i, (sd, kf) in enumerate(zip(sides, kfs)):
            flags[i].append(sd.lc.on_new_keyframe(kf))
    for sd in sides:
        sd.lc.wait_gba()
    return sides, flags, kfs[0], poses[2]


def _add_kf_view(sides, R, t, Xpos, uv, z, bits, stamp, reg, n_slots):
    """A keyframe with explicit observations uv/z whose new points sit at
    Xpos (the drifted unprojection)."""
    kfs = []
    for sd in sides:
        m = sd.m
        kf = m.add_keyframe(R, t, sd.feats(uv, z, bits, n_slots), float(stamp), stamp)
        for j in range(len(uv)):
            if z[j] > 0.2:
                reg[(id(sd), j)] = m.add_point(Xpos[j], kf, j)
        m.update_connections(kf)
        kfs.append(kf)
    return kfs


def _same_map(jm, tm_, atol=1e-6):
    assert jm.n_kf == tm_.n_kf and jm.n_mp == tm_.n_mp
    assert np.array_equal(jm.kf_valid[: jm.n_kf], tm_.kf_valid[: tm_.n_kf])
    assert np.array_equal(jm.mp_valid[: jm.n_mp], tm_.mp_valid[: tm_.n_mp])
    assert np.array_equal(jm.kf_mp[: jm.n_kf], tm_.kf_mp[: tm_.n_kf])
    assert np.array_equal(jm.kf_map_id[: jm.n_kf], tm_.kf_map_id[: tm_.n_kf])
    np.testing.assert_allclose(tm_.kf_R[: tm_.n_kf], jm.kf_R[: jm.n_kf], atol=atol)
    np.testing.assert_allclose(tm_.kf_t[: tm_.n_kf], jm.kf_t[: jm.n_kf], atol=atol)
    live = jm.mp_valid[: jm.n_mp]
    np.testing.assert_allclose(tm_.mp_pos[: tm_.n_mp][live], jm.mp_pos[: jm.n_mp][live],
                               atol=atol)


def _map_invariants(m):
    for j in m.valid_mp_ids():
        for kf, slot in m.mp_obs[int(j)].items():
            assert m.kf_mp[kf, slot] == j and m.kf_valid[kf]
    for k in m.valid_kf_ids():
        for s in np.nonzero(m.kf_mp[k] >= 0)[0]:
            j = int(m.kf_mp[k, s])
            assert m.mp_valid[j] and m.mp_obs[j].get(int(k)) == s


@pytest.mark.parametrize("merge", [False, True])
def test_detect_refine_correct_matches_tpuslam(merge):
    """Detection on the first revisit KF, two refinements, correction on
    the third (same map: loop + GBA; across maps: merge + weld BA): the
    same flags, and the same corrected map to 1e-6; the revisit pose is
    corrected and the invariants hold."""
    (js, ts), flags, kf_re, (R_true, t_true) = _revisit(np.random.RandomState(5), merge)
    assert flags[0] == flags[1] == [False, False, True]
    assert js.lc.n_loops_closed == ts.lc.n_loops_closed == 1
    assert len(ts.m.map_ids()) == 1
    assert len(js.lc.loop_edges) == len(ts.lc.loop_edges) == 1
    (_, _, (sj, Rj, tj)), (_, _, (st, Rt, tt)) = js.lc.loop_edges[0], ts.lc.loop_edges[0]
    assert abs(sj - st) < 1e-6
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-6)
    _same_map(js.m, ts.m)
    m = ts.m
    ang = np.arccos(np.clip((np.trace(m.kf_R[kf_re] @ R_true.T) - 1) / 2, -1, 1))
    assert ang < 0.03 and np.linalg.norm(m.kf_t[kf_re] - t_true) < 0.1
    _map_invariants(m)


def test_aliased_structure_not_corrected():
    """A clone room fires one detection; the next KFs pan onto content only
    the clone has, so the consistency gate drops it on both sides and no
    pose moves (tests/test_loop_closer.py:200-313)."""
    rng = np.random.RandomState(11)
    P = 90
    Xa = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], 1)
    bits_a = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    Xb = Xa + np.array([0.0, 0.0, 30.0])
    bits_b = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    clone = np.array([60.0, 0.0, 0.0])
    Xc = Xa + clone + np.array([0.0, 0.0, 6.0])
    bits_c = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    loop_kw = dict(min_kfs=4, min_bow_matches=15, min_ransac_inliers=12, min_sim3_inliers=15,
                   min_proj_matches=20, run_gba=True, background_gba=False,
                   min_refine_matches=20)
    sides = [Side(False, np.concatenate([bits_a, bits_b, bits_c]), P, **loop_kw),
             Side(True, np.concatenate([bits_a, bits_b, bits_c]), P, **loop_kw)]

    def noise(b):
        return (b ^ (rng.rand(*b.shape) < 0.02)).astype(np.uint8)

    def step(R, t, X, bits, stamp, reg):
        kfs = _add_kf(sides, R, t, X, noise(bits), stamp, reg, P)
        return [sd.lc.on_new_keyframe(kf) for sd, kf in zip(sides, kfs)]

    regA, regB, regClone, regC = {}, {}, {}, {}
    for k in range(4):
        step(_so3([0.0, 0.02 * k, 0.0]), np.array([0.05 * k, 0.0, 0.0]), Xa, bits_a, k, regA)
    for k in range(6):
        step(np.eye(3), np.array([0.0, 0.0, -20.0 + 0.3 * k]), Xb, bits_b, 4 + k, regB)
    pre = [(sd.m.kf_R[: sd.m.n_kf].copy(), sd.m.kf_t[: sd.m.n_kf].copy()) for sd in sides]
    flags = [step(np.eye(3), -clone, Xa + clone, bits_a, 10, regClone)]
    assert all(sd.lc.pending is not None for sd in sides)    # the aliased detection fired
    for r in range(2):
        flags.append(step(np.eye(3), -(clone + np.array([0.0, 0.0, -2.0 - 2.0 * r])), Xc,
                          bits_c, 11 + r, regC))
    assert flags == [[False, False]] * 3
    for sd, (R0, t0) in zip(sides, pre):
        assert sd.lc.n_loops_closed == 0 and sd.lc.pending is None
        n = len(R0)
        np.testing.assert_allclose(sd.m.kf_R[:n], R0, atol=1e-12)
        np.testing.assert_allclose(sd.m.kf_t[:n], t0, atol=1e-12)


# ------------------------------------------------------------ background GBA


def _noisy_map(store, rng, n_kf=5, P=80):
    """tests/test_gba_background.py:49-76 on either store."""
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], 1)
    bits = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    m = store.SlamMap(n_feat=P)
    mp_of = {}
    for k in range(n_kf):
        R = _so3([0.0, 0.03 * k, 0.0])
        t = np.array([0.1 * k, 0.0, 0.0])
        uv, z = _project(R, t, X)
        f = store.FrameFeatures(
            xy=uv.copy(), und_xy=uv.copy(), norm_xy=(uv - [CX, CY]) / [FX, FY],
            octave=np.zeros(P, np.int32), angle=np.zeros(P), response=np.ones(P), bits=bits,
            packed=np.zeros((P, 8), np.uint32), valid=z > 0.2)
        Rn = _so3(rng.randn(3) * (0.02 if k else 0.0)) @ R
        tn = t + (rng.randn(3) * 0.02 if k else 0.0)
        kf = m.add_keyframe(Rn, tn, f, float(k), k)
        for j in range(P):
            if z[j] <= 0.2:
                continue
            if j not in mp_of:
                mp_of[j] = m.add_point(X[j] + rng.randn(3) * 0.02, kf, j)
            else:
                m.add_observation(mp_of[j], kf, j)
        m.update_connections(kf)
    return m


def _closer(port, m, background=True):
    vocab = (train_vocabulary if port else j_train_vocabulary)(
        (np.random.RandomState(3).rand(120, 256) > 0.5).astype(np.uint8), k=5, L=2, iters=3,
        **({"device": "cpu"} if port else {}))
    cfgm = t_cfg if port else j_cfg
    cfg = cfgm.SlamConfig(loop=cfgm.LoopConfig(background_gba=background))
    cam = (Pinhole if port else JPinhole)([FX, FY, CX, CY], W, H)
    lm = (t_lm if port else j_lm).LocalMapper(cam, cfg, m, **(F64 if port else {}))
    return (t_lc if port else j_lc).LoopCloser(cam, cfg, m, vocab, local_mapper=lm,
                                               **(F64 if port else {}))


def test_gba_solve_matches_tpuslam():
    """The same snapshot solved by both sides (10 LM iterations in 3
    chunks, f64): poses and points to 1e-6."""
    jm = _noisy_map(j_store, np.random.RandomState(1))
    tm_ = _noisy_map(t_store, np.random.RandomState(1))
    jlc, tlc = _closer(False, jm, False), _closer(True, tm_, False)
    jsnap, tsnap = jlc._snapshot_gba(fix_kf=0), tlc._snapshot_gba(fix_kf=0)
    for k in ("kfs", "pts", "obs_kf", "obs_pt", "fixed", "stereo"):
        assert np.array_equal(jsnap[k], tsnap[k]), k
    for a, b in zip(tlc._solve_gba(tsnap), jlc._solve_gba(jsnap)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_gba_staged_propagation():
    """KFs and points created DURING the GBA ride their snapshot ancestor's
    correction (the mTcwGBA staging semantics)."""
    m = _noisy_map(t_store, np.random.RandomState(0))
    lc = _closer(True, m)
    snap = lc._snapshot_gba(fix_kf=0)
    parent = int(snap["kfs"][-1])
    R_new, t_new = m.kf_R[parent].copy(), m.kf_t[parent] + np.array([0.05, 0.0, 0.0])
    f = t_store.FrameFeatures(
        xy=np.zeros((m.n_feat, 2)), und_xy=np.zeros((m.n_feat, 2)),
        norm_xy=np.zeros((m.n_feat, 2)), octave=np.zeros(m.n_feat, np.int32),
        angle=np.zeros(m.n_feat), response=np.ones(m.n_feat),
        bits=np.zeros((m.n_feat, 256), np.uint8), packed=np.zeros((m.n_feat, 8), np.uint32),
        valid=np.zeros(m.n_feat, bool))
    knew = m.add_keyframe(R_new, t_new, f, 99.0, 99)
    m.kf_parent[knew] = parent
    X_new = np.array([0.5, 0.5, 6.0])
    jnew = m.add_point(X_new, knew, 0)
    Rrel = R_new @ m.kf_R[parent].T
    trel = t_new - Rrel @ m.kf_t[parent]
    solved = lc._solve_gba(snap)
    lc._apply_gba(snap, solved)
    i = list(snap["kfs"]).index(parent)
    np.testing.assert_allclose(m.kf_R[parent], solved[0][i], atol=1e-12)
    np.testing.assert_allclose(m.kf_R[knew], Rrel @ m.kf_R[parent], atol=1e-9)
    np.testing.assert_allclose(m.kf_t[knew], Rrel @ m.kf_t[parent] + trel, atol=1e-9)
    np.testing.assert_allclose(m.kf_R[knew] @ m.mp_pos[jnew] + m.kf_t[knew],
                               R_new @ X_new + t_new, atol=1e-9)


def test_gba_background_matches_sync():
    m1 = _noisy_map(t_store, np.random.RandomState(1))
    m2 = _noisy_map(t_store, np.random.RandomState(1))
    lc_bg, lc_sync = _closer(True, m1, True), _closer(True, m2, False)
    lc_bg._launch_gba(fix_kf=0)
    lc_sync._launch_gba(fix_kf=0)
    lc_bg.wait_gba()
    np.testing.assert_allclose(m1.kf_R[: m1.n_kf], m2.kf_R[: m2.n_kf], atol=1e-10)
    np.testing.assert_allclose(m1.kf_t[: m1.n_kf], m2.kf_t[: m2.n_kf], atol=1e-10)
    np.testing.assert_allclose(m1.mp_pos[: m1.n_mp], m2.mp_pos[: m2.n_mp], atol=1e-10)


def test_gba_abort_discards():
    m = _noisy_map(t_store, np.random.RandomState(2))
    lc = _closer(True, m, background=False)
    snap = lc._snapshot_gba(fix_kf=0)
    snap["abort"] = threading.Event()
    snap["abort"].set()
    before = m.kf_R[: m.n_kf].copy()
    assert lc._solve_gba(snap) is None
    np.testing.assert_allclose(m.kf_R[: m.n_kf], before)


def test_gba_apply_moves_points_whose_anchor_was_culled():
    """The repaired fault (tpuslam/engine/loop_closing.py:835-838): a point
    created during a synchronous GBA whose first keyframe is culled before
    the apply. tpuslam leaves it at its stale position; the port rides it
    on its surviving observer, whose camera-frame view of it is kept."""
    out = {}
    for port, store in ((False, j_store), (True, t_store)):
        m = _noisy_map(store, np.random.RandomState(0))
        lc = _closer(port, m, background=False)
        snap = lc._snapshot_gba(fix_kf=0)
        obs = int(snap["kfs"][-1])                 # a snapshot KF that will move
        f = m.kf_feats[obs]
        knew = m.add_keyframe(m.kf_R[obs].copy(), m.kf_t[obs].copy(), f, 99.0, 99)
        m.kf_parent[knew] = obs
        X_new = np.array([0.4, -0.3, 6.0])
        j = m.add_point(X_new, knew, 0)             # first keyframe: knew
        for k in (obs, int(snap["kfs"][-2])):       # two surviving observers
            m.erase_observation(int(m.kf_mp[k, 0]), k)
            m.add_observation(j, k, 0)
        # knew is culled while the GBA runs
        m.erase_observation(j, knew)
        m.kf_valid[knew] = False
        Xc_before = m.kf_R[obs] @ X_new + m.kf_t[obs]
        solved = lc._solve_gba(snap)
        lc._apply_gba(snap, solved)
        moved = np.linalg.norm(m.kf_t[obs] - solved[1][list(snap["kfs"]).index(obs)])
        assert moved < 1e-12
        out[port] = (m, j, obs, Xc_before, X_new)
    jm, j, obs, Xc_before, X_new = out[False]
    assert jm.mp_valid[j] and out[True][0].mp_valid[j]
    np.testing.assert_array_equal(jm.mp_pos[j], X_new)                       # stale
    assert np.linalg.norm(jm.kf_R[obs] @ jm.mp_pos[j] + jm.kf_t[obs] - Xc_before) > 1e-3
    tm_, j, obs, Xc_before, X_new = out[True]
    assert np.linalg.norm(tm_.mp_pos[j] - X_new) > 1e-3                    # moved
    np.testing.assert_allclose(tm_.kf_R[obs] @ tm_.mp_pos[j] + tm_.kf_t[obs], Xc_before,
                               atol=1e-9)


def test_window_ba_abort_skips_second_phase(monkeypatch):
    """abort_check=True skips the second LM phase (one solver call)."""
    m = _noisy_map(t_store, np.random.RandomState(4))
    cam = Pinhole([FX, FY, CX, CY], W, H)
    calls = []
    orig = t_lm.B.ba_solve_np

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(t_lm.B, "ba_solve_np", counting)
    inv_s2 = 1.0 / m.scale_factors ** 2
    t_lm.window_ba(m, cam, cam.spec, inv_s2, 0.0, list(m.valid_kf_ids()),
                   abort_check=lambda: True, device="cpu")
    assert len(calls) == 1
    t_lm.window_ba(m, cam, cam.spec, inv_s2, 0.0, list(m.valid_kf_ids()),
                   abort_check=lambda: False, device="cpu")
    assert len(calls) == 3


def test_unported_loop_routes_raise():
    """The inertial GBA is ported: on an IMU-initialized map the snapshot is
    tpuslam's, the visual one when the mapper has no ImuCalib and the VI
    one (FullInertialBA) with it. Only the distributed GBA of a process
    group of more than one rank still raises (ROADMAP item
    'distribution')."""
    jm = _noisy_map(j_store, np.random.RandomState(6))
    m = _noisy_map(t_store, np.random.RandomState(6))
    jlc, lc = _closer(False, jm, background=False), _closer(True, m, background=False)
    jm.imu_initialized = m.imu_initialized = True
    jsnap, snap = jlc._snapshot_gba(fix_kf=0), lc._snapshot_gba(fix_kf=0)
    assert snap.get("kind") == jsnap.get("kind") is None
    assert np.array_equal(snap["kfs"], jsnap["kfs"])
