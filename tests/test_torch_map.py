"""The map store, the host matcher and the mapping kernels of the port vs
tpuslam, and the two reference faults the port repairs.

Inputs are made with numpy from a seed: random descriptors and masks for
the matcher, and a synthetic map (keyframes whose features are noisy
projections of shared points, with a few bits flipped per descriptor) for
the store and the kernels. Tolerances: the matcher, the store and both
kernels are integer or copy arithmetic plus f32 geometry computed the
same way on both sides, so their results must be EQUAL.
"""

import threading
from types import SimpleNamespace as NS

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.core import lie as j_lie
from tpuslam.engine import local_mapping as j_lm
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.map_device import MapDeviceKernels as JMapDeviceKernels
from tpuslam.map.store import FrameFeatures as JFrameFeatures
from tpuslam.map.store import SlamMap as JSlamMap
from tpuslam.ops import match as j_match
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import MappingConfig, SlamConfig
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.map_device import MapDeviceKernels
from tpuslam_torch.engine.system import System
from tpuslam_torch.map.store import (FrameFeatures, SlamMap, map_from_numpy,
                                     map_state)
from tpuslam_torch.ops import match

torch.set_num_threads(2)
CAM = (200.0, 200.0, 188.0, 120.0)
W, H, N_FEAT = 376, 240, 160


# ---------------------------------------------------------------- matcher


@pytest.mark.parametrize("kind", ["ref_kf", "motion", "local"])
def test_match_padded_matches_tpuslam(rng, kind):
    n, m = 90, 130
    base = rng.randint(0, 2, (m, 256)).astype(np.uint8)
    bits_b = base.copy()
    pick = rng.randint(0, m, n)
    bits_a = base[pick].copy()
    flips = rng.rand(n, 256) < rng.uniform(0.02, 0.25, (n, 1))
    bits_a[flips] ^= 1
    ang_a = rng.uniform(0, 2 * np.pi, n)
    ang_b = (ang_a[rng.permutation(n)].tolist() + rng.uniform(0, 6, m - n).tolist())[:m]
    ang_b = np.asarray(ang_b)
    mask = rng.rand(n, m) < 0.6
    mask[np.arange(n), pick] = True
    mask[:4] = False                              # rows with no candidate
    oct_b = rng.randint(0, 4, m).astype(np.int32)
    kw = {"ref_kf": dict(max_dist=j_match.TH_LOW, nn_ratio=0.7, ang_a=ang_a, ang_b=ang_b),
          "motion": dict(max_dist=j_match.TH_HIGH, ang_a=ang_a, ang_b=ang_b),
          "local": dict(max_dist=j_match.TH_HIGH, nn_ratio=0.8, oct_b=oct_b,
                        ratio_same_octave=True)}[kind]
    ji, jd = j_match.match_padded(bits_a, bits_b, mask, **kw)
    ti, td = match.match_padded(bits_a, bits_b, mask, device="cpu", **kw)
    assert (ji >= 0).sum() > 10
    assert np.array_equal(ti, ji) and np.array_equal(td, jd)


def test_host_mask_builders_match_tpuslam(rng):
    uv, xy = rng.rand(40, 2) * 100, rng.rand(60, 2) * 100
    r = rng.rand(40) * 10
    assert np.array_equal(match.window_mask_np(uv, xy, r), j_match.window_mask_np(uv, xy, r))
    pl, ob = rng.randint(0, 8, 40), rng.randint(0, 8, 60)
    assert np.array_equal(match.level_mask_np(pl, ob, 1, 0), j_match.level_mask_np(pl, ob, 1, 0))


# ------------------------------------------------------------ synthetic map


def _scene(seed=0, n_kf=3, n_pts=120, spacing=0.15):
    rng = np.random.RandomState(seed)
    fx, fy, cx, cy = CAM
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.2, 1.2, n_pts),
                  rng.uniform(2.5, 6, n_pts)], -1)
    pbits = rng.randint(0, 2, (n_pts, 256)).astype(np.uint8)
    pang = rng.uniform(0, 2 * np.pi, n_pts)
    poses, feats, owner = [], [], []
    for k in range(n_kf):
        R = np.asarray(j_lie.so3_exp(jnp.asarray(rng.randn(3) * 0.01)))
        t = np.array([-spacing * k, 0.0, 0.0])
        Xc = X @ R.T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], 1)
        vis = np.nonzero((uv[:, 0] > 2) & (uv[:, 0] < W - 2) & (uv[:, 1] > 2)
                         & (uv[:, 1] < H - 2))[0]
        vis = rng.permutation(vis)[: N_FEAT - 20]
        xy = np.concatenate([uv[vis] + rng.randn(len(vis), 2) * 0.3,
                             rng.rand(N_FEAT - len(vis), 2) * [W, H]])
        bits = np.concatenate([pbits[vis], rng.randint(0, 2, (N_FEAT - len(vis), 256))])
        bits = bits.astype(np.uint8)
        bits[rng.rand(N_FEAT, 256) < 0.02] ^= 1
        ang = np.concatenate([pang[vis] + rng.randn(len(vis)) * 0.02,
                              rng.uniform(0, 2 * np.pi, N_FEAT - len(vis))])
        octv = rng.randint(0, 2, N_FEAT).astype(np.int32)
        norm = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy], 1)
        packed = (bits.reshape(N_FEAT, 8, 32).astype(np.uint64)
                  << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        feats.append(dict(xy=xy, und_xy=xy.copy(), norm_xy=norm, octave=octv, angle=ang,
                          response=np.ones(N_FEAT), bits=bits, packed=packed,
                          valid=np.ones(N_FEAT, bool), depth=None, u_right=None))
        poses.append((R, t))
        owner.append(vis)
    return NS(X=X, poses=poses, feats=feats, owner=owner)


def _apply_ops(m, FF, sc):
    """One op sequence of the store's API: keyframes, points and their
    observations, stats, covisibility, replace, erase, bad flags."""
    for k, ((R, t), f) in enumerate(zip(sc.poses, sc.feats)):
        m.add_keyframe(R, t, FF(**f), 0.1 * k, k)
    ids = {}
    for slot, j in enumerate(sc.owner[0][:60]):
        ids[int(j)] = m.add_point(sc.X[j], 0, slot)
    for k in range(1, len(sc.poses)):
        for slot, j in enumerate(sc.owner[k]):
            if int(j) in ids and slot % 5:
                m.add_observation(ids[int(j)], k, slot)
    for mp in list(ids.values())[:20]:
        m.update_point_stats(mp)
    m.update_point_stats_batch(list(ids.values()))
    for k in range(len(sc.poses)):
        m.update_connections(k, th=5)
    pts = list(ids.values())
    m.replace_point(pts[3], pts[4])
    m.erase_observation(pts[5], 1)
    m.set_bad_point(pts[6])
    m.update_point_stats_batch(pts)
    return NS(red=[m.redundancy(k, 1) for k in range(len(sc.poses))],
              cov=[m.best_covisible(k) for k in range(len(sc.poses))],
              pred=m.predict_scale(np.linalg.norm(m.mp_pos[:10], axis=1), np.arange(10)),
              graph=m.check_essential_graph(), resolved=m.resolve_replaced(pts[3]))


def _assert_same_state(a, b):
    sa, fa = map_state(a)
    sb, fb = map_state(b)
    for k in sa:
        if isinstance(sa[k], np.ndarray):
            assert sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k] or (k == "kf_tcp" and all(
                (x is None) == (y is None) for x, y in zip(sa[k], sb[k]))), k
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert (x is None) == (y is None)
        for k in x or {}:
            assert (x[k] is None and y[k] is None) or np.array_equal(x[k], y[k]), k


def test_slam_map_op_sequence_matches_tpuslam():
    sc = _scene()
    jm, tm = JSlamMap(N_FEAT), SlamMap(N_FEAT)
    jr, tr = _apply_ops(jm, JFrameFeatures, sc), _apply_ops(tm, FrameFeatures, sc)
    assert jr.red == tr.red and jr.cov == tr.cov and jr.graph == tr.graph == []
    assert np.array_equal(jr.pred, tr.pred) and jr.resolved == tr.resolved
    assert jm.mp_valid[: jm.n_mp].sum() > 40 and any(jm.covis)
    _assert_same_state(jm, tm)


def test_map_from_numpy_carries_the_state():
    sc = _scene(seed=1)
    jm = JSlamMap(N_FEAT)
    _apply_ops(jm, JFrameFeatures, sc)
    tm = map_from_numpy(*map_state(jm))
    _assert_same_state(jm, tm)
    assert tm._native is not None
    # the carried map keeps working like the original
    for m in (jm, tm):
        m.add_observation(int(np.nonzero(m.mp_valid)[0][0]), 2, N_FEAT - 1)
        m.update_connections(2, th=5)
    assert tm.redundancy(1, 1) == jm.redundancy(1, 1)
    _assert_same_state(jm, tm)


# ---------------------------------------------------------------- kernels


@pytest.fixture(scope="module")
def kernel_maps():
    sc = _scene(seed=2, n_kf=4)
    jm = JSlamMap(N_FEAT)
    _apply_ops(jm, JFrameFeatures, sc)
    tm = map_from_numpy(*map_state(jm))
    sf = jm.scale_factors
    jk = JMapDeviceKernels(JPinhole(list(CAM), W, H), sf, 3.0, len(sf))
    tk = MapDeviceKernels(Pinhole(list(CAM), W, H), sf, 3.0, len(sf), "cpu")
    return jm, tm, jk, tk


@pytest.mark.parametrize("targets", [[1, 2, 3], [0]])
def test_fuse_kernel_matches_tpuslam(kernel_maps, targets):
    jm, tm, jk, tk = kernel_maps
    pts = np.nonzero(jm.mp_valid[: jm.n_mp])[0]
    jb, jd = jk.fuse_run(jk.fuse_snapshot(jm, targets, pts))
    tb, td = tk.fuse_run(tk.fuse_snapshot(tm, targets, pts))
    assert (jb >= 0).sum() > 20
    assert np.array_equal(tb, jb) and np.array_equal(td, jd)


def _tri_inputs(m, kf, used):
    K = np.array([[CAM[0], 0, CAM[2]], [0, CAM[1], CAM[3]], [0, 0, 1]])
    Kinv = np.linalg.inv(K)
    Fms = []
    for kn in used:
        R12 = m.kf_R[kf] @ m.kf_R[kn].T
        t12 = -R12 @ m.kf_t[kn] + m.kf_t[kf]
        E = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]]) @ R12
        Fms.append((Kinv.T @ E @ Kinv).astype(np.float32))
    free1 = (m.kf_mp[kf] < 0) & m.kf_feats[kf].valid
    free2 = np.stack([(m.kf_mp[k] < 0) & m.kf_feats[k].valid for k in used])
    sig2 = np.stack([3.84 * m.scale_factors[m.kf_feats[k].octave] ** 2 for k in used])
    return free1, np.stack(Fms), free2, sig2.astype(np.float32)


def test_triangulation_kernel_matches_tpuslam(kernel_maps):
    jm, tm, jk, tk = kernel_maps
    free1, Fms, free2, sig2 = _tri_inputs(jm, 3, [0, 1, 2])
    ji, jd = jk.tri_match(jm, 3, free1, [0, 1, 2], Fms, free2, False, sig2)
    ti, td = tk.tri_match(tm, 3, free1, [0, 1, 2], Fms, free2, False, sig2)
    assert (ji >= 0).sum() > 10
    assert np.array_equal(ti, ji) and np.array_equal(td, jd)


# ------------------------------------------------------- repaired faults


def _tree_map(FF, SM):
    """KF 0 root, KF 1 its child, KF 2 a child of KF 1 and KF 1's strongest
    covisible: culling KF 1 anchors it at its own child."""
    sc = _scene(seed=3)
    m = SM(N_FEAT)
    for k, ((R, t), f) in enumerate(zip(sc.poses, sc.feats)):
        m.add_keyframe(R, t, FF(**f), 0.1 * k, k)
    m.kf_parent[:3] = [-1, 0, 1]
    m.covis[0], m.covis[1], m.covis[2] = {1: 10}, {0: 10, 2: 50}, {1: 50}
    return m


def test_erase_keyframe_reparents_to_the_saved_parent():
    m = _tree_map(FrameFeatures, SlamMap)
    lm = LocalMapper(Pinhole(list(CAM), W, H), SlamConfig(), m, bf=20.0, device="cpu")
    lm._erase_keyframe(1)
    assert not m.kf_valid[1]
    assert m.kf_parent[2] == 0          # the saved parent, not the anchor
    assert m.kf_parent[1] == 2          # the recovery pointer: the anchor
    assert all(m.kf_parent[k] != k for k in range(3))
    assert m.check_essential_graph() == []
    # the trajectory walk through the culled KF terminates at a valid KF
    out = {}
    walker = threading.Thread(target=lambda: out.setdefault(
        "pose", System._ref_pose(NS(map=m), 1)), daemon=True)
    walker.start()
    walker.join(timeout=10)
    assert not walker.is_alive()
    R, t = out["pose"]
    np.testing.assert_allclose(R, m.kf_R[1], atol=1e-12)
    np.testing.assert_allclose(t, m.kf_t[1], atol=1e-12)
    # tpuslam's mapper, on the same map, makes KF 2 its own parent
    jm = _tree_map(JFrameFeatures, JSlamMap)
    j_lm.LocalMapper(JPinhole(list(CAM), W, H), JSlamConfig(), jm, mono=False,
                     bf=20.0)._erase_keyframe(1)
    assert jm.kf_parent[2] == 2


def _wide_map(FF, SM, n_kf=36):
    """n_kf keyframes 3 cm apart that all see the same 40 points."""
    sc = _scene(seed=4, n_kf=n_kf, n_pts=100, spacing=0.03)
    m = SM(N_FEAT)
    for k, ((R, t), f) in enumerate(zip(sc.poses, sc.feats)):
        m.add_keyframe(R, t, FF(**f), 0.1 * k, k)
    common = sorted(set.intersection(*[set(o.tolist()) for o in sc.owner]))[:40]
    ids = {}
    for k in range(n_kf):
        slot_of = {int(j): s for s, j in enumerate(sc.owner[k])}
        for j in common:
            if j not in ids:
                ids[j] = m.add_point(sc.X[j], k, slot_of[j])
            else:
                m.add_observation(ids[j], k, slot_of[j])
    for k in range(n_kf):
        m.update_connections(k)
    return m


def test_create_new_points_caps_the_neighbours():
    cfg = SlamConfig(mapping=MappingConfig(n_triangulate_neighbors=40))
    m = _wide_map(FrameFeatures, SlamMap)
    assert len(m.best_covisible(35)) > 32
    lm = LocalMapper(Pinhole(list(CAM), W, H), cfg, m, bf=20.0, device="cpu")
    seen = []
    real = lm.devk.tri_match
    lm.devk.tri_match = lambda *a: seen.append(len(a[3])) or real(*a)
    n_new = lm._create_new_points(35)
    assert seen and 0 < seen[0] <= 32
    assert n_new >= 0
    # tpuslam breaks on the same request (Fp[:T] = Fms with T > 32)
    jcfg = JSlamConfig()
    jcfg.mapping.n_triangulate_neighbors = 40
    jm = _wide_map(JFrameFeatures, JSlamMap)
    jlm = j_lm.LocalMapper(JPinhole(list(CAM), W, H), jcfg, jm, mono=False, bf=20.0)
    with pytest.raises(ValueError):
        jlm._create_new_points(35)
