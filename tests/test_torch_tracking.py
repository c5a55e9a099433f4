"""The port's frontend, fused-tracker cache, tracker and local mapper vs
tpuslam's, on state carried over from a JAX System.

One JAX stereo System runs 5 rendered frames (376x240, 500 features, a
keyframe every 2 frames); a wrapper around its local mapper snapshots the
map (`map_state`) before and after each keyframe's mapping. The port's
objects start from those snapshots (`map_from_numpy`) and from the same
frame features, so each test compares one function.

Tolerances: the frontend with the gates of tests/test_torch_orb.py
(keypoint overlap >= 0.98, bits >= 0.99) and stereo depth within 1e-3 m
on >= 0.97 of the shared keypoints (a SAD minimum or the median gate can
flip at a boundary); the local-map tensors bitwise; the tracker's pose
within 2e-3 m / 2e-4 of the JAX host solver (the port solves in f32,
tpuslam in f64 here) and >= 0.95 equal associations; the mapper exact
on the structure (points created, fused, culled) and within 1e-6 on the
BA poses, run in f64 on both sides.
"""

from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine import track_device as j_td
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.io.synthetic import SyntheticSequence
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import track_device
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.frontend import Frontend
from tpuslam_torch.engine.local_mapping import LocalMapper
from tpuslam_torch.engine.tracking import Frame, State, Tracker
from tpuslam_torch.map.store import FEATURE_FIELDS, FrameFeatures, map_from_numpy, map_state

torch.set_num_threads(2)
N = 500
SEQ = dict(n_frames=5, fps=10, speed=0.5, baseline=0.1)


class SnapMapper:
    """Runs tpuslam's local mapper, snapshotting the map around each KF."""

    def __init__(self, lm):
        self.lm = lm
        self.before, self.after = {}, {}

    def on_new_keyframe(self, kf):
        self.before[kf] = (map_state(self.lm.map), list(self.lm.recent_points))
        self.lm.on_new_keyframe(kf)
        self.after[kf] = map_state(self.lm.map)


def _feats(f):
    return FrameFeatures(**{k: None if getattr(f, k) is None else np.array(getattr(f, k))
                            for k in FEATURE_FIELDS})


@pytest.fixture(scope="module")
def run():
    seq = SyntheticSequence(**SEQ)
    bf = seq.fx * seq.baseline
    frames = [(seq.frame(i), seq.frame(i, right=True)) for i in range(SEQ["n_frames"])]
    jcfg = JSlamConfig(orb=JOrbConfig(n_features=N),
                       tracking=JTrackingConfig(min_stereo_init_features=200,
                                                max_frames_between_kf=2))
    js = JSystem(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height), jcfg,
                 sensor=JSensor.STEREO, bf=bf)
    snap = SnapMapper(js.local_mapper)
    js.tracker.local_mapper = snap
    js.track_stereo(*frames[0], 0.0)
    init = NS(state=map_state(js.map), last_mp=js.tracker.last_frame.mp.copy(),
              ref_kf=js.tracker.ref_kf)
    feats1 = js.tracker.frontend.process_stereo(*frames[1])
    for i in range(1, SEQ["n_frames"]):
        js.track_stereo(*frames[i], i / seq.fps)
    cfg = SlamConfig(orb=OrbConfig(n_features=N),
                     tracking=TrackingConfig(min_stereo_init_features=200,
                                             max_frames_between_kf=2))
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    return NS(seq=seq, bf=bf, frames=frames, js=js, snap=snap, init=init, feats1=feats1,
              cfg=cfg, cam=cam)


def test_frontend_process_stereo(run):
    jf = run.feats1
    tf = Frontend(run.cam, run.cfg.orb, bf=run.bf, device="cpu").process_stereo(*run.frames[1])
    for k in FEATURE_FIELDS:
        a, b = getattr(jf, k), getattr(tf, k)
        assert a.shape == b.shape and a.dtype == b.dtype, k

    def key(f):
        return {(float(x), float(y), int(o)): i for i, (x, y, o, v) in
                enumerate(zip(f.xy[:, 0], f.xy[:, 1], f.octave, f.valid)) if v}

    kj, kt = key(jf), key(tf)
    shared = kj.keys() & kt.keys()
    assert len(kj) > 300 and len(shared) / max(len(kj), len(kt)) >= 0.98
    ij = np.array([kj[k] for k in shared])
    it = np.array([kt[k] for k in shared])
    assert np.mean(jf.bits[ij] == tf.bits[it]) >= 0.99
    assert (jf.depth[ij] > 0).sum() > 150
    assert np.mean(np.abs(jf.depth[ij] - tf.depth[it]) <= 1e-3) >= 0.97
    np.testing.assert_allclose(tf.norm_xy, jf.norm_xy, atol=1e-6)


def _port_tracker(run, state, last_mp, ref_kf, feats0):
    m = map_from_numpy(*state)
    tr = Tracker(run.cam, run.cfg, m, None, bf=run.bf, device="cpu")
    tr.state = State.OK
    tr.ref_kf = tr.last_kf = ref_kf
    tr.last_frame = Frame(feats0, 0.0, 0, R=np.eye(3), t=np.zeros(3), mp=last_mp.copy())
    return tr


def test_fused_tracker_rebuild_bitwise(run):
    """The local-map tensors of the fused step, built from the final map
    of the JAX run with its last frame's covisibility vote."""
    js = run.js
    jft = j_td.FusedTracker(js.tracker)
    assert jft.build_local_map(js.tracker.last_frame.mp)
    m = map_from_numpy(*map_state(js.map))
    tft = track_device.FusedTracker(NS(map=m, camera=run.cam, cfg=run.cfg, bf=run.bf,
                                       sensor="stereo", ref_kf=-1, device="cpu"))
    assert tft.build_local_map(js.tracker.last_frame.mp)
    assert tft.tr.ref_kf == js.tracker.ref_kf and tft.Pb == jft.Pb
    assert np.array_equal(tft.ids, jft.ids)
    for k in ("mapGeo", "mapBits", "mapValid", "refBits", "refMeta"):
        a, b = np.asarray(getattr(jft, k)), getattr(tft, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_track_reference_kf_and_local_map(run):
    """Frame 1 against the map right after stereo init: reference-KF
    match + pose, then local-map tracking from the same start."""
    jtr = run.js.tracker
    init = run.init
    kf0_feats = _feats(run.js.map.kf_feats[init.ref_kf])
    tr = _port_tracker(run, init.state, init.last_mp, init.ref_kf, kf0_feats)
    # tpuslam's tracker over a carried copy of the same state
    from tpuslam.engine.tracking import Frame as JFrame
    from tpuslam.engine.tracking import Tracker as JTracker
    from tpuslam.map.store import SlamMap as JSlamMap

    jm = JSlamMap(N)
    for k, v in init.state[0].items():
        setattr(jm, k, v if not isinstance(v, list) else [dict(d) if isinstance(d, dict)
                                                          else d for d in v])
    jm.kf_feats = list(run.js.map.kf_feats)
    jm.rebuild_native()
    jt = JTracker(jtr.camera, jtr.cfg, jm, None, sensor="stereo", bf=run.bf)
    jt.state = jt.state.OK
    jt.ref_kf = jt.last_kf = init.ref_kf
    jt.last_frame = JFrame(run.js.map.kf_feats[init.ref_kf], 0.0, 0, R=np.eye(3),
                           t=np.zeros(3), mp=init.last_mp.copy())
    jfr = JFrame(run.feats1, 0.1, 1)
    tfr = Frame(_feats(run.feats1), 0.1, 1)
    assert jt._track_reference_kf(jfr, np.eye(3), np.zeros(3))
    assert tr._track_reference_kf(tfr, np.eye(3), np.zeros(3))
    assert np.mean(jfr.mp == tfr.mp) >= 0.95 and (tfr.mp >= 0).sum() > 100
    np.testing.assert_allclose(tfr.t, jfr.t, atol=2e-3)
    np.testing.assert_allclose(tfr.R, jfr.R, atol=2e-4)
    assert abs(tr.n_inliers - jt.n_inliers) <= 0.05 * jt.n_inliers
    # local-map tracking from the SAME start on both sides
    tfr.R, tfr.t, tfr.mp = jfr.R.copy(), jfr.t.copy(), jfr.mp.copy()
    ok_j = jt._track_local_map(jfr)
    ok_t = tr._track_local_map(tfr)
    assert ok_j and ok_t and tr.ref_kf == jt.ref_kf
    assert np.mean(jfr.mp == tfr.mp) >= 0.95
    np.testing.assert_allclose(tfr.t, jfr.t, atol=2e-3)
    np.testing.assert_allclose(tfr.R, jfr.R, atol=2e-4)
    n = jm.n_mp
    assert np.mean(tr.map.mp_found[:n] == jm.mp_found[:n]) >= 0.95
    assert np.mean(tr.map.mp_visible[:n] == jm.mp_visible[:n]) >= 0.95


def test_local_mapper_on_new_keyframe(run):
    """Every keyframe of the JAX run after the first: the port's mapper on
    the carried pre-mapping state must produce tpuslam's post-mapping map
    (triangulation, fusion, culling exact; BA in f64 within 1e-6)."""
    kfs = sorted(k for k in run.snap.before if k > 0)
    assert len(kfs) >= 2, kfs
    for kf in kfs:
        (arrays, feats), recent = run.snap.before[kf]
        m = map_from_numpy(arrays, feats)
        lm = LocalMapper(run.cam, run.cfg, m, bf=run.bf, dtype=torch.float64, device="cpu")
        lm.recent_points = list(recent)
        lm.on_new_keyframe(kf)
        want, _ = run.snap.after[kf]
        got, _ = map_state(m)
        assert got["n_mp"] == want["n_mp"] > arrays["n_mp"]       # points triangulated
        for k in ("mp_valid", "kf_mp", "kf_valid", "kf_parent", "mp_replaced_by",
                  "mp_bits", "mp_found", "mp_visible"):
            assert np.array_equal(got[k], want[k]), (kf, k)
        assert got["covis"] == want["covis"] and got["mp_obs"] == want["mp_obs"]
        np.testing.assert_allclose(got["kf_R"], want["kf_R"], atol=1e-6)
        np.testing.assert_allclose(got["kf_t"], want["kf_t"], atol=1e-6)
        np.testing.assert_allclose(got["mp_pos"], want["mp_pos"], atol=1e-5)
        assert got["map_version"] == want["map_version"]
