"""The fused stereo tracking step: PyTorch port (FusedTrackStep) vs
tpuslam's make_fused_step, on CPU.

Both sides run the Pallas pose-LM semantics: tpuslam's step solver is
patched, in these tests only, to pose_optimize_fused(interpret=True), and
the port's wrapper runs its plain version of that kernel on CPU tensors.
Tolerances: pose R 5e-4, t 5e-3 (f32 sums in another order, compounded
over 4 solves); assoc agreement >= 0.95 and rowflags agreement >= 0.98
(a descriptor bit or a window gate can flip at a boundary).
"""

import functools
import os
import subprocess
import sys
from types import SimpleNamespace as NS

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.engine.track_device as j_td
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine.config import SlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.tracking import Tracker
from tpuslam.map.store import FrameFeatures, SlamMap
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.solve.pose_opt_pallas import pose_optimize_fused
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.local_map import stereo_local_map

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N, P_BASE = 240, 376, 500, 512
SEQ = dict(n_frames=3, fps=20, speed=0.5, baseline=0.11)


def _u8(im):
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


@pytest.fixture(autouse=True)
def pallas_semantics(monkeypatch):
    monkeypatch.setattr(j_td, "_pose_solver",
                        lambda: functools.partial(pose_optimize_fused, interpret=True))


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(**SEQ)
    frames = [np.stack([_u8(seq.frame(i)), _u8(seq.frame(i, right=True))])
              for i in range(SEQ["n_frames"])]
    bf = seq.fx * seq.baseline
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H)
    step = FusedTrackStep(cam, OrbConfig(n_features=N), TrackingConfig(), 8, 1.2, bf, True,
                          device="cpu")
    f0 = step.extract(torch.tensor(frames[0]))
    f0["und_xy"] = f0["xy"]
    f0 = {k: v.numpy() for k, v in f0.items()}
    local = stereo_local_map(f0, seq.fx, seq.fy, seq.cx, seq.cy, step.sf.numpy(), p_base=P_BASE)
    return NS(seq=seq, frames=frames, bf=bf, step=step, f0=f0, local=local)


def _pose0():
    return np.concatenate([np.eye(3).ravel(), np.zeros(4)]).astype(np.float32)


def _compare(jo, to):
    jp, tp = np.asarray(jo["pose"]), to["pose"].numpy()
    np.testing.assert_allclose(tp[:9], jp[:9], atol=5e-4)
    np.testing.assert_allclose(tp[9:12], jp[9:12], atol=5e-3)
    assert np.mean(to["assoc"].numpy() == np.asarray(jo["assoc"])) >= 0.95
    assert np.mean(to["rowflags"].numpy() == np.asarray(jo["rowflags"])) >= 0.98
    assert to["rowflags"].shape == jo["rowflags"].shape


def test_local_map_matches_tpuslam_host_path(scene):
    """stereo_local_map == tpuslam's stereo point spawn + point stats +
    FusedTracker._rebuild packing, run on the same features."""
    f0, seq = scene.f0, scene.seq
    xy = f0["xy"]
    norm = np.stack([(xy[:, 0] - np.float32(seq.cx)) / np.float32(seq.fx),
                     (xy[:, 1] - np.float32(seq.cy)) / np.float32(seq.fy)], 1)
    ff = FrameFeatures(
        xy=xy.astype(np.float64), und_xy=xy.astype(np.float64),
        norm_xy=norm.astype(np.float64),
        octave=f0["octave"], angle=f0["angle"].astype(np.float64),
        response=f0["resp"].astype(np.float64), bits=f0["bits"], packed=f0["packed"],
        valid=f0["valid"], depth=f0["depth"].astype(np.float64),
        u_right=f0["u_right"].astype(np.float64))
    m = SlamMap(n_feat=N)
    frame = NS(feats=ff, R=np.eye(3), t=np.zeros(3), mp=np.full(N, -1, np.int32))
    kf = m.add_keyframe(frame.R, frame.t, ff, 0.0, 0)
    cam = JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H)
    n_pts = Tracker._spawn_stereo_points(NS(map=m, camera=cam, cfg=SlamConfig(), bf=scene.bf),
                                         kf, frame, max_new=10 ** 9)
    ft = NS(map=m, tr=NS(ref_kf=kf), P_BASE=P_BASE)
    assert j_td.FusedTracker._rebuild(ft, [kf], None)
    mapGeo, mapBits, mapValid, refBits, refMeta = scene.local
    assert int(mapValid.sum()) == n_pts
    np.testing.assert_allclose(mapGeo, np.asarray(ft.mapGeo), rtol=2e-6, atol=1e-6)
    assert np.array_equal(mapBits, np.asarray(ft.mapBits))
    assert np.array_equal(mapValid, np.asarray(ft.mapValid))
    assert np.array_equal(refBits, np.asarray(ft.refBits))
    np.testing.assert_allclose(refMeta, np.asarray(ft.refMeta), atol=1e-6)


@pytest.mark.parametrize("stereo", [True, False])
def test_fused_step_matches_jax_on_rendered_frames(scene, stereo):
    seq = scene.seq
    jcam = JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H)
    jstep = j_td.make_fused_step(jcam, JOrbConfig(n_features=N), JTrackingConfig(), 8, 1.2,
                                 scene.bf, stereo)
    step = scene.step if stereo else FusedTrackStep(
        Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], W, H), OrbConfig(n_features=N),
        TrackingConfig(), 8, 1.2, scene.bf, False, device="cpu")
    pose = _pose0()
    for i in ((1, 2) if stereo else (1,)):
        imgs = scene.frames[i] if stereo else scene.frames[i][:1]
        args = (imgs, *scene.local, pose, np.float32([60.0]))
        jo = jstep(*[jnp.asarray(a) for a in args])
        to = step(*step_inputs_from_numpy(*args, device="cpu"))
        _compare(jo, to)
        np.testing.assert_allclose(to["feats"]["depth"].numpy(),
                                   np.asarray(jo["feats"]["depth"]), atol=1e-3)
        assert int(to["pose"][12]) >= 100
        pose = np.asarray(jo["pose"])      # chain both sides from the same pose


def test_fused_step_on_graft_entry_inputs():
    """The exact inputs of __graft_entry__.entry() (752x480, N=1024,
    P=2048, random images and map) through step_inputs_from_numpy."""
    sys.path.insert(0, ROOT)
    import __graft_entry__

    forward, args = __graft_entry__.entry()
    jp, ja, jr = forward(*args)
    step = FusedTrackStep(Pinhole([458.0, 458.0, 752 / 2.0, 480 / 2.0], 752, 480),
                          OrbConfig(n_features=1024), TrackingConfig(), 8, 1.2,
                          458.0 * 0.11, True, device="cpu")
    inputs = step_inputs_from_numpy(*[np.asarray(a) for a in args], device="cpu")
    assert inputs[0].dtype == torch.uint8 and inputs[0].shape == (2, 480, 752)
    to = step(*inputs)
    _compare(dict(pose=jp, assoc=ja, rowflags=jr), to)
    assert to["pose"].shape == (13,) and to["assoc"].shape == (1024,)
    assert to["rowflags"].shape == (4096,)


NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["tpuslam"] = None
import numpy as np, torch
torch.set_num_threads(2)
import tpuslam_torch
for m in pkgutil.walk_packages(tpuslam_torch.__path__, "tpuslam_torch."):
    importlib.import_module(m.name)
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.local_map import stereo_local_map
seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
u8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)
frames = [np.stack([u8(seq.frame(i)), u8(seq.frame(i, right=True))]) for i in range(3)]
step = FusedTrackStep(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
                      OrbConfig(n_features=500), TrackingConfig(), 8, 1.2,
                      seq.fx * seq.baseline, True, device="cpu")
f0 = step.extract(torch.tensor(frames[0]))
f0["und_xy"] = f0["xy"]
local = stereo_local_map({k: v.numpy() for k, v in f0.items()}, seq.fx, seq.fy,
                         seq.cx, seq.cy, step.sf.numpy(), p_base=512)
pose = torch.tensor(np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32))
R0, t0 = seq.gt_pose_cw(0.0)
for i in (1, 2):
    inp = step_inputs_from_numpy(frames[i], *local, pose.numpy(), np.float32([60]), "cpu")
    pose = step(*inp[:6], pose, inp[7])["pose"]
    Rg, tg = seq.gt_pose_cw(i / seq.fps)
    Rrel = Rg @ R0.T
    err = np.linalg.norm(pose[9:12].numpy() - (tg - Rrel @ t0))
    assert err < 0.05 and int(pose[12]) >= 100, (i, err, pose)
# the System: stereo init, fused tracking, a keyframe with local mapping
from tpuslam_torch.engine.config import SlamConfig
from tpuslam_torch.engine.system import Sensor, System
slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
              SlamConfig(orb=OrbConfig(n_features=500),
                         tracking=TrackingConfig(min_stereo_init_features=200,
                                                 max_frames_between_kf=1)),
              sensor=Sensor.STEREO, bf=seq.fx * seq.baseline, device="cpu")
for i in range(3):
    slam.track_stereo(seq.frame(i), seq.frame(i, right=True), i / seq.fps)
assert slam.get_tracking_state().name == "OK" and len(slam.trajectory_tum()) == 3
assert len(slam.map.valid_kf_ids()) >= 2 and slam.map.map_version >= 1
# mono with a vocabulary (two-view init, loop closer) and an RGB-D frame
from tpuslam_torch.place import train_vocabulary
rs = np.random.RandomState(0)
vocab = train_vocabulary((rs.rand(300, 256) > 0.5).astype(np.uint8), k=4, L=2, iters=2,
                         device="cpu")
mono = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
              SlamConfig(orb=OrbConfig(n_features=500)), sensor=Sensor.MONOCULAR, vocab=vocab,
              device="cpu")
seq_m = SyntheticSequence(n_frames=4, fps=10, speed=0.5)
for i in range(4):
    mono.track_monocular(seq_m.frame(i), i / 10)
assert mono.get_tracking_state().name == "OK" and len(mono.loop_closer.kf_bow) >= 2
rgbd = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
              SlamConfig(orb=OrbConfig(n_features=500),
                         tracking=TrackingConfig(min_stereo_init_features=200)),
              sensor=Sensor.RGBD, bf=seq.fx * 0.08, device="cpu")
assert rgbd.track_rgbd(*seq_m.frame_rgbd(0), 0.0) is not None
loaded = {k.split(".")[0] for k, v in sys.modules.items() if v is not None}
assert "jax" not in loaded and "tpuslam" not in loaded
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    """The port imports every module and runs (the fused step; the stereo,
    mono + vocabulary and RGB-D Systems) with jax and tpuslam blocked."""
    res = subprocess.run([sys.executable, "-c", NO_JAX], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
