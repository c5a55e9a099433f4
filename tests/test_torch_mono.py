"""The port's monocular tracking on the CPU: the fused step in mono mode,
and System.track_monocular against tpuslam's and against the gates of
tests/test_e2e_mono.py.

  * The mono fused step: FusedTrackStep(stereo=False) vs tpuslam's
    make_fused_step(stereo=False) on the same frames and local map, chained
    over two frames; the tolerances of tests/test_torch_track_step.py.
  * The slice: tpuslam's mono System and the port's on the same 9
    rendered frames (376x240, 600 features). The port's two-view draw is
    tpuslam's own (its PRNGKey(0) choice), so both initialize on the same
    frame from the same samples; per frame the tracking state and the
    keyframe count must be equal and the poses within 1 cm / 0.2 degrees
    (the map's scale is the initial median depth of 1).
  * The port alone over 28 frames, with the gates of tests/test_e2e_mono.py
    (state OK, >= 3 KFs, > 100 points, scaled ATE < 0.10, map invariants,
    normalized TUM quaternions).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.engine.track_device as j_td
from tpuslam.cameras import Pinhole as JPinhole
from tpuslam.engine import System as JSystem
from tpuslam.engine.config import SlamConfig as JSlamConfig
from tpuslam.engine.config import TrackingConfig as JTrackingConfig
from tpuslam.engine.system import Sensor as JSensor
from tpuslam.eval.ate import ate_rmse
from tpuslam.ops.orb import OrbConfig as JOrbConfig
from tpuslam.solve.pose_opt_pallas import pose_optimize_fused
from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
from tpuslam_torch.engine.tracking import State
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.local_map import stereo_local_map
from tpuslam_torch.ops import twoview

torch.set_num_threads(2)


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1.0) / 2.0, -1.0, 1.0))))


def _u8(im):
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


def test_mono_fused_step_matches_tpuslam(monkeypatch):
    """Frames 1 and 2 of a sequence through the mono step on both sides,
    chained from the same pose, against a local map from frame 0."""
    monkeypatch.setattr(j_td, "_pose_solver",
                        lambda: functools.partial(pose_optimize_fused, interpret=True))
    seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
    frames = [np.stack([_u8(seq.frame(i)), _u8(seq.frame(i, right=True))]) for i in range(3)]
    bf = seq.fx * seq.baseline
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    st = FusedTrackStep(cam, OrbConfig(n_features=500), TrackingConfig(), 8, 1.2, bf, True,
                        device="cpu")
    f0 = st.extract(torch.tensor(frames[0]))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.numpy() for k, v in f0.items()}, seq.fx, seq.fy, seq.cx,
                             seq.cy, st.sf.numpy(), p_base=512)
    mono = FusedTrackStep(cam, OrbConfig(n_features=500), TrackingConfig(), 8, 1.2, 0.0, False,
                          device="cpu")
    jstep = j_td.make_fused_step(JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width,
                                          seq.height),
                                 JOrbConfig(n_features=500), JTrackingConfig(), 8, 1.2, 0.0,
                                 False)
    pose = np.concatenate([np.eye(3).ravel(), np.zeros(4)]).astype(np.float32)
    for i in (1, 2):
        args = (frames[i][:1], *local, pose, np.float32([60.0]))
        jo = jstep(*[jnp.asarray(a) for a in args])
        to = mono(*step_inputs_from_numpy(*args, device="cpu"))
        jp, tp = np.asarray(jo["pose"]), to["pose"].numpy()
        np.testing.assert_allclose(tp[:9], jp[:9], atol=5e-4)
        np.testing.assert_allclose(tp[9:12], jp[9:12], atol=5e-3)
        assert np.mean(to["assoc"].numpy() == np.asarray(jo["assoc"])) >= 0.95
        assert np.mean(to["rowflags"].numpy() == np.asarray(jo["rowflags"])) >= 0.98
        assert (to["feats"]["u_right"] == -1).all() and int(tp[12]) >= 100
        pose = jp


@pytest.fixture
def jax_init_draw(monkeypatch):
    """The port's two-view samples = tpuslam's PRNGKey(seed) choice."""
    def draw(valid, generator=None, n_hyp=twoview.N_HYP):
        p = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid, np.float32)
        key = jax.random.PRNGKey(generator.initial_seed() if generator is not None else 0)
        return torch.as_tensor(np.asarray(jax.random.choice(
            key, len(p), shape=(n_hyp, 8), p=jnp.asarray(p / max(p.sum(), 1.0)))))

    monkeypatch.setattr(twoview, "draw_samples", draw)


def test_slice_matches_tpuslam_mono_system(jax_init_draw):
    seq = SyntheticSequence(n_frames=9, fps=10, speed=0.5)
    cam = [seq.fx, seq.fy, seq.cx, seq.cy]
    js = JSystem(JPinhole(cam, seq.width, seq.height),
                 JSlamConfig(orb=JOrbConfig(n_features=600),
                             tracking=JTrackingConfig(max_frames_between_kf=3)),
                 sensor=JSensor.MONOCULAR)
    ts = System(Pinhole(cam, seq.width, seq.height),
                SlamConfig(orb=OrbConfig(n_features=600),
                           tracking=TrackingConfig(max_frames_between_kf=3)),
                sensor=Sensor.MONOCULAR, dtype=torch.float64, device="cpu")
    n_ok = 0
    for i in range(seq.n_frames):
        img = seq.frame(i)
        Tj = js.track_monocular(img, i / seq.fps)
        Tt = ts.track_monocular(img, i / seq.fps)
        assert ts.get_tracking_state().name == js.get_tracking_state().name, i
        assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
        assert (Tt is None) == (Tj is None), i
        if Tj is not None:
            n_ok += 1
            assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
            assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
    assert n_ok >= 6 and len(ts.map.valid_kf_ids()) >= 3
    assert ts.get_tracking_state() == State.OK
    for (a, b) in zip(ts.trajectory_tum(), js.trajectory_tum()):
        np.testing.assert_allclose(a, b, atol=0.01)


def test_port_mono_gates(tmp_path):
    """tests/test_e2e_mono.py's gates on the port alone (f32 solvers)."""
    seq = SyntheticSequence(n_frames=28, fps=10, speed=0.5)
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=600)), sensor=Sensor.MONOCULAR,
                  device="cpu")
    for i in range(seq.n_frames):
        slam.track_monocular(seq.frame(i), i / seq.fps)
    slam.shutdown()
    m = slam.map
    assert slam.get_tracking_state() == State.OK
    assert m.kf_valid[: m.n_kf].sum() >= 3 and m.mp_valid[: m.n_mp].sum() > 100
    traj = slam.trajectory_tum()
    assert len(traj) >= 8
    est = np.array([r[1:4] for r in traj])
    gt = np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])
    assert np.linalg.norm(gt[-1] - gt[0]) > 0.3
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    assert rmse < 0.10, rmse
    for j in m.valid_mp_ids():
        for kf, slot in m.mp_obs[int(j)].items():
            assert m.kf_mp[kf, slot] == j and m.kf_valid[kf]
    for k in m.valid_kf_ids():
        for s in np.nonzero(m.kf_mp[k] >= 0)[0]:
            j = int(m.kf_mp[k, s])
            assert m.mp_valid[j] and m.mp_obs[j].get(int(k)) == s
    slam.save_trajectory_tum(str(tmp_path / "traj.txt"))
    rows = np.loadtxt(tmp_path / "traj.txt")
    assert rows.shape[1] == 8
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-6)
