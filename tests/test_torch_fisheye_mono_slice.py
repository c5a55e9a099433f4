"""The port's monocular fisheye System against tpuslam's, on the CPU
(TUM-VI's `--sensor mono` route; the mono-inertial cases of
tests/test_torch_fisheye_mono.py, in a file of their own so that they run
beside that file's long lockstep).

A System on the left KB8 camera of tests/torch_fisheye_rig.py (256x256,
700 features, a keyframe at least every 3 frames), the renderer's
forward_arc, 13 frames, the host path in both packages, the port's
two-view RANSAC on tpuslam's own draws, f64: on every frame the same
tracking state, keyframe count and poses within 1 cm and 0.2 degrees
(tests/test_torch_mono.py's tolerances; the map's scale is the initial
median depth of 1), the two-view init by frame 4.
"""

import numpy as np
import torch

from tpuslam_torch.engine.tracking import State
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.ops import twoview

from test_torch_fisheye_mono import N_MONO, _systems
from test_torch_vi_system import _rot_deg, jax_draw

torch.set_num_threads(2)


def test_slice_matches_tpuslam_fisheye_mono_system(monkeypatch):
    monkeypatch.setattr(twoview, "draw_samples", jax_draw)
    cam, js, ts = _systems("MONOCULAR")
    seq = SyntheticSequence(n_frames=N_MONO, fps=10, speed=0.5, camera=cam)
    ok_at = {}
    for i in range(N_MONO):
        img = seq.frame(i)
        Tj = js.track_monocular(img, i / seq.fps)
        Tt = ts.track_monocular(img, i / seq.fps)
        assert ts.get_tracking_state().name == js.get_tracking_state().name, i
        assert len(ts.map.valid_kf_ids()) == len(js.map.valid_kf_ids()), i
        assert (Tt is None) == (Tj is None), i
        if Tj is not None:
            ok_at.setdefault("init", i)
            assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) < 0.01, i
            assert _rot_deg(Tt[:3, :3], Tj[:3, :3]) < 0.2, i
    assert ts.tracker.camspec.kind == "kb8" and ts.tracker.camera2 is None
    assert ok_at["init"] <= 4, ok_at
    assert ts.get_tracking_state() == State.OK and len(ts.map.valid_kf_ids()) >= 4
    for a, b in zip(ts.trajectory_tum(), js.trajectory_tum()):
        np.testing.assert_allclose(a, b, atol=0.01)
