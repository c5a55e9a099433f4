"""The dataset CLI's stereo-inertial route against tpuslam's, on the CPU.

The first 12 frames of the heave sequence (tests/torch_vi_heave.py) are
written as a stereo + IMU EuRoC tree by scripts/make_synth_euroc_torch.py's
`write_euroc`, and `run.main` of both packages runs it with
`--sensor stereo_imu` (the port with `--device cpu`): the stereo init on
the IMU gate, then the host path of the inertial tracker (12 frames end
before the IMU init). Both report OK with the same frame and keyframe
counts, and their trajectory files agree row by row within 1 cm and 0.2
degrees (the tolerances of tests/test_torch_system.py).
"""

import numpy as np

from tpuslam import run as j_run
from tpuslam_torch import run

from test_torch_cli import _rot_deg, _script
from torch_vi_heave import heave_sequence

N_FRAMES = 12


def test_run_main_stereo_imu_matches_tpuslam(tmp_path):
    seq = heave_sequence(n_frames=N_FRAMES, fps=10.0, speed=0.5, baseline=0.1)
    yaml_path = _script().write_euroc(seq, str(tmp_path / "euroc"))
    common = ["--dataset", "euroc", "--path", str(tmp_path / "euroc"), "--settings", yaml_path,
              "--sensor", "stereo_imu", "--eval"]
    got = run.main(common + ["--output", str(tmp_path / "port.txt"), "--device", "cpu"])
    want = j_run.main(common + ["--output", str(tmp_path / "ref.txt")])
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == N_FRAMES and got["keyframes"] >= 2
    assert got["ate_rmse"] < 0.05
    a, b = np.loadtxt(tmp_path / "port.txt"), np.loadtxt(tmp_path / "ref.txt")
    # the stereo-inertial init waits for the gate: no pose before frame 2
    assert a.shape == b.shape and 8 <= len(a) <= N_FRAMES - 2
    assert np.array_equal(a[:, 0], b[:, 0])
    for ra, rb in zip(a, b):
        assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
        assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]
