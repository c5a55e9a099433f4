"""The dataset CLI's TUM-VI routes against tpuslam's, on the CPU.

12 frames of the heave sequence (tests/torch_vi_heave.py) seen by the KB8
pair of tests/torch_fisheye_rig.py at 320x320 (baseline 0.2 m; at 256x256
the extractor keeps fewer than the 500 features a stereo init needs under
the settings file's defaults) are written as a TUM-VI tree by
scripts/make_synth_euroc_torch.py's `write_tum_vi`: EuRoC's mav0 layout and
a KB8 settings file with TUM_512.yaml's keys (700 features).

  * The settings file loads in both packages to the same KB8 pair, Tlr, bf,
    IMU calibration and Tbc, and the tree to the same sequence.
  * `run.main --dataset tum_vi --eval` of both packages (the port with
    `--device cpu`), `--sensor stereo_imu` (the stereo init on the IMU gate,
    then the inertial tracker's host path: 12 frames end before the IMU
    init) and `--sensor mono` (the two-view init on KB8 rays from tpuslam's
    own RANSAC draws): both report OK with the same frame, keyframe and map
    counts, and their trajectory files agree row by row within 1 cm and 0.2
    degrees (the tolerances of tests/test_torch_system.py). tpuslam's two
    runs are read from their record (tests/torch_records.py, written by
    tests/make_tpuslam_records.py).
  * The runner script: tests/test_torch_tum_vi_runner.py.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tpuslam import run as j_run
from tpuslam.io import datasets as j_datasets
from tpuslam.io.settings import load_settings as j_load_settings
from tpuslam_torch import run
from tpuslam_torch.io import datasets
from tpuslam_torch.io.settings import load_settings

from test_torch_cli import _rot_deg, _script
from test_torch_vi_system import jax_init_draw  # noqa: F401
from torch_fisheye_rig import BASELINE, kb8_rig
from torch_vi_heave import heave_sequence
import torch_records

torch.set_num_threads(2)
N_FRAMES, SIZE = 12, 320


def write_tree(out):
    """Write the TUM-VI tree to out: (sequence, its path, the settings file)."""
    cam, cam2, Trl = kb8_rig(SIZE)
    seq = heave_sequence(n_frames=N_FRAMES, fps=10.0, speed=0.5, camera=cam, camera2=cam2,
                         Trl=Trl)
    yaml_path = _script().write_tum_vi(seq, out, n_features=700)
    return seq, out, yaml_path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("tum_vi") / "room1"))


def test_tum_vi_tree_loads_in_both_packages(tree):
    seq, path, yaml_path = tree
    got, want = load_settings(yaml_path), j_load_settings(yaml_path)
    for a, b in ((got.camera, want.camera), (got.camera2, want.camera2)):
        assert a.kind == "kb8" and type(b).__name__ == "KannalaBrandt8"
        assert a.full_params == tuple(float(v) for v in b.full_params)
        assert a.lapping == b.lapping == (0, SIZE - 1)
    cam = kb8_rig(SIZE)[0]
    assert got.camera.full_params == cam.full_params
    assert got.bf == want.bf == pytest.approx(cam.fx * BASELINE)
    np.testing.assert_array_equal(got.Tlr, want.Tlr)
    np.testing.assert_allclose(got.Tlr, np.linalg.inv(seq.Trl), atol=1e-12)
    np.testing.assert_array_equal(got.Tbc, np.eye(4))
    np.testing.assert_array_equal(want.Tbc, np.eye(4))
    for k in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "freq"):
        assert getattr(got.imu_calib, k) == getattr(want.imu_calib, k), k
    assert got.cfg.orb.n_features == want.cfg.orb.n_features == 700
    assert got.cfg.tracking.max_frames_between_kf == 10
    a = datasets.load_tum_vi(path, stereo=True, with_imu=True)
    b = j_datasets.load_tum_vi(path, stereo=True, with_imu=True)
    assert len(a) == len(b) == N_FRAMES and np.array_equal(a.times, b.times)
    assert np.array_equal(a.imu, b.imu) and np.array_equal(a.gt, b.gt)
    np.testing.assert_array_equal(a.frame(3), np.clip(seq.frame(3), 0, 255).astype(np.uint8))
    np.testing.assert_array_equal(a.frame_right(3), b.frame_right(3))


SENSORS = ["stereo_imu", "mono"]


def _tpuslam_runs(path, yaml_path):
    """tpuslam's run.main on the tree for each sensor (its record's runs):
    {sensor: (report, trajectory rows)}."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sensor in SENSORS:
            traj = os.path.join(tmp, f"ref_{sensor}.txt")
            rep = j_run.main(["--dataset", "tum_vi", "--path", path, "--settings", yaml_path,
                              "--sensor", sensor, "--eval", "--output", traj])
            out[sensor] = (rep, np.loadtxt(traj))
    return out


def record_inputs(tree):
    """Fingerprints of the inputs of tpuslam's recorded runs
    (tests/torch_records.py): the sequence the tree was written from and its
    settings file."""
    seq, _, yaml_path = tree
    return {"frames": torch_records.sequence_fingerprint(seq, N_FRAMES, right=True),
            "settings": torch_records.text_digest(yaml_path)}


@pytest.fixture(scope="module")
def tpuslam_runs(tree):
    """tpuslam's runs, from their record (tests/torch_records.py)."""
    return torch_records.recorded("tum_vi_cli", record_inputs(tree))


@pytest.mark.parametrize("sensor", SENSORS)
def test_run_main_tum_vi_matches_tpuslam(tree, tpuslam_runs, tmp_path, sensor, jax_init_draw):
    seq, path, yaml_path = tree
    common = ["--dataset", "tum_vi", "--path", path, "--settings", yaml_path, "--sensor", sensor,
              "--eval"]
    got = run.main(common + ["--output", str(tmp_path / "port.txt"), "--device", "cpu"])
    want, b = tpuslam_runs.result()[sensor]
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == N_FRAMES and got["keyframes"] >= 2 and got["maps"] == 1
    a = np.loadtxt(tmp_path / "port.txt")
    assert a.shape == b.shape and len(a) >= N_FRAMES - 5
    assert np.array_equal(a[:, 0], b[:, 0])
    for ra, rb in zip(a, b):
        assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
        assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]
    if sensor == "stereo_imu":
        assert got["ate_rmse"] < 0.08
