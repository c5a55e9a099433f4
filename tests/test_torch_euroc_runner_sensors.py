"""scripts/euroc_examples_torch.sh, the port's EuRoC matrix runner, over its
other three sensors on the CPU (DEVICE=cpu); tests/test_torch_euroc_runner.py
runs its stereo matrix and multi-session line.

EUROC_ROOT holds one tree, MH01: 16 frames of the heave sequence
(tests/torch_vi_heave.py: vi_excite plus a 0.10 m heave, which passes the
stereo-inertial init's acceleration gate; 376x240, 10 fps, 0.5 m/s, IMU at
200 Hz) written by scripts/make_synth_euroc_torch.py with 700 features. The
runner runs SEQS=MH01 with SENSORS="mono mono_imu stereo_imu": each sensor's
report prints with the tree's frame count, one map and the state OK, and
each writes its trajectory and keyframe files in the TUM format. Without MH05 the multi-session line does not run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import ROOT, _script
from torch_vi_heave import heave_sequence

N_FRAMES = 16
SENSORS = ("mono", "mono_imu", "stereo_imu")


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    """The runner over MH01 for the three sensors: its reports by sensor and
    its output directory."""
    tmp_path = tmp_path_factory.mktemp("euroc_sensors")
    seq = heave_sequence(n_frames=N_FRAMES, fps=10.0, speed=0.5, imu_rate=200.0, baseline=0.1)
    yaml_path = _script().write_euroc(seq, str(tmp_path / "euroc" / "MH01"), n_features=700)
    out = tmp_path / "out"
    env = dict(os.environ, EUROC_ROOT=str(tmp_path / "euroc"), SEQS="MH01",
               SENSORS=" ".join(SENSORS), OUT_DIR=str(out), DEVICE="cpu", OMP_NUM_THREADS="2",
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
    res = subprocess.run(["bash", os.path.join(ROOT, "scripts", "euroc_examples_torch.sh"),
                          yaml_path], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    reports, run_of = {}, None
    for line in res.stdout.splitlines():
        if line.startswith("==="):
            run_of = line.split()[2]
        elif line.startswith("{"):
            reports[run_of] = json.loads(line)
    return reports, out, res.stdout


def test_every_sensor_reports(runner):
    reports, _, stdout = runner
    assert sorted(reports) == sorted(SENSORS), stdout[-3000:]
    assert "multi-session" not in stdout


@pytest.mark.parametrize("sensor", SENSORS)
def test_each_sensor_runs_and_writes_its_files(runner, sensor):
    reports, out, _ = runner
    rep = reports[sensor]
    assert rep["frames"] == N_FRAMES and rep["maps"] == 1, rep
    assert rep["state"] == "OK" and rep["keyframes"] >= 2, rep
    for kind in ("f", "kf"):
        rows = np.loadtxt(out / f"{kind}_MH01_{sensor}.txt", ndmin=2)
        assert len(rows) >= 2 and rows.shape[1] == 8 and np.isfinite(rows).all(), kind
        np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-6)
