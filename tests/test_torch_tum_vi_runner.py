"""The port's TUM-VI runner script on the CPU, over the tree of
tests/test_torch_tum_vi_cli.py (in a file of its own so that it runs beside
that file's `run.main` cases).

scripts/tum_vi_examples_torch.sh with DEVICE=cpu over the tree, with all
four sensors: every report line is OK, and every run writes its trajectory
and keyframe files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import ROOT
from test_torch_tum_vi_cli import N_FRAMES, tree  # noqa: F401


@pytest.fixture(scope="module")
def runner(tree, tmp_path_factory):
    """The runner over the written tree: its reports by sensor and its
    output directory."""
    seq, path, yaml_path = tree
    tmp_path = tmp_path_factory.mktemp("tum_vi_runner")
    env = dict(os.environ, TUMVI_ROOT=os.path.dirname(path), SEQS=os.path.basename(path),
               OUT_DIR=str(tmp_path), DEVICE="cpu", OMP_NUM_THREADS="2",
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
    res = subprocess.run(["bash", os.path.join(ROOT, "scripts", "tum_vi_examples_torch.sh"),
                          yaml_path], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    reports = {}
    sensor = None
    for line in res.stdout.splitlines():
        if line.startswith("==="):
            sensor = line.split()[2]
        elif line.startswith("{"):
            reports[sensor] = json.loads(line)
    return reports, tmp_path, res.stdout


def test_tum_vi_examples_runner_on_the_cpu(runner):
    reports, _, stdout = runner
    assert sorted(reports) == ["mono", "mono_imu", "stereo", "stereo_imu"], stdout[-3000:]


def test_every_sensor_ends_ok(runner):
    reports, _, _ = runner
    for sensor, rep in reports.items():
        assert rep["state"] == "OK" and rep["frames"] == N_FRAMES, (sensor, rep)


def test_every_sensor_writes_its_trajectory_files(runner):
    reports, out, _ = runner
    for sensor in reports:
        for kind in ("f", "kf"):
            rows = np.loadtxt(out / f"{kind}_room1_{sensor}.txt", ndmin=2)
            assert len(rows) >= 2 and rows.shape[1] == 8, (sensor, kind)
