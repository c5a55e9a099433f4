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

from test_torch_cli import ROOT
from test_torch_tum_vi_cli import N_FRAMES, tree  # noqa: F401


def test_tum_vi_examples_runner_on_the_cpu(tree, tmp_path):
    seq, path, yaml_path = tree
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
    assert sorted(reports) == ["mono", "mono_imu", "stereo", "stereo_imu"], res.stdout[-3000:]
    for sensor, rep in reports.items():
        assert rep["state"] == "OK" and rep["frames"] == N_FRAMES, (sensor, rep)
        for kind in ("f", "kf"):
            rows = np.loadtxt(tmp_path / f"{kind}_room1_{sensor}.txt", ndmin=2)
            assert len(rows) >= 2 and rows.shape[1] == 8, (sensor, kind)
