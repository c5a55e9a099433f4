"""scripts/euroc_examples_torch.sh, the port's EuRoC matrix runner, on the
CPU (DEVICE=cpu).

EUROC_ROOT holds five short trees written by scripts/make_synth_euroc_torch.py,
MH01 ... MH05 as sessions of one rendered room (376x240, 700 features, 10
fps): session k is frames 3k .. 3k + 7, stamped from 100 k s. The runner
runs its matrix with SENSORS=stereo and a vocabulary (VOCAB, in the
reference's text format), then its multi-session MH01->MH05 line. Every
per-sequence report reads OK with the tree's frame count and writes its
trajectory and keyframe files; the multi-session line runs to its report,
with the frame count the sum of the five sessions'.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.place import save_orbvoc_text, train_vocabulary

from test_torch_cli import ROOT, _script

N_SESSIONS, N_FRAMES, STRIDE = 5, 8, 3
SEQS = [f"MH0{k + 1}" for k in range(N_SESSIONS)]


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    """The runner over the written trees: its reports by run and its
    output directory."""
    tmp_path = tmp_path_factory.mktemp("euroc_runner")
    script = _script()
    room = SyntheticSequence(seed=0, n_frames=STRIDE * (N_SESSIONS - 1) + N_FRAMES, fps=10.0,
                             speed=0.5, baseline=0.1)
    images = [tuple(np.clip(room.frame(i, right=r), 0, 255).astype(np.uint8)
                    for r in (False, True)) for i in range(room.n_frames)]
    root = tmp_path / "euroc"
    for k, name in enumerate(SEQS):
        start = STRIDE * k
        yaml_path = script.write_euroc(
            script.SessionView(room, start, N_FRAMES, 100.0 * k), str(root / name),
            n_features=700, images=images[start:start + N_FRAMES])
    descs = (np.random.RandomState(0).rand(400, 256) > 0.5).astype(np.uint8)
    save_orbvoc_text(train_vocabulary(descs, k=4, L=2, iters=3, device="cpu"),
                     str(tmp_path / "voc.txt"))
    out = tmp_path / "out"
    env = dict(os.environ, EUROC_ROOT=str(root), SENSORS="stereo", OUT_DIR=str(out),
               VOCAB=str(tmp_path / "voc.txt"), DEVICE="cpu", OMP_NUM_THREADS="2",
               PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ["PATH"])
    res = subprocess.run(["bash", os.path.join(ROOT, "scripts", "euroc_examples_torch.sh"),
                          yaml_path], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    reports, run_of = {}, None
    for line in res.stdout.splitlines():
        if line.startswith("==="):
            run_of = line.split()[1]
        elif line.startswith("{"):
            reports[run_of] = json.loads(line)
    return reports, out, res.stdout


def test_euroc_examples_runner_on_the_cpu(runner):
    reports, _, stdout = runner
    assert sorted(reports) == SEQS + ["multi-session"], stdout[-3000:]


def test_each_sequence_ends_ok_with_its_trajectory_files(runner):
    reports, out, _ = runner
    for name in SEQS:
        rep = reports[name]
        assert rep["state"] == "OK" and rep["frames"] == N_FRAMES, (name, rep)
        for kind in ("f", "kf"):
            rows = np.loadtxt(out / f"{kind}_{name}_stereo.txt", ndmin=2)
            assert len(rows) >= 2 and rows.shape[1] == 8, (name, kind)


def test_the_multi_session_line_runs_every_session(runner):
    reports, out, _ = runner
    assert reports["multi-session"]["frames"] == N_SESSIONS * N_FRAMES
    assert (out / "f_MH01_05_multi.txt").exists()
