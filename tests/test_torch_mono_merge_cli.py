"""`run.main --sensor mono --path A,B --vocab` of the port on the CPU: the two
monocular sessions of tests/torch_mono_merge.py written as EuRoC trees
(scripts/make_synth_euroc_torch.write_euroc; the settings make a keyframe
at least every Camera.fps = 10 frames), the vocabulary in the reference's
text format. One map, OK, the summed frame count, both sessions' rows in
the trajectory file, and tests/test_torch_mono_merge.py's joint gates on
them: one Sim3 alignment of both sessions' rows with a scaled ATE under
0.10, and the two sessions' Horn scales within 5 % of each other.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch import run

from torch_mono_merge import (ATE_GATE, N_A, N_B, N_FEATURES, SCALE_AGREE, _script, room,
                              session_gates, vocabulary)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """run.main on the two written trees: its report, the trajectory file's
    rows and the joint gates on them."""
    tmp_path = tmp_path_factory.mktemp("mono_cli")
    seq, frames, sessions = room()
    voc = vocabulary(seq, frames, str(tmp_path / "voc.txt"))
    script = _script()
    paths = []
    for name, sess in zip(("MH01", "MH02"), sessions):
        images = [np.clip(frames[sess.start + i], 0, 255).astype(np.uint8)
                  for i in range(sess.n_frames)]
        yaml_path = script.write_euroc(sess, str(tmp_path / name), n_features=N_FEATURES,
                                       images=[(im, im) for im in images])
        paths.append(str(tmp_path / name))
    out = tmp_path / "traj.txt"
    rep = run.main(["--dataset", "euroc", "--path", ",".join(paths), "--settings", yaml_path,
                    "--sensor", "mono", "--vocab", voc, "--output", str(out),
                    "--device", "cpu"])
    traj = np.loadtxt(out, ndmin=2)
    gates = session_gates(sessions, traj)
    print(f"run.main --sensor mono --path A,B: {rep}; {gates}")
    return rep, traj, gates


def test_run_main_merges_the_second_mono_session(cli_run):
    rep, _, _ = cli_run
    assert rep["maps"] == 1 and rep["state"] == "OK" and rep["frames"] == N_A + N_B, rep


def test_the_trajectory_file_holds_both_sessions(cli_run):
    _, traj, gates = cli_run
    assert all(n >= 8 for n in gates["rows"]) and len(traj) == sum(gates["rows"])
    assert np.isfinite(traj).all()


def test_one_scale_for_both_sessions(cli_run):
    _, _, gates = cli_run
    assert gates["ate"] < ATE_GATE
    sa, sb = gates["scales"]
    assert abs(sb / sa - 1.0) < SCALE_AGREE, gates
