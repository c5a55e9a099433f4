"""`run.main --path A,B --vocab --async-mapping --pipelined` of the port on
the CPU: two stereo sessions merged into one Atlas map with the mapper on
its own thread, with real concurrency.

tests/test_torch_atlas_merge.py's room, sessions and vocabulary written as
two EuRoC trees, as that file's `run.main` test writes them, and run with
bench.py's configuration (async mapping, pipelined tracking; the default
background GBA). Only the state after the run is asserted: one merge, of a
keyframe of the second session, one map, OK, every frame in the trajectory
file, no worker error, and a joint unscaled ATE of both sessions' rows
under 5 cm (PERF.md §2's stereo gate). The same route serialized and held
against tpuslam is tests/test_torch_async_merge.py.
"""

import numpy as np
import torch

from tpuslam_torch import run
from tpuslam_torch.engine import loop_closing

from test_torch_atlas_merge import ATE_GATE, N_A, N_B, N_FEATURES, _joint_ate
from test_torch_atlas_merge import room  # noqa: F401  (the fixture)
from test_torch_cli import _script

torch.set_num_threads(2)


def test_run_main_merges_with_the_mapper_on_its_own_thread(room, tmp_path, monkeypatch):
    seq, frames, sessions, voc = room
    script = _script()
    paths = []
    for name, sess in zip(("MH01", "MH02"), sessions):
        images = [tuple(np.clip(x, 0, 255).astype(np.uint8) for x in frames[sess.start + i])
                  for i in range(sess.n_frames)]
        yaml_path = script.write_euroc(sess, str(tmp_path / name), n_features=N_FEATURES,
                                       images=images)
        paths.append(str(tmp_path / name))
    systems, merges = [], []

    class Recorded(run.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            systems.append(self)

    real_correct = loop_closing.LoopCloser._correct_loop

    def correct(closer, kf, cand, *a, merge=False, **kw):
        if merge:
            merges.append(int(closer.map.kf_frame_id[kf]))
        return real_correct(closer, kf, cand, *a, merge=merge, **kw)

    monkeypatch.setattr(run, "System", Recorded)
    monkeypatch.setattr(loop_closing.LoopCloser, "_correct_loop", correct)
    out = tmp_path / "traj.txt"
    rep = run.main(["--dataset", "euroc", "--path", ",".join(paths), "--settings", yaml_path,
                    "--sensor", "stereo", "--vocab", voc, "--output", str(out),
                    "--async-mapping", "--pipelined", "--device", "cpu"])
    slam, = systems
    assert rep["maps"] == 1 and rep["state"] == "OK" and rep["frames"] == N_A + N_B, rep
    assert slam.async_mapper.errors == [] and not slam.async_mapper.worker.is_alive()
    assert len(merges) == 1 and merges[0] >= N_A, merges
    assert slam.loop_closer.n_loops_closed == 1
    traj = np.loadtxt(out, ndmin=2)
    assert len(traj) == N_A + N_B
    assert _joint_ate(sessions, traj) < ATE_GATE
