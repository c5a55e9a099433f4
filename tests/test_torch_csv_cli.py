"""The dataset CLI's CSV route (the Mac fork's own driver format, rows
`timestamp,filename`: src/main.cpp:19-54) against tpuslam's, on the CPU.

25 frames of the rendered room (376x240, fx 200, 10 fps, 0.5 m/s) are
written as seq.csv with nanosecond stamps from EuRoC MH01's first,
1403636579763555584, and the images under data/, with the synthetic EuRoC
settings file (scripts/make_synth_euroc_torch.py `write_csv`, 700
features). `run.main --dataset csv --sensor mono` of both packages (the
port with `--device cpu`, its two-view RANSAC handed tpuslam's own draws):

  * Both loaders read the CSV to the same seconds, np.float64(ns) * 1e-9
    (within 2.4e-7 s, the spacing of f64 at epoch seconds, of the exact ns).
  * Lockstep over the first 14 frames: the same state, frame, keyframe and
    map counts, map points within 5 %, per-frame positions within 1 cm and
    0.2 degrees (the tolerances of tests/test_torch_cli.py). The runs part
    on frame 14's keyframe decision, a borderline one: their inlier counts
    differ by 1-2 from the first tracked frames (f32 rounding in two
    solvers), and against the reference keyframe's well-observed points x
    0.9 the port keeps 178 of 198 x 0.9 = 178.2 (a keyframe) where tpuslam
    keeps 176 of 194 x 0.9 = 174.6 (none).
  * tests/test_e2e_mono.py's gates against the renderer's truth over those
    14 frames: OK, >= 3 keyframes, > 100 map points, scaled ATE under 0.10.
  * The TUM rows carry the CSV's stamps: each row's stamp is its frame's
    loaded seconds exactly (`%.9f` keeps every digit of an epoch f64).

tpuslam's run is read from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tpuslam import run as j_run
from tpuslam.io import datasets as j_datasets
from tpuslam_torch import run
from tpuslam_torch.io import datasets

from test_torch_cli import _rot_deg
import torch_datasets as TD
import torch_records

torch.set_num_threads(2)
# the frames in lockstep: the mono runs part on frame 14's keyframe decision,
# a borderline one (the module's docstring)
N_FRAMES, LOCKSTEP, FEATURES = 25, 14, 700


def write_tree(out):
    """(the sequence, the CSV's path, the settings file)."""
    seq = TD.csv_sequence(N_FRAMES)
    return (seq,) + TD.script().write_csv(seq, out, n_features=FEATURES)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("csv") / "seq"))


def _argv(csv_path, settings, out, n_frames):
    return ["--dataset", "csv", "--path", csv_path, "--settings", settings, "--sensor", "mono",
            "--max-frames", str(n_frames), "--output", os.path.join(out, f"traj{n_frames}.txt"),
            "--kf-output", os.path.join(out, f"kf{n_frames}.txt")]


def _rows(out, n_frames):
    return [np.loadtxt(os.path.join(out, f"{k}{n_frames}.txt"), ndmin=2) for k in ("traj", "kf")]


def _tpuslam_runs(csv_path, settings):
    """tpuslam's run.main on the CSV's first LOCKSTEP frames (its record's
    run): (report, trajectory rows, keyframe rows)."""
    with tempfile.TemporaryDirectory() as tmp:
        rep = j_run.main(_argv(csv_path, settings, tmp, LOCKSTEP))
        return tuple([rep] + _rows(tmp, LOCKSTEP))


def record_inputs(tree):
    """Fingerprints of the inputs of tpuslam's recorded run
    (tests/torch_records.py): the frames, the CSV and the settings file."""
    seq, csv_path, settings = tree
    return {"frames": torch_records.sequence_fingerprint(seq, N_FRAMES),
            "csv": torch_records.text_digest(csv_path),
            "settings": torch_records.text_digest(settings)}


@pytest.fixture(scope="module")
def tpuslam_run(tree):
    return torch_records.recorded("csv_cli", record_inputs(tree)).result()


@pytest.fixture(scope="module")
def port_run(tree, tmp_path_factory):
    """The port's run.main over the lockstep's frames, with tpuslam's
    two-view draws: (report, trajectory rows, keyframe rows)."""
    from tpuslam_torch.ops import twoview
    from test_torch_vi_system import jax_draw

    _, csv_path, settings = tree
    out = str(tmp_path_factory.mktemp("csv_port"))
    mp = pytest.MonkeyPatch()
    mp.setattr(twoview, "draw_samples", jax_draw)
    try:
        rep = run.main(_argv(csv_path, settings, out, LOCKSTEP) + ["--device", "cpu"])
    finally:
        mp.undo()
    return tuple([rep] + _rows(out, LOCKSTEP))


def _ns_stamps(csv_path):
    with open(csv_path) as fh:
        return [int(line.split(",")[0]) for line in fh if not line.startswith("#")]


def test_csv_loads_alike_to_the_ns(tree):
    seq, csv_path, _ = tree
    a = datasets.load_csv_sequence(csv_path, os.path.dirname(csv_path))
    b = j_datasets.load_csv_sequence(csv_path, os.path.dirname(csv_path))
    ns = _ns_stamps(csv_path)
    assert len(a) == len(b) == len(ns) == N_FRAMES and np.array_equal(a.times, b.times)
    assert ns[0] == TD.script().CSV_T0_NS and a.paths == b.paths
    np.testing.assert_array_equal(a.times, np.array(ns, np.float64) * 1e-9)
    assert max(abs(t - n / 1e9) for t, n in zip(a.times, ns)) <= 2.4e-7
    assert np.array_equal(a.frame(N_FRAMES - 1), b.frame(N_FRAMES - 1))


def test_run_main_csv_matches_tpuslam(port_run, tpuslam_run):
    got, a, ka = port_run
    want, b, kb = tpuslam_run
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == LOCKSTEP and got["maps"] == 1
    assert abs(got["map_points"] - want["map_points"]) <= 0.05 * want["map_points"]
    assert a.shape == b.shape and ka.shape == kb.shape == (got["keyframes"], 8)
    assert np.array_equal(a[:, 0], b[:, 0]) and np.array_equal(ka[:, 0], kb[:, 0])
    for ra, rb in zip(a, b):
        assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
        assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]


def test_csv_mono_gates_and_stamps(tree, port_run):
    seq, csv_path, _ = tree
    rep, rows, kf = port_run
    assert rep["frames"] == LOCKSTEP and rep["state"] == "OK" and rep["keyframes"] >= TD.MONO_KFS
    assert rep["map_points"] > TD.MONO_POINTS
    t0 = TD.script().CSV_T0_NS * 1e-9
    g = TD.tum_rows_gates(rows, seq, t0=t0, with_scale=True)
    assert g["rows"] >= 8 and g["ate"] < TD.MONO_ATE, g
    times = datasets.load_csv_sequence(csv_path, os.path.dirname(csv_path)).times
    assert np.isin(rows[:, 0], times).all() and np.isin(kf[:, 0], times).all()
    # the rows after the two-view init are the frames from it on, in order
    first = int(np.nonzero(times == rows[0, 0])[0][0])
    np.testing.assert_array_equal(rows[:, 0], times[first:first + len(rows)])
