"""The dataset CLI's TUM RGB-D route against tpuslam's, on the CPU.

30 frames of the rendered room seen by TUM3's RGB-D camera at half size
(320x240, fx 267.7, fy 269.6, the projector's 40 / 535.4 m baseline, bf
20.0), 30 fps at 0.5 m/s, are written as a TUM RGB-D recording
(scripts/make_synth_euroc_torch.py `write_tum_rgbd`): colour PNGs, uint16
depth at 5000 per metre, rgb.txt and depth.txt stamped in epoch seconds from
1305031102.175304 with the depth stamps a few ms off, groundtruth.txt at
100 Hz, and the reference's TUM3.yaml text (DepthMapFactor 5000.0, 1000
features). `run.main --dataset tum_rgbd --sensor rgbd --eval` of both
packages (the port with `--device cpu`):

  * Both packages load the recording alike: the same stamps, association,
    ground truth, gray images (the colour PNG's IMREAD_GRAYSCALE, within 3
    gray levels of the render) and raw depth.
  * Lockstep: the same state, frame, keyframe and map counts, map points
    within 5 %, per-frame positions within 1 cm and 0.2 degrees (the
    tolerances of tests/test_torch_cli.py), the same report ATE within 1 mm.
    tpuslam applies DepthMapFactor twice on this route (ROADMAP §3,
    tests/test_torch_depth_map_factor.py), so its side is held to the port's
    repair here: its settings keep 1 / DepthMapFactor and its loader hands
    the depth image over as read (`held_to_the_repair`); tpuslam/ is not
    edited.
  * Against the renderer's truth: the report's unscaled `ate_rmse` under 5
    cm, and the rows' unscaled ATE under 5 cm with a Horn scale within 3 %
    of 1 (PERF.md §2's RGB-D gates); one row per frame, stamped with the
    colour images' epoch seconds.

tpuslam's run is read from its record (tests/torch_records.py, written by
tests/make_tpuslam_records.py).
"""

import contextlib
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
N_FRAMES, SCALE, FEATURES = 30, 0.5, 1000


def write_tree(out):
    """(the sequence, the recording's path, its settings file)."""
    seq = TD.tum_sequence(N_FRAMES, SCALE)
    return seq, out, TD.script().write_tum_rgbd(seq, out, n_features=FEATURES)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("tum_rgbd") / "fr3"))


@contextlib.contextmanager
def held_to_the_repair():
    """tpuslam's CLI with DepthMapFactor applied once, as the port applies
    it: its settings keep 1 / DepthMapFactor, which its tracker multiplies
    the depth image by, and its loader hands the image over as read."""
    import cv2

    from tpuslam.io import settings as j_settings

    mp = pytest.MonkeyPatch()
    load = j_settings.load_settings

    def load_once(path, *a, **kw):
        st = load(path, *a, **kw)
        st.cfg.depth_map_factor = 1.0 / st.cfg.depth_map_factor
        return st

    def depth_as_read(self, i, factor=1.0):
        return cv2.imread(self.depth_paths[i], cv2.IMREAD_UNCHANGED).astype(np.float32)

    mp.setattr(j_settings, "load_settings", load_once)
    mp.setattr(j_datasets.ImageSequence, "depth", depth_as_read)
    try:
        yield
    finally:
        mp.undo()


def _argv(path, settings, out):
    return ["--dataset", "tum_rgbd", "--path", path, "--settings", settings, "--sensor", "rgbd",
            "--eval", "--output", os.path.join(out, "traj.txt"),
            "--kf-output", os.path.join(out, "kf.txt")]


def _rows(out):
    return [np.loadtxt(os.path.join(out, f"{k}.txt"), ndmin=2) for k in ("traj", "kf")]


def _tpuslam_runs(path, settings):
    """tpuslam's run.main on the recording, held to the repair (its record's
    run): (report, trajectory rows, keyframe rows)."""
    with tempfile.TemporaryDirectory() as tmp, held_to_the_repair():
        rep = j_run.main(_argv(path, settings, tmp))
        return tuple([rep] + _rows(tmp))


def record_inputs(tree):
    """Fingerprints of the inputs of tpuslam's recorded run
    (tests/torch_records.py): the frames the recording was written from and
    its settings file."""
    seq, _, settings = tree
    return {"frames": torch_records.sequence_fingerprint(seq, N_FRAMES),
            "settings": torch_records.text_digest(settings)}


@pytest.fixture(scope="module")
def tpuslam_run(tree):
    return torch_records.recorded("tum_rgbd_cli", record_inputs(tree)).result()


@pytest.fixture(scope="module")
def port_run(tree, tmp_path_factory):
    _, path, settings = tree
    out = str(tmp_path_factory.mktemp("tum_rgbd_port"))
    rep = run.main(_argv(path, settings, out) + ["--device", "cpu"])
    return tuple([rep] + _rows(out))


def test_tum_rgbd_recording_loads_alike(tree):
    seq, path, _ = tree
    a, b = datasets.load_tum_rgbd(path), j_datasets.load_tum_rgbd(path)
    assert len(a) == len(b) == N_FRAMES and np.array_equal(a.times, b.times)
    np.testing.assert_allclose(a.times, TD.script().TUM_T0 + seq.timestamps(), atol=1e-6)
    assert a.paths == b.paths and a.depth_paths == b.depth_paths
    assert np.array_equal(a.gt, b.gt)
    for i in (0, N_FRAMES - 1):
        img, depth = seq.frame_rgbd(i)
        assert np.array_equal(a.frame(i), b.frame(i))
        assert np.abs(a.frame(i) - np.clip(img, 0, 255).astype(np.uint8)).max() <= 3
        raw = a.depth(i)
        assert np.array_equal(raw, b.depth(i)) and raw.max() <= 65535
        near = (depth > 0) & (depth * 5000 <= 65535)
        assert np.abs(raw[near] / 5000 - depth[near]).max() <= 0.5 / 5000 + 1e-6


def test_run_main_tum_rgbd_matches_tpuslam(port_run, tpuslam_run):
    got, a, ka = port_run
    want, b, kb = tpuslam_run
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == N_FRAMES and got["maps"] == 1
    assert abs(got["map_points"] - want["map_points"]) <= 0.05 * want["map_points"]
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 1e-3
    assert a.shape == b.shape and ka.shape == kb.shape == (got["keyframes"], 8)
    assert np.array_equal(a[:, 0], b[:, 0]) and np.array_equal(ka[:, 0], kb[:, 0])
    for ra, rb in zip(a, b):
        assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
        assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]


def test_tum_rgbd_gates(tree, port_run):
    seq, path, _ = tree
    rep, rows, _ = port_run
    assert rep["ate_rmse"] < TD.STEREO_ATE, rep
    t0 = TD.script().TUM_T0
    assert rows.shape == (N_FRAMES, 8)
    np.testing.assert_array_equal(rows[:, 0], datasets.load_tum_rgbd(path).times)
    g = TD.tum_rows_gates(rows, seq, t0=t0)
    assert g["ate"] < TD.STEREO_ATE and abs(g["scale"] - 1.0) < TD.STEREO_SCALE, g
    # the report's ATE is the rows' against groundtruth.txt, as --eval associates them
    ate, matched = TD.report_gt_ate(rows, datasets.load_tum_rgbd(path).gt)
    assert matched == N_FRAMES and abs(ate - rep["ate_rmse"]) < 1e-5
