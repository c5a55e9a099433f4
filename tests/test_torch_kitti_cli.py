"""The dataset CLI's KITTI routes against tpuslam's, on the CPU.

30 frames of the rendered room seen by KITTI00-02's stereo camera at half
size (620x188, fx = fy = 359.428, the published 0.537 m baseline, bf
193.0724), 10 fps, are written as a KITTI odometry sequence (times.txt
stamped from 0, image_0/ and image_1/ PNGs) with the reference's
KITTI00-02.yaml text for both sensors (scripts/make_synth_euroc_torch.py
`write_kitti`, 1000 features), and run through `run.main --dataset kitti`
of both packages (the port with `--device cpu`):

  * `--sensor stereo --format kitti` (no rectifier: the file has no LEFT.K)
    over the 30 frames and `--sensor mono` (the port's two-view RANSAC
    handed tpuslam's own draws) over the first 15: the same state, frame,
    keyframe and map counts, map points within 5 %, and per-frame positions
    within 1 cm and 0.2 degrees (the tolerances of tests/test_torch_cli.py).
    The mono runs part on frame 15's keyframe decision, a borderline one:
    their inlier counts differ by 1-3 from frame 9 on (f32 rounding in two
    solvers), and against the reference keyframe's well-observed points x
    0.9 the port keeps 187 of 209 x 0.9 = 188.1 (a keyframe) where tpuslam
    keeps 190 of 210 x 0.9 = 189 (none).
  * Against the renderer's truth: the stereo route from the KITTI file, one
    12-value row per frame, unscaled ATE under 5 cm and a Horn scale within
    3 % of 1; the mono route over its 15 frames tests/test_e2e_mono.py's
    gates (OK, >= 3 keyframes, > 100 map points, scaled ATE under 0.10).
  * A KITTI file without Camera.width / Camera.height: the port's settings
    take the image's size (tpuslam's quietly give EuRoC's 752x480).

The tree runs at tests/test_e2e_mono.py's 0.5 m/s (chip_smoke.py phase 18 runs 1 m/s at the
published size). tpuslam's runs are read from their record
(tests/torch_records.py, written by tests/make_tpuslam_records.py).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from tpuslam import run as j_run
from tpuslam.io.settings import load_settings as j_load_settings
from tpuslam_torch import run
from tpuslam_torch.io.settings import load_settings

from test_torch_cli import _rot_deg
import torch_datasets as TD
import torch_records

torch.set_num_threads(2)
N_FRAMES, SCALE, SPEED, FEATURES = 30, 0.5, 0.5, 1000
# frames in lockstep by sensor: the mono runs part on frame 15's keyframe
# decision, a borderline one (the module's docstring)
LOCKSTEP = {"stereo": N_FRAMES, "mono": 15}
SENSORS = tuple(LOCKSTEP)


def write_tree(out):
    """(the sequence, the tree's path, {sensor: its settings file})."""
    seq = TD.kitti_sequence(N_FRAMES, SCALE, SPEED)
    stereo, mono = TD.script().write_kitti(seq, out, n_features=FEATURES)
    return seq, out, {"stereo": stereo, "mono": mono}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("kitti") / "00"))


def _argv(path, settings, sensor, out, n_frames):
    fmt = "kitti" if sensor == "stereo" else "tum"
    return ["--dataset", "kitti", "--path", path, "--settings", settings, "--sensor", sensor,
            "--format", fmt, "--max-frames", str(n_frames),
            "--output", os.path.join(out, f"{sensor}.txt"),
            "--kf-output", os.path.join(out, f"{sensor}_kf.txt")]


def _rows(out, sensor):
    return [np.loadtxt(os.path.join(out, f"{sensor}{k}.txt"), ndmin=2) for k in ("", "_kf")]


def _tpuslam_runs(path, settings):
    """tpuslam's run.main on the tree for each sensor (its record's runs):
    {sensor: (report, trajectory rows, keyframe rows)}."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sensor in SENSORS:
            rep = j_run.main(_argv(path, settings[sensor], sensor, tmp, LOCKSTEP[sensor]))
            out[sensor] = tuple([rep] + _rows(tmp, sensor))
    return out


def record_inputs(tree):
    """Fingerprints of the inputs of tpuslam's recorded runs
    (tests/torch_records.py): the frames the tree was written from and its
    two settings files."""
    seq, _, settings = tree
    return {"frames": torch_records.sequence_fingerprint(seq, N_FRAMES, right=True),
            **{f"settings_{k}": torch_records.text_digest(v) for k, v in settings.items()}}


@pytest.fixture(scope="module")
def tpuslam_runs(tree):
    return torch_records.recorded("kitti_cli", record_inputs(tree)).result()


@pytest.fixture(scope="module")
def port_runs(tree, tmp_path_factory):
    """The port's run.main for each sensor over the lockstep's frames, with
    tpuslam's two-view draws: {sensor: (report, trajectory rows, keyframe
    rows)}."""
    from tpuslam_torch.ops import twoview
    from test_torch_vi_system import jax_draw

    seq, path, settings = tree
    out = str(tmp_path_factory.mktemp("kitti_port"))
    mp = pytest.MonkeyPatch()
    mp.setattr(twoview, "draw_samples", jax_draw)
    try:
        runs = {}
        for sensor in SENSORS:
            rep = run.main(_argv(path, settings[sensor], sensor, out, LOCKSTEP[sensor])
                           + ["--device", "cpu"])
            runs[sensor] = tuple([rep] + _rows(out, sensor))
    finally:
        mp.undo()
    return runs


def test_kitti_settings_load_alike(tree):
    seq, _, settings = tree
    for sensor, path in settings.items():
        got, want = load_settings(path), j_load_settings(path)
        assert np.array_equal(np.asarray(got.camera.params), np.asarray(want.camera.params))
        assert (got.camera.width, got.camera.height) == (want.camera.width, want.camera.height) \
            == (seq.width, seq.height) == (620, 188)
        assert got.bf == want.bf == (pytest.approx(seq.fx * seq.baseline) if sensor == "stereo"
                                     else 0.0)
        assert got.cfg.orb.n_features == want.cfg.orb.n_features == FEATURES
        assert got.cfg.th_depth == want.cfg.th_depth
        assert got.cfg.tracking.max_frames_between_kf == 10
        assert got.rectification is None and want.rectification is None


@pytest.mark.parametrize("sensor", SENSORS)
def test_run_main_kitti_matches_tpuslam(port_runs, tpuslam_runs, sensor):
    got, a, ka = port_runs[sensor]
    want, b, kb = tpuslam_runs[sensor]
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == LOCKSTEP[sensor] and got["maps"] == 1
    assert abs(got["map_points"] - want["map_points"]) <= 0.05 * want["map_points"]
    assert a.shape == b.shape and ka.shape == kb.shape == (got["keyframes"], 8)
    if sensor == "stereo":
        for ra, rb in zip(a.reshape(-1, 3, 4), b.reshape(-1, 3, 4)):
            assert np.linalg.norm(ra[:, 3] - rb[:, 3]) < 0.01
            cos = (np.trace(ra[:, :3].T @ rb[:, :3]) - 1.0) / 2.0
            assert np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) < 0.2
    else:
        assert np.array_equal(a[:, 0], b[:, 0])
        for ra, rb in zip(a, b):
            assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
            assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]


def test_kitti_stereo_gates_from_its_rows(tree, port_runs):
    seq = tree[0]
    rep, rows, kf = port_runs["stereo"]
    assert rows.shape == (N_FRAMES, 12) and np.isfinite(rows).all()
    g = TD.kitti_rows_gates(rows, seq)
    assert g["ate"] < TD.STEREO_ATE and abs(g["scale"] - 1.0) < TD.STEREO_SCALE, g
    # the keyframe file: TUM rows stamped with times.txt's seconds
    assert kf[0, 0] == 0.0 and np.isin(np.round(kf[:, 0], 6), np.round(seq.timestamps(), 6)).all()


def test_kitti_mono_gates(tree, port_runs):
    seq = tree[0]
    rep, rows, _ = port_runs["mono"]
    assert rep["frames"] == LOCKSTEP["mono"] and rep["state"] == "OK" and rep["keyframes"] >= TD.MONO_KFS
    assert rep["map_points"] > TD.MONO_POINTS
    g = TD.tum_rows_gates(rows, seq, with_scale=True)
    assert g["rows"] >= 8 and g["ate"] < TD.MONO_ATE, g


def test_a_kitti_file_without_its_image_size(tree, tmp_path, monkeypatch):
    seq, path, settings = tree
    with open(settings["stereo"]) as fh:
        text = "".join(ln for ln in fh if not ln.startswith(("Camera.width", "Camera.height")))
    bare = tmp_path / "KITTI_no_size.yaml"
    bare.write_text(text)
    assert j_load_settings(str(bare)).camera.width == 752      # tpuslam's quiet default
    with pytest.raises(ValueError, match="Camera.width"):
        load_settings(str(bare))
    assert load_settings(str(bare), 620, 188).camera.width == 620
    systems = []

    class Recorded(run.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            systems.append(self)

    monkeypatch.setattr(run, "System", Recorded)
    rep = run.main(["--dataset", "kitti", "--path", path, "--settings", str(bare), "--sensor",
                    "stereo", "--max-frames", "2", "--output", str(tmp_path / "t.txt"),
                    "--device", "cpu"])
    assert rep["state"] == "OK"
    assert (systems[0].camera.width, systems[0].camera.height) == (seq.width, seq.height)
