"""The port's dataset CLI against tpuslam's, on the CPU.

  * scripts/make_synth_euroc_torch.py against scripts/make_synth_euroc.py
    (run with JAX on the CPU in x64, as this suite runs tpuslam): the same
    CSVs and YAML text, the same decoded images, ground truth within 1e-9.
  * `run.main` of both packages on one tree written by the port's script
    (376x240, 12 stereo frames, a vocabulary in the reference's text
    format, `--device cpu` for the port): the same state, frame, keyframe
    and map counts, map points within 5 %, per-frame positions within 1 cm
    and 0.2 degrees (the tolerances of tests/test_torch_system.py); the
    keyframe file, and a checkpoint that loads into a fresh System equal to
    the run's map, with tpuslam's npz keys and dtypes.
  * The port alone on the rest of the CLI: identity LEFT./RIGHT.
    rectification, two sessions (`--path D,D`), async mapping + pipelined
    tracking and the KITTI format; the vocabulary's binary and npz forms.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuslam import run as j_run
from tpuslam_torch import run
from tpuslam_torch.engine.system import System
from tpuslam_torch.io.png import read_png
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map import checkpoint
from tpuslam_torch.place import load_orbvoc, save_orbvoc_binary, save_orbvoc_text, store
from tpuslam_torch.place.vocab import train_vocabulary

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_synth_euroc_torch", os.path.join(ROOT, "scripts", "make_synth_euroc_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 12-frame stereo + IMU EuRoC tree written by the port's script, and a
    vocabulary in the reference's text format."""
    out = tmp_path_factory.mktemp("euroc")
    seq = SyntheticSequence(seed=0, n_frames=N_FRAMES, fps=10.0, speed=0.5, baseline=0.1,
                            kind="vi_excite")
    yaml_path = _script().write_euroc(seq, str(out))
    descs = (np.random.RandomState(0).rand(400, 256) > 0.5).astype(np.uint8)
    voc = train_vocabulary(descs, k=4, L=2, iters=3, device="cpu")
    save_orbvoc_text(voc, str(out / "voc.txt"))
    return seq, str(out), yaml_path


def _read_csv(path):
    with open(path) as fh:
        return fh.read()


def test_synth_script_matches_tpuslam(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "ref"
    _script().main([str(ours), "--frames", "5"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "make_synth_euroc.py"),
                          str(ref), "--frames", "5"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert _read_csv(ours / "synth.yaml") == _read_csv(ref / "synth.yaml")
    for f in ("cam0/data.csv", "cam1/data.csv", "imu0/data.csv"):
        assert _read_csv(ours / "mav0" / f) == _read_csv(ref / "mav0" / f), f
    gt = "mav0/state_groundtruth_estimate0/data.csv"
    a, b = (np.loadtxt(d / gt, delimiter=",") for d in (ours, ref))
    assert a.shape == b.shape == (5, 8) and np.abs(a - b).max() <= 1e-9
    import cv2
    for cam in ("cam0", "cam1"):
        names = sorted(os.listdir(ref / "mav0" / cam / "data"))
        assert names == sorted(os.listdir(ours / "mav0" / cam / "data")) and len(names) == 5
        for n in names:
            want = cv2.imread(str(ref / "mav0" / cam / "data" / n), cv2.IMREAD_GRAYSCALE)
            assert np.array_equal(read_png(str(ours / "mav0" / cam / "data" / n)), want), n


def _rot_deg(qa, qb):
    """Angle between two unit quaternions, in degrees."""
    return float(np.degrees(2 * np.arccos(np.clip(abs(np.dot(qa, qb)), -1.0, 1.0))))


def test_run_main_matches_tpuslam(tree, tmp_path, monkeypatch):
    seq, path, yaml_path = tree
    common = ["--dataset", "euroc", "--path", path, "--settings", yaml_path, "--sensor", "stereo",
              "--vocab", os.path.join(path, "voc.txt"), "--eval", "--format", "euroc"]
    systems = []

    class Recorded(System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            systems.append(self)

    monkeypatch.setattr(run, "System", Recorded)
    got = run.main(common + ["--output", str(tmp_path / "port.txt"), "--device", "cpu",
                             "--kf-output", str(tmp_path / "port_kf.txt"),
                             "--checkpoint", str(tmp_path / "port.npz")])
    want = j_run.main(common + ["--output", str(tmp_path / "ref.txt"),
                                "--checkpoint", str(tmp_path / "ref.npz")])
    assert got["state"] == want["state"] == "OK"
    for k in ("frames", "keyframes", "maps"):
        assert got[k] == want[k], k
    assert got["frames"] == N_FRAMES and got["maps"] == 1 and got["keyframes"] >= 2
    assert abs(got["map_points"] - want["map_points"]) <= 0.05 * want["map_points"]
    assert got["ate_rmse"] < 0.05 and abs(got["ate_rmse"] - want["ate_rmse"]) < 0.01
    a, b = np.loadtxt(tmp_path / "port.txt"), np.loadtxt(tmp_path / "ref.txt")
    assert a.shape == b.shape == (N_FRAMES, 8) and np.array_equal(a[:, 0], b[:, 0])
    for ra, rb in zip(a, b):
        assert np.linalg.norm(ra[1:4] - rb[1:4]) < 0.01, ra[0]
        assert _rot_deg(ra[4:8], rb[4:8]) < 0.2, ra[0]
    # the keyframe file and the checkpoint hold the run's map
    slam = systems[0]
    kf = np.loadtxt(tmp_path / "port_kf.txt", ndmin=2)
    assert len(kf) == got["keyframes"] == len(slam.map.valid_kf_ids())
    np.testing.assert_allclose(kf, np.array(slam.keyframe_trajectory_tum()), atol=1e-8)
    zp, zr = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(zp.files) == sorted(zr.files)
    for k in zr.files:
        assert zp[k].dtype == zr[k].dtype, k
    fresh = System(slam.camera, slam.cfg, sensor=slam.sensor, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "port.npz"))
    m, m2 = slam.map, fresh.map
    for name in checkpoint._ARRAY_FIELDS + ("scale_factors",):
        assert np.array_equal(getattr(m2, name), getattr(m, name)), name
    assert m2.mp_obs == m.mp_obs and m2.covis == m.covis
    for f2, f in zip(m2.kf_feats, m.kf_feats):
        assert (f2 is None) == (f is None)
        if f is not None:
            for k in ("xy", "und_xy", "octave", "bits", "packed", "valid", "depth", "u_right"):
                assert np.array_equal(getattr(f2, k), getattr(f, k)), k
    assert fresh.keyframe_trajectory_tum() == slam.keyframe_trajectory_tum()


def test_run_main_rectified_two_sessions_async(tree, tmp_path):
    seq, path, yaml_path = tree
    rect = tmp_path / "rect.yaml"
    with open(yaml_path) as fh:
        rect.write_text(fh.read() + _script().identity_rectification_yaml(seq))
    # the vocabulary's other two forms load to the same tree
    voc = load_orbvoc(os.path.join(path, "voc.txt"))
    save_orbvoc_binary(voc, str(tmp_path / "voc.bin"))
    store.save_vocabulary(voc, str(tmp_path / "voc.npz"))
    for other in (load_orbvoc(str(tmp_path / "voc.bin")),
                  store.load_vocabulary(str(tmp_path / "voc.npz"))):
        for x, y in zip(other.level_descs, voc.level_descs):
            assert np.array_equal(x, y)
        assert np.allclose(other.word_weight, voc.word_weight, rtol=1e-6, atol=1e-7)
    # no vocabulary, so no merge: two maps (with one, the second session is
    # recognised and merged: tests/test_torch_atlas_merge.py)
    out = tmp_path / "kitti.txt"
    rep = run.main(["--dataset", "euroc", "--path", f"{path},{path}", "--settings", str(rect),
                    "--sensor", "stereo", "--max-frames", "6", "--async-mapping", "--pipelined", "--format", "kitti", "--output",
                    str(out), "--device", "cpu"])
    assert rep["frames"] == 12 and rep["maps"] == 2 and rep["state"] == "OK"
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (12, 12) and np.isfinite(rows).all()
    # the identity maps pass the images through
    st = run.load_settings(str(rect))
    rec = st.make_rectifier("cpu")
    img_l, img_r = run.D.load_euroc(path, stereo=True).frame(0), seq.frame(0, right=True)
    out_l, out_r = rec(img_l, img_r)
    assert np.abs(out_l - img_l).max() <= 1e-4 and np.abs(out_r - img_r).max() <= 1e-4
