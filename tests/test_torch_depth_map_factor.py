"""DepthMapFactor on the dataset CLI's RGB-D route, and the published
KITTI and TUM settings files, in tpuslam and the port.

A TUM RGB-D settings file gives DepthMapFactor, the raw depth units per
metre (5000 for TUM's uint16 PNGs). ORB-SLAM3 applies it once: Tracking
keeps mDepthMapFactor = 1 / DepthMapFactor and GrabImageRGBD scales the raw
image by it. tpuslam applies it twice: its settings keep DepthMapFactor
itself (tpuslam/io/settings.py:116-117), run.py divides the image by it as
it reads it (run.py:126, io/datasets.py:49-55), and the tracker hands the
same factor to rgbd_to_stereo (engine/tracking.py:435), which multiplies
by it (ops/stereo.py:209). Every depth comes out as the raw PNG value in
metres: 10000 m for a point 2 m away. The port keeps 1 / DepthMapFactor and
passes the image as read, so its tracker applies the factor once.

  * `run.main --dataset tum_rgbd --sensor rgbd` of both packages over the
    first frame of a TUM recording (scripts/make_synth_euroc_torch.py
    `write_tum_rgbd`, 320x240, DepthMapFactor 5000.0): the first keyframe's
    map points sit at 5000 times the renderer's depth in tpuslam, and within
    the uint16 quantization (0.5 / 5000 m) of it in the port.
  * The published KITTI00-02.yaml (stereo and monocular) and TUM3.yaml text
    load alike in both packages, with the published values, except
    depth_map_factor: 1 / 5000 in the port, 5000 in tpuslam.
  * A caller of System.track_rgbd that passes metres keeps the default
    factor of 1: tests/test_torch_rgbd.py, chip_smoke.py phase 6 and
    bench_sensors_torch.py are unchanged.
"""

import numpy as np
import pytest

import tpuslam.engine as j_engine
from tpuslam import run as j_run
from tpuslam.io.settings import load_settings as j_load_settings
from tpuslam_torch import run
from tpuslam_torch.engine.config import SlamConfig
from tpuslam_torch.io.settings import load_settings

import torch_datasets as TD

SCALE = 0.5


@pytest.fixture(scope="module")
def first_keyframes(tmp_path_factory):
    """Both packages' Systems after run.main over the recording's first
    frame, with the renderer's depth of that frame."""
    out = str(tmp_path_factory.mktemp("tum_factor") / "fr3")
    seq = TD.tum_sequence(2, SCALE)
    settings = TD.script().write_tum_rgbd(seq, out, n_features=1000)
    systems = {}
    mp = pytest.MonkeyPatch()
    for name, module, attr in (("tpuslam", j_engine, "System"), ("port", run, "System")):
        base = getattr(module, attr)

        class Recorded(base):
            def __init__(self, *a, _name=name, **kw):
                super().__init__(*a, **kw)
                systems[_name] = self

        mp.setattr(module, attr, Recorded)
    argv = ["--dataset", "tum_rgbd", "--path", out, "--settings", settings, "--sensor", "rgbd",
            "--max-frames", "1"]
    try:
        reps = {"tpuslam": j_run.main(argv + ["--output", out + "/ref.txt"]),
                "port": run.main(argv + ["--output", out + "/port.txt", "--device", "cpu"])}
    finally:
        mp.undo()
    return systems, reps, seq.frame_rgbd(0)[1]


def _first_keyframe_depths(slam, depth):
    """(the first keyframe's map points' depths, the renderer's depth at
    their keypoints): the first keyframe is the world frame."""
    m = slam.map
    slots = np.nonzero(m.kf_mp[0] >= 0)[0]
    xy = m.kf_feats[0].xy[slots]
    truth = depth[np.round(xy[:, 1]).astype(int), np.round(xy[:, 0]).astype(int)]
    assert np.allclose(m.kf_R[0], np.eye(3)) and np.allclose(m.kf_t[0], 0.0)
    return m.mp_pos[m.kf_mp[0, slots], 2], truth.astype(np.float64)


def test_tpuslam_applies_depth_map_factor_twice(first_keyframes):
    systems, reps, depth = first_keyframes
    assert reps["tpuslam"]["keyframes"] == 1 and reps["tpuslam"]["map_points"] > 100
    z, truth = _first_keyframe_depths(systems["tpuslam"], depth)
    assert systems["tpuslam"].cfg.depth_map_factor == 5000.0
    np.testing.assert_allclose(np.median(z / truth), 5000.0, rtol=1e-3)
    assert np.abs(z / 5000.0 - truth).max() <= 0.5 / 5000 + 1e-6 * truth.max()


def test_the_port_applies_it_once(first_keyframes):
    systems, reps, depth = first_keyframes
    assert reps["port"]["keyframes"] == 1
    assert reps["port"]["map_points"] == reps["tpuslam"]["map_points"]
    z, truth = _first_keyframe_depths(systems["port"], depth)
    assert systems["port"].cfg.depth_map_factor == 1.0 / 5000.0
    assert np.abs(z - truth).max() <= 0.5 / 5000 + 1e-6 * truth.max()
    assert SlamConfig().depth_map_factor == 1.0      # metres by default


PUBLISHED = {
    "kitti_stereo": lambda s: s.kitti_yaml(**s.KITTI00_02),
    "kitti_mono": lambda s: s.kitti_yaml(**s.KITTI00_02, mono=True),
    "tum3": lambda s: s.tum3_yaml(**s.TUM3),
}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_settings_load_alike(name, tmp_path):
    s = TD.script()
    text = PUBLISHED[name](s)
    assert text.startswith("%YAML:1.0\n") and "#----" in text
    path = tmp_path / f"{name}.yaml"
    path.write_text(text)
    got, want = load_settings(str(path)), j_load_settings(str(path))
    assert got.raw == want.raw
    pub = s.TUM3 if name == "tum3" else s.KITTI00_02
    assert np.array_equal(np.asarray(got.camera.params), np.asarray(want.camera.params))
    assert np.array_equal(got.camera.params,    # the cameras keep f32 intrinsics
                          np.float32([pub["fx"], pub["fy"], pub["cx"], pub["cy"]]))
    assert (got.camera.width, got.camera.height) == (want.camera.width, want.camera.height) \
        == (pub["width"], pub["height"])
    assert not np.any(got.camera.dist) and not np.any(want.camera.dist)
    assert (got.bf, got.fps) == (want.bf, want.fps) == (
        0.0 if name == "kitti_mono" else pub["bf"], pub["fps"])
    o, jo = got.cfg.orb, want.cfg.orb
    assert (o.n_features, o.scale, o.n_levels, o.ini_th, o.min_th) \
        == (jo.n_features, jo.scale, jo.n_levels, jo.ini_th, jo.min_th) \
        == (pub["n_features"], 1.2, 8, 20, 7)
    assert got.cfg.th_depth == want.cfg.th_depth == (40.0 if name == "tum3" else 35.0)
    assert got.cfg.tracking.max_frames_between_kf == want.cfg.tracking.max_frames_between_kf \
        == int(pub["fps"])
    assert got.rectification is want.rectification is None and not got.has_imu
    if name == "tum3":
        assert want.cfg.depth_map_factor == 5000.0 and got.cfg.depth_map_factor == 1 / 5000.0
    else:
        assert got.cfg.depth_map_factor == want.cfg.depth_map_factor == 1.0
