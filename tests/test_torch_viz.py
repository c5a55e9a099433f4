"""The port's map and frame drawings against tpuslam's (matplotlib, CPU).

Both packages draw the same map (tests/test_engine_vi.py::_build_map,
carried into the port with map_state / map_from_numpy) and the same frame;
the port gets its trajectory, image, keypoints and map-point ids as
tensors, which it moves to host numpy. The PNGs, decoded by the port's
io/png.py, must be equal pixel for pixel.
"""

import types

import numpy as np
import pytest
import torch

from tpuslam import viz as j_viz
from tpuslam_torch import viz
from tpuslam_torch.io.png import read_png
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.store import map_from_numpy, map_state

from test_engine_vi import _build_map


@pytest.fixture(scope="module")
def maps():
    jm, *_ = _build_map(np.random.RandomState(0))
    return jm, map_from_numpy(*map_state(jm))


def _same_png(a, b):
    pa, pb = read_png(str(a), gray=False), read_png(str(b), gray=False)
    assert pa.shape == pb.shape and pa.size > 0
    assert np.array_equal(pa, pb)
    return pa


def test_draw_map_matches_tpuslam(maps, tmp_path):
    jm, tm_ = maps
    traj = np.stack([jm.kf_center(k) for k in jm.valid_kf_ids()])
    gt = traj + 0.02
    j_viz.draw_map(jm, str(tmp_path / "ref.png"), trajectory=traj, gt=gt)
    viz.draw_map(tm_, str(tmp_path / "port.png"), trajectory=torch.as_tensor(traj), gt=gt)
    px = _same_png(tmp_path / "ref.png", tmp_path / "port.png")
    # the drawing holds more than the background: points, keyframes, edges
    assert len(np.unique(px.reshape(-1, px.shape[-1]), axis=0)) > 10


def test_draw_frame_matches_tpuslam(maps, tmp_path):
    jm, _ = maps
    f = jm.kf_feats[0]
    img = SyntheticSequence(n_frames=1).frame(0)
    mp_ids = np.where(np.arange(f.n) % 3 == 0, -1, np.arange(f.n)).astype(np.int32)
    j_viz.draw_frame(img, f, mp_ids, str(tmp_path / "ref.png"))
    feats = types.SimpleNamespace(xy=torch.as_tensor(f.xy), valid=torch.as_tensor(f.valid))
    viz.draw_frame(torch.as_tensor(img), feats, torch.as_tensor(mp_ids), str(tmp_path / "port.png"))
    _same_png(tmp_path / "ref.png", tmp_path / "port.png")
    # without map-point ids every keypoint is drawn untracked
    j_viz.draw_frame(img, f, None, str(tmp_path / "ref0.png"))
    viz.draw_frame(img, f, None, str(tmp_path / "port0.png"))
    _same_png(tmp_path / "ref0.png", tmp_path / "port0.png")
