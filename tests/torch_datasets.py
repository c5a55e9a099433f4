"""The dataset CLI's KITTI, TUM RGB-D and CSV routes on rendered trees:
the sequences, the trees and the gates that tests/test_torch_{kitti,
tum_rgbd,csv}_cli.py and chip_smoke.py's phase 18 share.

Each sequence is the renderer's room (tpuslam_torch.io.synthetic) seen by
the published camera of its format, scaled by `scale` (1.0: the published
size; the CPU tests take 0.5): KITTI00-02's 1241x376 pair with its 0.537 m
baseline at 10 fps, TUM3's 640x480 RGB-D camera with its 40 / 535.4 m
projector baseline at 30 fps, and the renderer's own 376x240 camera for the
fork's CSV format at 10 fps. The trees are written by
scripts/make_synth_euroc_torch.py. Imports only the port and numpy.
"""

import functools
import importlib.util
import os

import numpy as np

from tpuslam_torch.eval.ate import associate, ate_rmse
from tpuslam_torch.io.synthetic import SyntheticSequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# PERF.md §2: stereo and RGB-D unscaled ATE and Horn scale; tests/test_e2e_mono.py's gates
STEREO_ATE, STEREO_SCALE = 0.05, 0.03
MONO_ATE, MONO_KFS, MONO_POINTS = 0.10, 3, 100


@functools.lru_cache(maxsize=None)
def script():
    """scripts/make_synth_euroc_torch.py as a module (the tree writers)."""
    spec = importlib.util.spec_from_file_location(
        "make_synth_euroc_torch", os.path.join(ROOT, "scripts", "make_synth_euroc_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _camera(pub, scale):
    return dict(width=int(pub["width"] * scale), height=int(pub["height"] * scale),
                fx=pub["fx"] * scale, fy=pub["fy"] * scale, cx=pub["cx"] * scale,
                cy=pub["cy"] * scale, baseline=pub["bf"] / pub["fx"])


def kitti_sequence(n_frames, scale=1.0, speed=1.0):
    """KITTI00-02's stereo camera in the room at `speed` m/s, 10 fps."""
    return SyntheticSequence(seed=0, n_frames=n_frames, fps=script().KITTI00_02["fps"],
                             speed=speed, **_camera(script().KITTI00_02, scale))


def tum_sequence(n_frames, scale=1.0, speed=0.5):
    """TUM3's RGB-D camera in the room at `speed` m/s, 30 fps."""
    return SyntheticSequence(seed=0, n_frames=n_frames, fps=script().TUM3["fps"], speed=speed,
                             **_camera(script().TUM3, scale))


def csv_sequence(n_frames, speed=0.5):
    """The renderer's own camera (376x240, fx 200), 10 fps."""
    return SyntheticSequence(seed=0, n_frames=n_frames, fps=10.0, speed=speed, baseline=0.1)


def gt_center(seq, t):
    """The renderer's camera centre at sequence time t."""
    R, tt = seq.gt_pose_cw(t)
    return -R.T @ tt


def kitti_rows_gates(rows, seq):
    """The stereo gates on a KITTI trajectory file's rows (3x4 Twc, one per
    frame, no stamps): the rows must be one per frame; the unscaled ATE and
    the Horn scale against the frames' camera centres."""
    rows = np.asarray(rows, np.float64).reshape(-1, 12)
    est = rows[:, [3, 7, 11]]
    gt = np.array([gt_center(seq, t) for t in seq.timestamps()[:len(rows)]])
    ate, _ = ate_rmse(est, gt, with_scale=False)
    _, scale = ate_rmse(est, gt, with_scale=True)
    return dict(rows=len(rows), ate=float(ate), scale=float(scale))


def tum_rows_gates(rows, seq, t0=0.0, with_scale=False):
    """ATE of TUM rows (t x y z qx qy qz qw, stamped from t0) against the
    renderer's centres at their sequence times: unscaled with the Horn scale
    (stereo, RGB-D) or scaled (mono)."""
    rows = np.asarray(rows, np.float64)
    gt = np.array([gt_center(seq, t - t0) for t in rows[:, 0]])
    ate, scale = ate_rmse(rows[:, 1:4], gt, with_scale=with_scale)
    if not with_scale:
        _, scale = ate_rmse(rows[:, 1:4], gt, with_scale=True)
    return dict(rows=len(rows), ate=float(ate), scale=float(scale))


def report_gt_ate(rows, gt):
    """The unscaled ATE of TUM rows against a tree's ground-truth rows, as
    run.main --eval associates them."""
    i_e, i_g = associate(rows[:, 0], gt[:, 0])
    return float(ate_rmse(rows[i_e, 1:4], gt[i_g, 1:4], with_scale=False)[0]), len(i_e)
