"""Dataset loaders: EuRoC, TUM-VI, KITTI odometry, TUM RGB-D, and the
fork's plain-CSV format (port of tpuslam/io/datasets.py).

Replaces the reference example drivers' loading code
(Examples/Stereo-Inertial/stereo_inertial_euroc.cc:36-96 LoadImages/
LoadIMU, Examples/Monocular/mono_kitti.cc, Examples/RGB-D/rgbd_tum.cc +
evaluation/associate.py, and the fork's CSV loader src/main.cpp:19-54).

All loaders yield (timestamp_seconds, paths/arrays) lazily; images are
decoded on access so a sequence can be streamed frame by frame, by the
port's own PNG reader (io/png.py) where tpuslam calls cv2.imread: the
same arrays, without OpenCV.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from ..eval.ate import associate
from .png import read_png


def _imread_gray(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32)


@dataclass
class ImageSequence:
    times: np.ndarray                 # [N] seconds
    paths: list
    paths_right: list | None = None
    depth_paths: list | None = None
    imu: np.ndarray | None = None     # [M,7] (t, wx..wz, ax..az)
    gt: np.ndarray | None = None      # [G,8] (t, x, y, z, qx, qy, qz, qw)

    def __len__(self):
        return len(self.times)

    def frame(self, i: int):
        return _imread_gray(self.paths[i])

    def frame_right(self, i: int):
        return _imread_gray(self.paths_right[i])

    def depth(self, i: int, factor: float = 1.0):
        return read_png(self.depth_paths[i], gray=False).astype(np.float32) / factor

    def imu_between(self, t0: float, t1: float):
        """IMU samples with t in (t0, t1] as the [N,7] batch the tracker
        consumes (ref: drivers batch vImuMeas per frame)."""
        if self.imu is None:
            return None
        s = self.imu
        sel = (s[:, 0] > t0) & (s[:, 0] <= t1)
        return s[sel]


def load_euroc(root: str, cam: str = "cam0", stereo: bool = False,
               with_imu: bool = False) -> ImageSequence:
    """EuRoC MAV format: <root>/mav0/cam0/data.csv + data/<ns>.png,
    imu0/data.csv, state_groundtruth_estimate0/data.csv
    (ref: mono_euroc/stereo_inertial_euroc LoadImages/LoadIMU)."""
    mav = os.path.join(root, "mav0")

    def read_cam(c):
        times, paths = [], []
        with open(os.path.join(mav, c, "data.csv")) as fh:
            for row in csv.reader(fh):
                if not row or row[0].startswith("#"):
                    continue
                times.append(int(row[0]) * 1e-9)
                paths.append(os.path.join(mav, c, "data", row[1].strip()))
        return np.array(times), paths

    t0, p0 = read_cam(cam)
    p1 = None
    if stereo:
        t1, p1 = read_cam("cam1")
        n = min(len(p0), len(p1))
        t0, p0, p1 = t0[:n], p0[:n], p1[:n]
    imu = None
    if with_imu:
        rows = []
        with open(os.path.join(mav, "imu0", "data.csv")) as fh:
            for row in csv.reader(fh):
                if not row or row[0].startswith("#"):
                    continue
                v = [float(x) for x in row]
                rows.append([v[0] * 1e-9, v[1], v[2], v[3], v[4], v[5], v[6]])
        imu = np.array(rows)
    gt = None
    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        rows = []
        with open(gt_csv) as fh:
            for row in csv.reader(fh):
                if not row or row[0].startswith("#"):
                    continue
                v = [float(x) for x in row]
                # EuRoC GT: t, p(3), q(w,x,y,z) -> store (x,y,z,w) order
                rows.append([v[0] * 1e-9, v[1], v[2], v[3],
                             v[5], v[6], v[7], v[4]])
        gt = np.array(rows)
    return ImageSequence(times=t0, paths=p0, paths_right=p1, imu=imu, gt=gt)


def load_kitti(root: str, stereo: bool = False) -> ImageSequence:
    """KITTI odometry: <root>/times.txt + image_0/ image_1/
    (ref: Examples/Monocular/mono_kitti.cc LoadImages)."""
    times = np.loadtxt(os.path.join(root, "times.txt"))
    n = len(times)
    p0 = [os.path.join(root, "image_0", f"{i:06d}.png") for i in range(n)]
    p1 = [os.path.join(root, "image_1", f"{i:06d}.png") for i in range(n)] \
        if stereo else None
    return ImageSequence(times=times, paths=p0, paths_right=p1)


def load_tum_rgbd(root: str, max_dt: float = 0.02) -> ImageSequence:
    """TUM RGB-D: rgb.txt + depth.txt associated by timestamp
    (ref: Examples/RGB-D/rgbd_tum.cc + evaluation/associate.py)."""

    def read_list(name):
        t, p = [], []
        with open(os.path.join(root, name)) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = line.split()[:2]
                t.append(float(a))
                p.append(os.path.join(root, b))
        return np.array(t), p

    t_rgb, p_rgb = read_list("rgb.txt")
    t_d, p_d = read_list("depth.txt")
    i_rgb, i_d = associate(t_rgb, t_d, max_dt=max_dt)
    gt = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        gt = np.loadtxt(gt_file, comments="#")
    return ImageSequence(
        times=t_rgb[i_rgb], paths=[p_rgb[i] for i in i_rgb],
        depth_paths=[p_d[i] for i in i_d], gt=gt)


def load_tum_vi(root: str, stereo: bool = False,
                with_imu: bool = False) -> ImageSequence:
    """TUM-VI uses the same mav0 layout as EuRoC."""
    return load_euroc(root, stereo=stereo, with_imu=with_imu)


def load_csv_sequence(csv_path: str, img_dir: str) -> ImageSequence:
    """The Mac fork's plain CSV driver format: rows `timestamp,filename`
    (ref: src/main.cpp:19-54 LoadImagesFromCSV)."""
    times, paths = [], []
    with open(csv_path) as fh:
        for row in csv.reader(fh):
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0])
            times.append(t * 1e-9 if t > 1e14 else t)
            paths.append(os.path.join(img_dir, row[1].strip()))
    return ImageSequence(times=np.array(times), paths=paths)
