#!/usr/bin/env python
"""Render a synthetic sequence to disk in the EuRoC ASL layout, without
JAX or OpenCV (the PyTorch port's counterpart of make_synth_euroc.py).

Produces <out>/mav0/{cam0,cam1}/data.csv + data/<ns>.png, imu0/data.csv
and state_groundtruth_estimate0/data.csv (GT rows: t_ns, p, q_wxyz, the
reference's format, evaluation/evaluate_ate_scale.py protocol), plus a
reference-style YAML: the same files as make_synth_euroc.py, rendered by
tpuslam_torch.io.synthetic and written by tpuslam_torch.io.png, so the
port's CLI runs end to end from files on disk:

    python scripts/make_synth_euroc_torch.py <out_dir> [--frames N]
    python -m tpuslam_torch.run --dataset euroc --path <out_dir> \
        --settings <out_dir>/synth.yaml --sensor stereo --eval [--device cpu]

With --fisheye it writes a TUM-VI tree instead: a Kannala-Brandt (KB8)
stereo pair at TUM-VI's 512x512 and <out_dir>/tum_vi.yaml,
for `python -m tpuslam_torch.run --dataset tum_vi --settings
<out_dir>/tum_vi.yaml --sensor {mono,stereo,mono_imu,stereo_imu}`.

`write_euroc(seq, out)` and `write_tum_vi(seq, out)` write a given
SyntheticSequence (any size, or frames the caller has rendered);
`identity_rectification_yaml(seq)` gives LEFT./RIGHT. blocks that leave
its pre-rectified pair unchanged. `SessionView(seq, start, n_frames, t0)`
is a stretch of a sequence as a session of its own, stamped from t0, with
its ground truth in the sequence's world frame: two views of one sequence
written as two trees are a multi-session run over one place (`run --path
A,B`, as EuRoC's MH01 -> MH02).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tpuslam_torch.core import lie  # noqa: E402
from tpuslam_torch.io.png import write_png  # noqa: E402
from tpuslam_torch.io.synthetic import SyntheticSequence  # noqa: E402


class SessionView:
    """Frames start .. start + n_frames - 1 of `seq` as a session of their own:
    frame i is seq's frame start + i, stamped t0 + i / fps; its ground truth
    and IMU are seq's at that instant, in seq's world frame. The camera, the
    rig and the rates are seq's."""

    def __init__(self, seq, start, n_frames, t0):
        self.seq, self.start, self.n_frames, self.t0 = seq, start, n_frames, t0

    def __getattr__(self, name):
        if name == "seq":       # not set yet (copy, unpickling)
            raise AttributeError(name)
        return getattr(self.seq, name)

    def _source_time(self, t):
        return t - self.t0 + self.start / self.seq.fps

    def timestamps(self):
        return self.t0 + np.arange(self.n_frames) / self.seq.fps

    def gt_pose_cw(self, t):
        return self.seq.gt_pose_cw(self._source_time(t))

    def frame(self, i, right=False):
        return self.seq.frame(self.start + i, right=right)

    def imu_between(self, t0, t1):
        ts, ws, accs = self.seq.imu_between(self._source_time(t0), self._source_time(t1))
        return ts + (t0 - self._source_time(t0)), ws, accs


def write_tree(seq, out, images=None):
    """Write `seq`'s stereo frames, IMU and ground truth under out/mav0, the
    layout that load_euroc and load_tum_vi read, stamped with
    seq.timestamps(). images: the (left, right) uint8 frames of `seq` where
    the caller has rendered them already."""
    mav = os.path.join(out, "mav0")
    for sub in ("cam0/data", "cam1/data", "imu0",
                "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(mav, sub), exist_ok=True)

    stamps = seq.timestamps()
    cam_rows = []
    for i in range(seq.n_frames):
        t_ns = int(round(stamps[i] * 1e9))
        name = f"{t_ns}.png"
        for c, right in (("cam0", False), ("cam1", True)):
            img = (np.clip(seq.frame(i, right=right), 0, 255).astype(np.uint8)
                   if images is None else images[i][int(right)])
            write_png(os.path.join(mav, c, "data", name), img)
        cam_rows.append((t_ns, name))
    for c in ("cam0", "cam1"):
        with open(os.path.join(mav, c, "data.csv"), "w") as fh:
            fh.write("#timestamp [ns],filename\n")
            for t_ns, name in cam_rows:
                fh.write(f"{t_ns},{name}\n")

    # IMU at 200 Hz over the whole span (ref imu0/data.csv columns:
    # t, w_xyz [rad/s], a_xyz [m/s^2])
    ts, ws, accs = seq.imu_between(stamps[0] - 1e-9, stamps[0] + seq.n_frames / seq.fps)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as fh:
        fh.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                 "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for t, w, a in zip(ts, ws, accs):
            fh.write(f"{int(round(t * 1e9))},{w[0]:.9f},{w[1]:.9f},"
                     f"{w[2]:.9f},{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}\n")

    # GT in the reference format: t_ns, p_xyz, q_wxyz (camera-to-world)
    with open(os.path.join(mav, "state_groundtruth_estimate0",
                           "data.csv"), "w") as fh:
        fh.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                 "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for t in stamps:
            Rcw, tcw = seq.gt_pose_cw(t)
            Rwc = Rcw.T
            p = -Rwc @ tcw
            q = lie.rot_to_quat(torch.as_tensor(Rwc)).numpy()  # x,y,z,w
            fh.write(f"{int(round(t * 1e9))},{p[0]:.9f},{p[1]:.9f},"
                     f"{p[2]:.9f},{q[3]:.9f},{q[0]:.9f},{q[1]:.9f},"
                     f"{q[2]:.9f}\n")


def write_euroc(seq, out, n_features=700, images=None):
    """Write `seq`'s tree (write_tree) and a reference-style YAML
    (pre-rectified pinhole pair, ideal IMU) to out/synth.yaml; returns the
    YAML's path."""
    write_tree(seq, out, images)
    return _write_yaml(seq, out, n_features)


def _write_yaml(seq, out, n_features):
    """write_euroc's settings file, out/synth.yaml; returns its path."""
    yaml_path = os.path.join(out, "synth.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(f"""%YAML:1.0
Camera.type: "PinHole"
Camera.fx: {seq.fx}
Camera.fy: {seq.fy}
Camera.cx: {seq.cx}
Camera.cy: {seq.cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {seq.width}
Camera.height: {seq.height}
Camera.fps: {seq.fps}
Camera.bf: {seq.fx * seq.baseline}
Camera.RGB: 0
ThDepth: 35.0
IMU.Frequency: 200
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
    return yaml_path


def write_tum_vi(seq, out, n_features=1000, images=None):
    """Write `seq`'s tree (write_tree: TUM-VI keeps EuRoC's mav0 layout)
    and a KB8 settings file with the keys of the reference's TUM_512.yaml
    (Camera.* and Camera2.* with k1-k4, the 3x4 Tlr, the lapping areas,
    Camera.bf, IMU.* with Tbc = I: the renderer's IMU is the left camera)
    to out/tum_vi.yaml; returns its path. `seq` carries a Kannala-Brandt
    pair (camera=, camera2=, Trl=)."""
    write_tree(seq, out, images)
    Tlr = np.linalg.inv(seq.Trl)
    bf = seq.camera.fx * float(np.linalg.norm(seq.Trl[:3, 3]))

    def camera(prefix, cam):
        keys = ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4")
        return "".join(f"{prefix}.{k}: {v!r}\n" for k, v in zip(keys, cam.full_params))

    def matrix(name, rows, cols, data):
        return (f"{name}: !!opencv-matrix\n  rows: {rows}\n  cols: {cols}\n  dt: f\n"
                f"  data: [{', '.join(repr(float(v)) for v in np.ravel(data))}]\n")

    yaml_path = os.path.join(out, "tum_vi.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(f"""%YAML:1.0
---
Camera.type: "KannalaBrandt8"
{camera("Camera", seq.camera)}
{camera("Camera2", seq.camera2)}
{matrix("Tlr", 3, 4, Tlr[:3])}
Camera.lappingBegin: {seq.camera.lapping[0]}
Camera.lappingEnd: {seq.camera.lapping[1]}
Camera2.lappingBegin: {seq.camera2.lapping[0]}
Camera2.lappingEnd: {seq.camera2.lapping[1]}

Camera.width: {seq.width}
Camera.height: {seq.height}
Camera.fps: {seq.fps}
Camera.bf: {bf!r}
Camera.RGB: 1
ThDepth: 40.0

{matrix("Tbc", 4, 4, np.eye(4))}
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200

ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
    return yaml_path


# the published settings files' camera and extractor values
# (Examples/Stereo/KITTI00-02.yaml, Examples/Monocular/KITTI00-02.yaml,
# Examples/RGB-D/TUM3.yaml)
KITTI00_02 = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376,
                  bf=386.1448, fps=10.0, n_features=2000)
TUM3 = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6, width=640, height=480, bf=40.0, fps=30.0,
            n_features=1000, depth_map_factor=5000.0)
TUM_T0 = 1305031102.175304     # the first rgb stamp of a TUM RGB-D recording (s)
CSV_T0_NS = 1403636579763555584  # the first stamp of EuRoC's MH01 (ns)


def _orb_block(n_features):
    return f"""
#--------------------------------------------------------------------------------------------
# ORB Parameters
#--------------------------------------------------------------------------------------------

# ORB Extractor: Number of features per image
ORBextractor.nFeatures: {n_features}

# ORB Extractor: Scale factor between levels in the scale pyramid
ORBextractor.scaleFactor: 1.2

# ORB Extractor: Number of levels in the scale pyramid
ORBextractor.nLevels: 8

# ORB Extractor: Fast threshold
# Image is divided in a grid. At each cell FAST are extracted imposing a maximum threshold.
# Firstly we impose iniThFAST. If no corners are detected we impose a lower value minThFAST
# You can lower these values if your images have low contrast
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

#--------------------------------------------------------------------------------------------
# Viewer Parameters
#--------------------------------------------------------------------------------------------
Viewer.KeyFrameSize: 0.6
Viewer.KeyFrameLineWidth: 2
Viewer.GraphLineWidth: 1
Viewer.PointSize: 2
Viewer.CameraSize: 0.7
Viewer.CameraLineWidth: 3
Viewer.ViewpointX: 0
Viewer.ViewpointY: -100
Viewer.ViewpointZ: -0.1
Viewer.ViewpointF: 2000
"""


def _camera_block(fx, fy, cx, cy, width, height, fps):
    return f"""%YAML:1.0

#--------------------------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------------------------
Camera.type: "PinHole"

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: {fx!r}
Camera.fy: {fy!r}
Camera.cx: {cx!r}
Camera.cy: {cy!r}

Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0

Camera.width: {width}
Camera.height: {height}

# Camera frames per second
Camera.fps: {fps!r}
"""


def kitti_yaml(fx, fy, cx, cy, width, height, bf, fps=10.0, n_features=2000, mono=False):
    """The text of the reference's KITTI00-02.yaml (Examples/Stereo, or with
    mono=True Examples/Monocular: no baseline and no ThDepth) with the given
    values; KITTI00_02 holds the published ones."""
    stereo = "" if mono else f"""
# stereo baseline times fx
Camera.bf: {bf!r}
"""
    depth = "" if mono else """
# Close/Far threshold. Baseline times.
ThDepth: 35
"""
    return (_camera_block(fx, fy, cx, cy, width, height, fps) + stereo + """
# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1
""" + depth + _orb_block(n_features))


def tum3_yaml(fx, fy, cx, cy, width, height, bf, fps=30.0, n_features=1000,
              depth_map_factor=5000.0):
    """The text of the reference's Examples/RGB-D/TUM3.yaml with the given
    values; TUM3 holds the published ones."""
    return (_camera_block(fx, fy, cx, cy, width, height, fps).replace(
        "Camera.p2: 0.0\n", "Camera.p2: 0.0\nCamera.k3: 0.0\n") + f"""
# IR projector baseline times fx (aprox.)
Camera.bf: {bf!r}

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Close/Far threshold. Baseline times.
ThDepth: 40.0

# Deptmap values factor
DepthMapFactor: {depth_map_factor!r}
""" + _orb_block(n_features))


def _gray(seq, i, images, right=False):
    if images is not None:
        return images[i][int(right)] if isinstance(images[i], tuple) else images[i]
    return np.clip(seq.frame(i, right=right), 0, 255).astype(np.uint8)


def write_kitti(seq, out, n_features=2000, images=None):
    """Write `seq`'s stereo frames as a KITTI odometry sequence (times.txt,
    image_0/ and image_1/ <%06d>.png, stamped from 0 s as KITTI's are) and
    the reference's KITTI00-02.yaml with seq's camera and baseline, stereo
    to out/KITTI.yaml and monocular to out/KITTI_mono.yaml; returns the two
    paths. KITTI's pose files are not written: the loaders read none.
    images: the (left, right) uint8 frames where the caller has rendered
    them already."""
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    with open(os.path.join(out, "times.txt"), "w") as fh:
        fh.writelines(f"{t:.6e}\n" for t in seq.timestamps())
    for i in range(seq.n_frames):
        for d, right in (("image_0", False), ("image_1", True)):
            write_png(os.path.join(out, d, f"{i:06d}.png"), _gray(seq, i, images, right))
    paths = []
    for name, mono in (("KITTI.yaml", False), ("KITTI_mono.yaml", True)):
        paths.append(os.path.join(out, name))
        with open(paths[-1], "w") as fh:
            fh.write(kitti_yaml(seq.fx, seq.fy, seq.cx, seq.cy, seq.width, seq.height,
                                seq.fx * seq.baseline, seq.fps, n_features, mono=mono))
    return tuple(paths)


def tum_colour(gray):
    """An RGB image of a gray render, tinted (red up, blue down), whose
    IMREAD_GRAYSCALE conversion is the render within 3 gray levels."""
    g = gray.astype(np.int16)
    return np.stack([np.clip(g + 12, 0, 255), g, np.clip(g - 12, 0, 255)], -1).astype(np.uint8)


def write_tum_rgbd(seq, out, n_features=1000, t0=TUM_T0, depth_map_factor=5000.0, frames=None):
    """Write `seq`'s RGB-D frames as a TUM RGB-D recording: rgb/ colour PNGs
    and depth/ uint16 PNGs (depth_map_factor per metre, 0 where there is no
    return or the range overflows 16 bits), rgb.txt and depth.txt (the depth
    stamps a few ms off the colour ones, as the two streams are), and
    groundtruth.txt at 100 Hz (t tx ty tz qx qy qz qw, camera to world),
    stamped from t0 in epoch seconds; the reference's TUM3.yaml with seq's
    camera to out/TUM3.yaml, whose path it returns. frames: (image, depth)
    of seq where the caller has rendered them already."""
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    rgb = ["# color images", "# file: 'rgbd_dataset_synthetic.bag'", "# timestamp filename"]
    dep = ["# depth maps", "# file: 'rgbd_dataset_synthetic.bag'", "# timestamp filename"]
    for i, t in enumerate(seq.timestamps()):
        img, depth = seq.frame_rgbd(i) if frames is None else frames[i]
        tc, td = t0 + t, t0 + t + 0.004 * ((i % 3) - 1)
        write_png(os.path.join(out, "rgb", f"{tc:.6f}.png"),
                  tum_colour(np.clip(img, 0, 255).astype(np.uint8)))
        raw = np.round(np.asarray(depth, np.float64) * depth_map_factor)
        write_png(os.path.join(out, "depth", f"{td:.6f}.png"),
                  np.where((raw > 0) & (raw <= 65535), raw, 0).astype(np.uint16))
        rgb.append(f"{tc:.6f} rgb/{tc:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep)):
        with open(os.path.join(out, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    with open(os.path.join(out, "groundtruth.txt"), "w") as fh:
        fh.write("# ground truth trajectory\n# file: 'rgbd_dataset_synthetic.bag'\n"
                 "# timestamp tx ty tz qx qy qz qw\n")
        for t in np.arange(-0.0473, seq.n_frames / seq.fps + 0.05, 0.01):
            Rcw, tcw = seq.gt_pose_cw(t)
            p = -Rcw.T @ tcw
            q = lie.rot_to_quat(torch.as_tensor(Rcw.T)).numpy()  # x,y,z,w
            fh.write(f"{t0 + t:.4f} {p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                     f"{q[0]:.4f} {q[1]:.4f} {q[2]:.4f} {q[3]:.4f}\n")
    yaml_path = os.path.join(out, "TUM3.yaml")
    with open(yaml_path, "w") as fh:
        fh.write(tum3_yaml(seq.fx, seq.fy, seq.cx, seq.cy, seq.width, seq.height,
                           seq.fx * seq.baseline, seq.fps, n_features, depth_map_factor))
    return yaml_path


def write_csv(seq, out, n_features=1000, t0_ns=CSV_T0_NS, images=None):
    """Write `seq`'s left frames in the Mac fork's CSV format: out/seq.csv
    with `timestamp,filename` rows (ns, stamped from t0_ns) and the images
    under out/data/, with write_euroc's settings file (synth.yaml);
    returns (the CSV's path, the settings' path)."""
    os.makedirs(os.path.join(out, "data"), exist_ok=True)
    rows = ["#timestamp [ns],filename"]
    for i, t in enumerate(seq.timestamps()):
        t_ns = t0_ns + int(round(t * 1e9))
        write_png(os.path.join(out, "data", f"{t_ns}.png"), _gray(seq, i, images))
        rows.append(f"{t_ns},data/{t_ns}.png")
    csv_path = os.path.join(out, "seq.csv")
    with open(csv_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return csv_path, _write_yaml(seq, out, n_features)


def identity_rectification_yaml(seq):
    """LEFT./RIGHT. blocks (K, D = 0, R = I, P = K) for `seq`'s camera:
    the rectification maps are the pixel grid, so the images pass through."""
    K = [seq.fx, 0.0, seq.cx, 0.0, seq.fy, seq.cy, 0.0, 0.0, 1.0]
    P = [seq.fx, 0.0, seq.cx, 0.0, 0.0, seq.fy, seq.cy, 0.0, 0.0, 0.0, 1.0, 0.0]

    def matrix(name, rows, cols, data):
        return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n"
                f"   data: [{', '.join(repr(float(v)) for v in data)}]\n")

    text = ""
    for side in ("LEFT", "RIGHT"):
        text += f"{side}.height: {seq.height}\n{side}.width: {seq.width}\n"
        text += matrix(f"{side}.D", 1, 5, [0.0] * 5)
        text += matrix(f"{side}.K", 3, 3, K)
        text += matrix(f"{side}.R", 3, 3, np.eye(3).ravel())
        text += matrix(f"{side}.P", 3, 4, P)
    return text


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--baseline", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kind", default="vi_excite")
    ap.add_argument("--fisheye", action="store_true",
                    help="a TUM-VI tree: tests/torch_fisheye_rig.py's Kannala-Brandt "
                         "pair at 512x512 and a KB8 settings file")
    args = ap.parse_args(argv)

    fisheye = {}
    if args.fisheye:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests"))
        from torch_fisheye_rig import kb8_rig

        fisheye = dict(zip(("camera", "camera2", "Trl"), kb8_rig(512, args.baseline)))
    seq = SyntheticSequence(seed=args.seed, n_frames=args.frames,
                            fps=args.fps, speed=0.5,
                            baseline=args.baseline, kind=args.kind, **fisheye)
    dataset = "tum_vi" if args.fisheye else "euroc"
    yaml_path = (write_tum_vi if args.fisheye else write_euroc)(seq, args.out)
    print(f"wrote {args.out}: {seq.n_frames} stereo frames + IMU + GT")
    print(f"run: python -m tpuslam_torch.run --dataset {dataset} --path {args.out} "
          f"--settings {yaml_path} --sensor stereo --eval")


if __name__ == "__main__":
    main()
