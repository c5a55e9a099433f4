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
