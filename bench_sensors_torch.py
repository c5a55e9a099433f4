"""Per-sensor System throughput rows of the PyTorch port (the counterpart
of bench_sensors.py): RGB-D, fisheye (KB8) stereo and mono-inertial
tracking on one CUDA card, against the reference's single 50 ms per frame
budget for every sensor (src/Tracking.cc:348-533; config/eu.yaml:24, fps
20).

The rows, with bench_sensors.py's shapes and metric names:
  rgbd     RGB-D (image + exact depth, bf = fx * 0.08), 376x240, 700
           features, 20 fps, 0.4 m/s;
  fisheye  KB8 stereo, 256x256, 700 features, the two calibrations of
           bench_sensors.py, a 0.2 m baseline, 20 fps, 0.4 m/s;
  vi       mono-inertial on the vi_excite trajectory, 376x240, 600
           features, 10 fps, 0.3 m/s, a perfect 200 Hz IMU.
Each row runs its sequence twice with a new System (pass 0 takes the
first calls, such as the first torch.func traces of the inertial solve)
and reports the second pass, the first 8 frames left out.

    python3 bench_sensors_torch.py [--frames 80] [--sensors rgbd,fisheye,vi]
    python3 bench_sensors_torch.py --device cpu --frames 10 --sensors rgbd

Prints one JSON line per sensor.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WARM = 8
KB_L = [95.0, 95.0, 128.0, 128.0, 0.0034823894, 0.00071503485, -0.0020532361, 0.00020293674]
KB_R = [94.8, 94.9, 127.6, 128.3, 0.0034003171, 0.0017662782, -0.0026631257, 0.00032995174]


def _report(name, per, slam):
    steady = np.asarray(per[WARM:])
    fps = 1.0 / steady.mean()
    row = {
        "metric": f"system_track_{name}_fps",
        "value": round(float(fps), 2),
        "unit": "frames/s",
        "vs_baseline": round(float(fps) / 20.0, 3),
        "median_ms": round(float(np.median(steady) * 1e3), 1),
        "state": slam.get_tracking_state().name,
        "kfs": len(slam.map.valid_kf_ids()),
    }
    print(json.dumps(row), flush=True)
    return row


def _passes(make, track, n):
    """Two passes of n frames, each with a new System from make(); the
    second's (per-frame s, slam), shut down."""
    for _pass in range(2):
        slam = make()
        per = []
        for i in range(n):
            t0 = time.perf_counter()
            track(slam, i)
            per.append(time.perf_counter() - t0)
        slam.shutdown()
    return per, slam


def bench_rgbd(n, device):
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n, fps=20, speed=0.4)
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    cfg = SlamConfig(orb=OrbConfig(n_features=700),
                     tracking=TrackingConfig(min_stereo_init_features=200))
    frames = [seq.frame_rgbd(i) for i in range(n)]
    times = seq.timestamps()
    per, slam = _passes(
        lambda: System(cam, cfg, sensor=Sensor.RGBD, bf=cam.fx * 0.08, device=device),
        lambda slam, i: slam.track_rgbd(frames[i][0], frames[i][1], times[i]), n)
    return _report("rgbd_376x240_700feat", per, slam)


def bench_fisheye(n, device):
    from tpuslam_torch.cameras import KannalaBrandt8
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.io.synthetic import SyntheticSequence

    cam = KannalaBrandt8(KB_L, 256, 256, lapping=(0, 255))
    cam2 = KannalaBrandt8(KB_R, 256, 256, lapping=(0, 255))
    baseline = 0.2
    Trl = np.eye(4)
    Trl[:3, 3] = [-baseline, 0.0, 0.0]
    seq = SyntheticSequence(n_frames=n, fps=20, speed=0.4, camera=cam, camera2=cam2, Trl=Trl)
    cfg = SlamConfig(orb=OrbConfig(n_features=700),
                     tracking=TrackingConfig(min_stereo_init_features=150))
    frames = [(seq.frame(i), seq.frame(i, right=True)) for i in range(n)]
    times = seq.timestamps()
    per, slam = _passes(
        lambda: System(cam, cfg, sensor=Sensor.STEREO, bf=cam.fx * baseline, camera2=cam2,
                       Tlr=np.linalg.inv(Trl), device=device),
        lambda slam, i: slam.track_stereo(frames[i][0], frames[i][1], times[i]), n)
    return _report("fisheye_stereo_256x256_700feat", per, slam)


def vi_row(n, device):
    """The mono-inertial row's sequence and System: (make, track), as
    _passes takes them."""
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n, fps=10, speed=0.3, imu_rate=200.0, kind="vi_excite")
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height)
    cfg = SlamConfig(orb=OrbConfig(n_features=600),
                     tracking=TrackingConfig(max_frames_between_kf=3))
    calib = ImuCalib(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5,
                     freq=seq.imu_rate)
    frames = [np.asarray(seq.frame(i)) for i in range(n)]
    times = seq.timestamps()
    imus = [None] + [np.column_stack(seq.imu_between(times[i - 1], times[i]))
                     for i in range(1, n)]
    return (lambda: System(cam, cfg, sensor=Sensor.IMU_MONOCULAR, imu_calib=calib,
                           device=device),
            lambda slam, i: slam.track_monocular(frames[i], times[i], imu=imus[i]))


def bench_vi(n, device):
    per, slam = _passes(*vi_row(n, device), n)
    return _report("mono_vi_376x240_600feat", per, slam)


ROWS = {"rgbd": bench_rgbd, "fisheye": bench_fisheye, "vi": bench_vi}


def main(argv=None):
    """Run the rows asked for; print one JSON line each and return them."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=80)
    p.add_argument("--sensors", default="rgbd,fisheye,vi")
    p.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) "
                                                    "or 'cpu'")
    args = p.parse_args(argv)

    from tpuslam_torch.utils import resolve_device

    device = resolve_device(args.device)
    todo = args.sensors.split(",")
    unknown = set(todo) - set(ROWS)
    if unknown:
        raise ValueError(f"unknown sensors {sorted(unknown)}; choose from {sorted(ROWS)}")
    rows = [ROWS[name](args.frames, device) for name in ROWS if name in todo]
    print("done", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
