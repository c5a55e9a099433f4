"""Dataset runner CLI: `python -m tpuslam_torch.run --dataset euroc --path ...`
(port of tpuslam/run.py).

Replaces the reference's per-dataset example drivers (src/main.cpp,
src/main_vi.cpp, Examples/Monocular/mono_euroc.cc,
Examples/Stereo-Inertial/stereo_inertial_euroc.cc:233 TrackStereo loop,
Examples/RGB-D/rgbd_tum.cc) and the eval invocation
(euroc_eval_examples.sh: evaluate_ate_scale GT traj). The same arguments
as tpuslam's, plus --device: the System runs on the card unless
`--device cpu` is given (without a card the default raises).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .engine.system import Sensor, System
from .eval.ate import associate, ate_rmse
from .io import datasets as D
from .io.settings import load_settings
from .place.orbvoc import load_orbvoc
from .place.store import load_vocabulary
from .utils import DEFAULT_DEVICE


def build_argparser():
    p = argparse.ArgumentParser(description="tpuslam_torch dataset runner")
    p.add_argument("--dataset", required=True,
                   choices=["euroc", "kitti", "tum_rgbd", "tum_vi", "csv",
                            "synthetic"])
    p.add_argument("--path", default="",
                   help="sequence root directory; comma-separate several "
                        "for a multi-session Atlas run (ref: "
                        "euroc_eval_examples.sh MH01->MH05 ChangeDataset)")
    p.add_argument("--settings", default="", help="reference-style YAML")
    p.add_argument("--sensor", default="mono",
                   choices=["mono", "stereo", "rgbd", "mono_imu",
                            "stereo_imu"])
    p.add_argument("--vocab", default="",
                   help="vocabulary: .npz (trained here) or the "
                        "reference's ORBvoc.txt/.bin (loaded drop-in)")
    p.add_argument("--output", default="trajectory_tum.txt")
    p.add_argument("--format", default="tum",
                   choices=["tum", "euroc", "kitti"])
    p.add_argument("--kf-output", default="")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--eval", action="store_true",
                   help="report ATE vs dataset ground truth")
    p.add_argument("--checkpoint", default="",
                   help="save a map snapshot here at the end")
    p.add_argument("--timing", action="store_true")
    p.add_argument("--async-mapping", action="store_true",
                   help="run LocalMapping/LoopClosing on the worker "
                        "thread (the reference's thread architecture)")
    p.add_argument("--pipelined", action="store_true",
                   help="pipelined fused tracking: one frame of latency")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where tracking, mapping and rectification run: "
                        "the card (default) or 'cpu'")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    def load_one(path):
        if args.dataset == "euroc" or args.dataset == "tum_vi":
            return D.load_euroc(path, stereo="stereo" in args.sensor,
                                with_imu="imu" in args.sensor)
        elif args.dataset == "kitti":
            return D.load_kitti(path, stereo="stereo" in args.sensor)
        elif args.dataset == "tum_rgbd":
            return D.load_tum_rgbd(path)
        elif args.dataset == "csv":
            return D.load_csv_sequence(path, os.path.dirname(path) or ".")
        raise SystemExit("use tests for the synthetic dataset")

    paths = [p_ for p_ in args.path.split(",") if p_]
    seqs = [load_one(p_) for p_ in paths]
    seq = seqs[0]

    # the first image's size stands in for a missing Camera.width / height
    h0, w0 = seq.frame(0).shape[:2]
    st = load_settings(args.settings, width=w0, height=h0)
    sensor = {
        "mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO,
        "rgbd": Sensor.RGBD, "mono_imu": Sensor.IMU_MONOCULAR,
        "stereo_imu": Sensor.IMU_STEREO,
    }[args.sensor]
    vocab = None
    if args.vocab:
        if args.vocab.endswith((".txt", ".bin")):  # reference ORBvoc files
            vocab = load_orbvoc(args.vocab)
        else:
            vocab = load_vocabulary(args.vocab)
    if args.pipelined:
        st.cfg.tracking.pipelined = True
    slam = System(st.camera, st.cfg, sensor=sensor,
                  imu_calib=st.imu_calib if "imu" in args.sensor else None,
                  vocab=vocab, bf=st.bf,
                  camera2=st.camera2 if "stereo" in args.sensor else None,
                  Tlr=st.Tlr, async_mapping=args.async_mapping, device=args.device)

    rectifier = st.make_rectifier(args.device) if "stereo" in args.sensor else None
    times_ms = []
    n_total = 0
    for s_i, sq in enumerate(seqs):
        if s_i > 0:
            # multi-session Atlas run (ref: System::ChangeDataset between
            # sequences, Examples/.../stereo_inertial_euroc.cc multi-seq)
            slam.change_dataset()
        n = len(sq) if args.max_frames <= 0 else min(len(sq),
                                                     args.max_frames)
        n_total += n
        t_prev = None
        for i in range(n):
            t = float(sq.times[i])
            imu = sq.imu_between(t_prev, t) if (
                "imu" in args.sensor and t_prev is not None) else None
            tic = time.perf_counter()
            if args.sensor in ("stereo", "stereo_imu"):
                im_l, im_r = sq.frame(i), sq.frame_right(i)
                if rectifier is not None:
                    im_l, im_r = rectifier(im_l, im_r)
                slam.track_stereo(im_l, im_r, t, imu=imu)
            elif args.sensor == "rgbd":
                # the depth image as read: the tracker scales it once by
                # depth_map_factor (1 / DepthMapFactor, ref GrabImageRGBD)
                slam.track_rgbd(sq.frame(i), sq.depth(i), t)
            else:
                slam.track_monocular(sq.frame(i), t, imu=imu)
            times_ms.append((time.perf_counter() - tic) * 1e3)
            t_prev = t
            if args.timing and i % 50 == 0:
                print(f"[seq{s_i} {i}/{n}] median frame "
                      f"{np.median(times_ms[-50:]):.1f} ms", file=sys.stderr)
    n = n_total
    # settle the tracking pipeline, drain the mapping queue, join GBA
    # (ref: System::Shutdown before the trajectory savers, main.cpp)
    if slam.async_mapper is not None:
        slam.async_mapper.flush(raise_errors=False)
    slam.shutdown()

    writer = {"tum": slam.save_trajectory_tum,
              "euroc": slam.save_trajectory_euroc,
              "kitti": slam.save_trajectory_kitti}[args.format]
    writer(args.output)
    if args.kf_output:
        rows = slam.keyframe_trajectory_tum()
        with open(args.kf_output, "w") as fh:
            for r in rows:
                fh.write(" ".join(f"{v:.9f}" for v in r) + "\n")
    if args.checkpoint:
        slam.save_checkpoint(args.checkpoint)

    report = dict(
        frames=n,
        keyframes=int(len(slam.map.valid_kf_ids(all_maps=True))),
        map_points=int(slam.map.mp_valid[: slam.map.n_mp].sum()),
        maps=len(slam.map.map_ids()),
        state=slam.get_tracking_state().name,
        median_ms=float(np.median(times_ms)) if times_ms else None,
    )
    if args.eval and seq.gt is not None:
        traj = slam.trajectory_tum()
        t_est = np.array([r[0] for r in traj])
        p_est = np.array([[r[1], r[2], r[3]] for r in traj])
        i_e, i_g = associate(t_est, seq.gt[:, 0])
        if len(i_e) >= 3:
            mono = args.sensor in ("mono",)
            rmse, scale = ate_rmse(p_est[i_e], seq.gt[i_g, 1:4],
                                   with_scale=mono)
            report["ate_rmse"] = round(float(rmse), 5)
            report["ate_scale"] = round(float(scale), 5)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
