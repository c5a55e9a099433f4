"""Write tests/data/mono_vi_merge.npz, the inputs and references of
tests/test_torch_mono_vi_merge_replay.py: tpuslam's state around its merge
of the two mono-inertial sessions of tests/torch_mono_vi_merge.py.

    python tests/make_mono_vi_merge_data.py [--out PATH]

(from the repo root, on the CPU, jax in x64 as the tests run it; ~3 min.)

tpuslam's IMU_MONOCULAR System (tests/torch_mono_vi_merge.py's sessions
and configuration, the vocabulary of tests/torch_vi_merge.py; its young
map's initial BA held to the port's repair, as in
tests/test_torch_mono_vi_merge.py's lockstep) tracks A, change_dataset(),
then B up to the frame of the merge. Saved (tests/torch_vi_merge_state.py's
layout for whole maps): the map just before `_correct_loop(merge=True)`
("pre.") with its arguments; the essential graph's arguments and result; the map right before and
right after the visual-inertial weld BA ("preweld.", "weld.") with its
optimized and fixed keyframes; the map after the correction and its
synchronous GBA ("post.").
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import tpuslam.engine.inertial as j_inertial  # noqa: E402
import tpuslam.engine.loop_closing as j_loop  # noqa: E402
import tpuslam.engine.tracking as j_tracking  # noqa: E402
from tpuslam.cameras import Pinhole as JPinhole  # noqa: E402
from tpuslam.engine import System as JSystem  # noqa: E402
from tpuslam.engine.config import InertialConfig as JInertialConfig  # noqa: E402
from tpuslam.engine.config import LoopConfig as JLoopConfig  # noqa: E402
from tpuslam.engine.config import SlamConfig as JSlamConfig  # noqa: E402
from tpuslam.engine.config import TrackingConfig as JTrackingConfig  # noqa: E402
from tpuslam.engine.system import Sensor as JSensor  # noqa: E402
from tpuslam.imu.preintegration import ImuCalib as JImuCalib  # noqa: E402
from tpuslam.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from tpuslam.place import load_orbvoc as j_load_orbvoc  # noqa: E402
from tpuslam_torch.map.store import map_state  # noqa: E402

import torch_mono_vi_merge as mv  # noqa: E402
import torch_vi_merge_state as state  # noqa: E402
from torch_mono_merge import init_ba_on_its_points  # noqa: E402
from torch_vi_merge import NOISE, session_imu, vocabulary_text  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "data", "mono_vi_merge.npz"))
    args = ap.parse_args(argv)
    seq, sessions = mv.sessions()
    voc = vocabulary_text(seq, args.out + ".voc.txt")
    slam = JSystem(
        JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
        JSlamConfig(orb=JOrbConfig(n_features=mv.FEATURES),
                    tracking=JTrackingConfig(max_frames_between_kf=mv.MAX_KF_FRAMES),
                    loop=JLoopConfig(background_gba=False),
                    inertial=JInertialConfig(**mv.INERTIAL)),
        sensor=JSensor.IMU_MONOCULAR, imu_calib=JImuCalib(**dict(NOISE, freq=seq.imu_rate)),
        vocab=j_load_orbvoc(voc))
    os.remove(voc)
    m, lc = slam.map, slam.loop_closer
    rec, out = {"frame": 0}, {}
    real_correct = lc._correct_loop
    real_graph, real_weld = j_loop.optimize_essential_graph, j_inertial.window_inertial_ba

    def graph(*a, **kw):
        res = real_graph(*a, **kw)
        ks = sorted(res)
        out.update({"graph_four_dof": np.array(bool(kw["four_dof"])),
                    "graph_fix_kf": np.array(kw["fix_kf"]),
                    "graph_fix_kfs": np.array(kw["fix_kfs"], np.int64),
                    "graph_kf": np.array(ks, np.int64),
                    "graph_s": np.array([float(res[k][0]) for k in ks]),
                    "graph_R": np.array([np.asarray(res[k][1]) for k in ks]),
                    "graph_t": np.array([np.asarray(res[k][2]) for k in ks])})
        return res

    def weld(mm, camera, calib, inv_sigma2, opt_kfs, fixed_kfs, **kw):
        rec["preweld"] = map_state(mm)
        res = real_weld(mm, camera, calib, inv_sigma2, opt_kfs=opt_kfs, fixed_kfs=fixed_kfs,
                        **kw)
        out["weld_opt"] = np.array(opt_kfs, np.int64)
        out["weld_fixed"] = np.array(fixed_kfs, np.int64)
        rec["weld"] = map_state(mm)
        return res

    def correct(kf, cand, s, R, t, match_pairs, merge=False):
        if not merge:
            return real_correct(kf, cand, s, R, t, match_pairs, merge=merge)
        rec["pre"] = map_state(m)
        out.update({"correct_frame": np.array(rec["frame"]), "correct_kf": np.array(kf),
                    "correct_cand": np.array(cand), "correct_s": np.array(float(s)),
                    "correct_R": np.asarray(R, np.float64),
                    "correct_t": np.asarray(t, np.float64),
                    "correct_pairs": np.array(match_pairs, np.int64).reshape(-1, 2),
                    "loop_edges": np.array([(a, b) for a, b, _ in lc.loop_edges],
                                           np.int64).reshape(-1, 2)})
        j_inertial.window_inertial_ba = weld
        j_loop.optimize_essential_graph = graph
        try:
            res = real_correct(kf, cand, s, R, t, match_pairs, merge=merge)
        finally:
            j_inertial.window_inertial_ba = real_weld
            j_loop.optimize_essential_graph = real_graph
        rec["post"] = map_state(m)
        return res

    j_tracking.Tracker._initial_ba = init_ba_on_its_points(j_tracking.Tracker._initial_ba)
    lc._correct_loop = correct
    for s_i, sess in enumerate(sessions):
        if s_i:
            slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            slam.track_monocular(sess.frame(i), float(t), imu=session_imu(sess, i))
            rec["frame"] += 1
            if "post" in rec:
                break
        if "post" in rec:
            break
    assert "post" in rec, "no merge"
    out.update(state.pack({"pre.": rec["pre"], "preweld.": rec["preweld"], "weld.": rec["weld"],
                           "post.": rec["post"]}))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB; merge on run frame "
          f"{int(out['correct_frame'])}, keyframe {int(out['correct_kf'])} onto "
          f"{int(out['correct_cand'])}, Sim3 scale {float(out['correct_s'])}")


if __name__ == "__main__":
    main()
