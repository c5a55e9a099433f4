"""Write the inputs and references of tests/test_torch_vi_merge_replay.py:
tests/data/vi_merge_b.npz, tpuslam's state around its merge of two
stereo-inertial sessions after the young map's IMU init and VIBA1, and
tests/data/vi_merge_a.npz, the port's state just before its merge of the
sessions of tests/torch_vi_merge.py's `heave_sessions`.

    python tests/make_vi_merge_data.py [--branch b|a] [--out PATH]

(from the repo root, on the CPU, jax in x64 as the tests run it; b runs
tpuslam, ~10 min, a the port, ~3 min.)

The sequence (seed 0, everything else fixed here): the heave helper's
`loop` trajectory (tests/torch_vi_heave.py: a 1.6 m circle at 1 m/s, one
lap every ~10 s, plus the vertical heave), 376x240, 600 features, 10 fps,
baseline 0.1 m, IMU at 200 Hz. Session A is t = 0-3.2 s (frames 0-32), C
frames 45-114 (t = 4.5-11.4 s) stamped from 100 s, so C starts on the far
side of the circle, initializes its IMU, runs VIBA1 and VIBA2 (the short
schedule: 0.5 / 1.0 s after the init) and only then comes round to A's
arc. tpuslam's IMU_STEREO System (a keyframe at least every 3 frames, the
stereo init at 200 features, synchronous GBA, a vocabulary trained with
the port's train_vocabulary on frames of the circle) tracks A,
change_dataset(), then C up to the frame of the merge.

Saved (tests/torch_vi_merge_state.py's layout): the map just before the
`_try_loop(merge=True)` that opened the merge's pending candidate ("try."),
with the closer's PRNG key, the two keyframes' BoW nodes and what the call
returned, including the Sim3 that optimize_sim3 gave before the inertial
gates; the map just before `_correct_loop(merge=True)` ("pre.") with its
arguments; the map right after the visual-inertial weld BA ("weld.") with
its optimized and fixed keyframes; the essential graph's arguments and
result; the GBA snapshot's kind and keyframes; the map after the
correction and the synchronous GBA ("post."); the frames of C's IMU
events and of every merge try.

Branch a: the port's IMU_STEREO System (f64, synchronous GBA, the
vocabulary of tests/torch_vi_merge.py) tracks A (frames 0-27), then B
(frames 6-45 from 100 s); B's merge waits for its IMU init and is made on
its 34th frame. Saved: the map just before `_correct_loop(merge=True)`
("pre.") with its arguments, the input of the replay's check of the
essential graph across the seam.
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

import torch_vi_merge_state as state  # noqa: E402
from torch_vi_merge import (FEATURES, NOISE, SHORT_SCHEDULE, loop_sessions,  # noqa: E402
                            session_imu, vocabulary_text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--branch", default="b", choices=("a", "b"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    args.out = args.out or os.path.join(HERE, "data", f"vi_merge_{args.branch}.npz")
    (tpuslam_b if args.branch == "b" else port_a)(args.out)


def port_a(path):
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.imu.preintegration import ImuCalib

    from torch_vi_merge import heave_sessions, vocabulary

    seq, sessions = heave_sessions(28, 6, 40)
    slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
                  SlamConfig(orb=OrbConfig(n_features=FEATURES),
                             tracking=TrackingConfig(max_frames_between_kf=3),
                             loop=LoopConfig(background_gba=False)),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**NOISE),
                  bf=seq.fx * seq.baseline, vocab=vocabulary(seq), dtype=torch.float64,
                  device="cpu")
    m, lc = slam.map, slam.loop_closer
    out, real = {}, lc._correct_loop

    def correct(kf, cand, s, R, t, match_pairs, merge=False):
        if merge and not out:
            out.update(state.pack({"pre.": map_state(m)}))
            out.update({"correct_kf": np.array(kf), "correct_cand": np.array(cand),
                        "correct_s": np.array(float(s)), "correct_R": np.asarray(R),
                        "correct_t": np.asarray(t),
                        "correct_pairs": np.array(match_pairs, np.int64).reshape(-1, 2),
                        "loop_edges": np.array([(a, b) for a, b, _ in lc.loop_edges],
                                               np.int64).reshape(-1, 2)})
        return real(kf, cand, s, R, t, match_pairs, merge=merge)

    lc._correct_loop = correct
    for s_i, sess in enumerate(sessions):
        if s_i:
            slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            slam.track_stereo(sess.frame(i), sess.frame(i, right=True), float(t),
                              imu=session_imu(sess, i))
            if out:
                break
        if out:
            break
    slam.shutdown()
    assert out, "no merge"
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB; merge of keyframe "
          f"{int(out['correct_kf'])} onto {int(out['correct_cand'])}")


def tpuslam_b(path):
    seq, sessions = loop_sessions()
    voc = vocabulary_text(seq, os.path.join(os.path.dirname(path), "vi_merge_b_voc.txt"))
    slam = JSystem(
        JPinhole([seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height),
        JSlamConfig(orb=JOrbConfig(n_features=FEATURES),
                    tracking=JTrackingConfig(max_frames_between_kf=3,
                                             min_stereo_init_features=200),
                    loop=JLoopConfig(background_gba=False),
                    inertial=JInertialConfig(**SHORT_SCHEDULE)),
        sensor=JSensor.IMU_STEREO, imu_calib=JImuCalib(**NOISE), bf=seq.fx * seq.baseline,
        vocab=j_load_orbvoc(voc))
    os.remove(voc)
    m, lc = slam.map, slam.loop_closer
    rec = {"frame": 0, "tries": [], "raw": None}
    out = {}
    real_opt, real_try, real_correct = j_loop.optimize_sim3, lc._try_loop, lc._correct_loop
    real_graph, real_weld = j_loop.optimize_essential_graph, j_inertial.window_inertial_ba
    real_snap = lc._snapshot_gba

    def opt(*a, **kw):
        res = real_opt(*a, **kw)
        rec["raw"] = (float(res[0]), np.asarray(res[1], np.float64))
        return res

    def try_loop(kf, cand, merge=False):
        if not merge:
            return real_try(kf, cand, merge=merge)
        before = map_state(m)
        key = np.asarray(jax.random.key_data(lc._rng_key)
                         if jax.dtypes.issubdtype(lc._rng_key.dtype, jax.dtypes.prng_key)
                         else lc._rng_key)
        nodes = (np.asarray(lc.kf_nodes[kf]), np.asarray(lc.kf_nodes[cand]))
        rec["raw"] = None
        res = real_try(kf, cand, merge=merge)
        rec["tries"].append((rec["frame"], kf, cand, res is not None))
        if res is not None:
            s, R, t = res["sim3"]
            rec["try"] = dict(state=before, key=key, kf=kf, cand=cand, nodes=nodes,
                              sim3=(s, np.asarray(R), np.asarray(t)),
                              pairs=np.array(res["match_pairs"], np.int64).reshape(-1, 2),
                              raw=rec["raw"])
        return res

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
        res = real_weld(mm, camera, calib, inv_sigma2, opt_kfs=opt_kfs, fixed_kfs=fixed_kfs,
                        **kw)
        out["weld_opt"] = np.array(opt_kfs, np.int64)
        out["weld_fixed"] = np.array(fixed_kfs, np.int64)
        out["weld_iters"] = np.array(kw.get("n_iters"))
        rec["weld"] = map_state(mm)
        return res

    def snapshot(fix_kf):
        snap = real_snap(fix_kf)
        out["gba_kind"] = np.array(snap.get("kind", "visual") if snap else "none")
        out["gba_kfs"] = np.asarray(snap["kfs"], np.int64) if snap else np.zeros(0, np.int64)
        out["gba_fixed"] = np.asarray(snap["fixed"]) if snap else np.zeros(0, bool)
        return snap

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
        lc._snapshot_gba = snapshot
        try:
            res = real_correct(kf, cand, s, R, t, match_pairs, merge=merge)
        finally:
            j_inertial.window_inertial_ba = real_weld
            j_loop.optimize_essential_graph = real_graph
            lc._snapshot_gba = real_snap
        rec["post"] = map_state(m)
        return res

    j_loop.optimize_sim3 = opt
    lc._try_loop, lc._correct_loop = try_loop, correct
    for s_i, sess in enumerate(sessions):
        if s_i:
            slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            slam.track_stereo(sess.frame(i), sess.frame(i, right=True), float(t),
                              imu=session_imu(sess, i))
            print(f"session {s_i} frame {i} (run frame {rec['frame']}): "
                  f"{slam.get_tracking_state().name}, maps {m.map_ids()}, "
                  f"imu {m.imu_initialized}, ba1 {m.inertial_ba1}", flush=True)
            rec["frame"] += 1
            if "post" in rec:
                break
        if "post" in rec:
            break
    slam.shutdown()
    assert "post" in rec, "no merge"
    tr = rec["try"]
    out.update(state.pack({"try.": tr["state"], "pre.": rec["pre"], "weld.": rec["weld"],
                           "post.": rec["post"]}))
    out.update({"try_key": tr["key"], "try_kf": np.array(tr["kf"]),
                "try_cand": np.array(tr["cand"]), "try_nodes_kf": tr["nodes"][0],
                "try_nodes_cand": tr["nodes"][1], "try_s": np.array(tr["sim3"][0]),
                "try_R": tr["sim3"][1], "try_t": tr["sim3"][2], "try_pairs": tr["pairs"],
                "try_raw_s": np.array(tr["raw"][0]), "try_raw_R": tr["raw"][1],
                "tries": np.array(rec["tries"], np.int64).reshape(-1, 4),
                "events": np.array([(e["event"], e["t"]) for e in
                                    slam.local_mapper.debug_events], str)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {os.path.getsize(path) / 1e6:.2f} MB; merge on run frame "
          f"{int(out['correct_frame'])}, keyframe {int(out['correct_kf'])} onto "
          f"{int(out['correct_cand'])}; events {out['events'].tolist()}")


if __name__ == "__main__":
    main()
