"""Write tests/data/mono_merge.npz, the inputs and references of
tests/test_torch_mono_merge_replay.py: tpuslam's state around its merge of
the two monocular sessions of tests/torch_mono_merge.py.

    python tests/make_mono_merge_data.py [--out PATH]

(from the repo root, on the CPU, jax in x64 as the tests run it; ~2 min.)

tpuslam's MONOCULAR System (tests/torch_mono_merge.py's room, config and
vocabulary; its young map's initial BA held to the port's repair, as in
tests/test_torch_mono_merge.py's lockstep) tracks A, change_dataset(), then
B up to the frame of the merge. Saved (tests/torch_vi_merge_state.py's
layout for whole maps):

  * "init.": the map just before the young map's initial BA, with its two
    keyframes; what the repaired BA wrote (kf1's pose, every point) and
    what tpuslam's own BA writes on the same map ("init_faulty_").
  * "pre.": the map just before `_correct_loop(merge=True)`, with its
    arguments.
  * at the essential graph's call: the keyframe poses and points after the
    transport, the seam fuse and the relabel ("graph_in_"), the corrected
    seeds, the fixed keyframes, and the graph's result ("graph_").
  * after the weld BA ("weld_") and after the correction and its
    synchronous GBA ("post_"): keyframe poses, validity and map labels and
    the points.
"""

import argparse
import os
import sys
from types import SimpleNamespace

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import tpuslam.engine.local_mapping as j_mapping  # noqa: E402
import tpuslam.engine.loop_closing as j_loop  # noqa: E402
import tpuslam.engine.tracking as j_tracking  # noqa: E402
from tpuslam.cameras import Pinhole as JPinhole  # noqa: E402
from tpuslam.engine import System as JSystem  # noqa: E402
from tpuslam.engine.config import LoopConfig as JLoopConfig  # noqa: E402
from tpuslam.engine.config import SlamConfig as JSlamConfig  # noqa: E402
from tpuslam.engine.config import TrackingConfig as JTrackingConfig  # noqa: E402
from tpuslam.engine.system import Sensor as JSensor  # noqa: E402
from tpuslam.ops.orb import OrbConfig as JOrbConfig  # noqa: E402
from tpuslam.place import load_orbvoc as j_load_orbvoc  # noqa: E402
from tpuslam_torch.map.store import map_state  # noqa: E402

import torch_vi_merge_state as state  # noqa: E402
from test_torch_vi_merge_replay import _tpuslam_map  # noqa: E402
from torch_mono_merge import (MAX_KF_FRAMES, N_FEATURES, camera_of, drive,  # noqa: E402
                              init_ba_on_its_points, room, vocabulary)


def _poses_points(m, prefix):
    return {prefix + "kf_R": np.array(m.kf_R[: m.n_kf]), prefix + "kf_t": np.array(m.kf_t[: m.n_kf]),
            prefix + "kf_valid": np.array(m.kf_valid[: m.n_kf]),
            prefix + "kf_map_id": np.array(m.kf_map_id[: m.n_kf]),
            prefix + "mp_pos": np.array(m.mp_pos[: m.n_mp]),
            prefix + "mp_valid": np.array(m.mp_valid[: m.n_mp])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "data", "mono_merge.npz"))
    args = ap.parse_args(argv)
    seq, frames, sessions = room()
    voc = vocabulary(seq, frames, args.out + ".voc.txt")
    cam, w, h = camera_of(seq)
    slam = JSystem(JPinhole(cam, w, h),
                   JSlamConfig(orb=JOrbConfig(n_features=N_FEATURES),
                               tracking=JTrackingConfig(max_frames_between_kf=MAX_KF_FRAMES),
                               loop=JLoopConfig(background_gba=False)),
                   sensor=JSensor.MONOCULAR, vocab=j_load_orbvoc(voc))
    os.remove(voc)
    m, lc = slam.map, slam.loop_closer
    out, states = {}, {}
    real_init = j_tracking.Tracker._initial_ba
    repaired = init_ba_on_its_points(real_init)

    def initial_ba(self, kf0, kf1):
        if self.map.kf_map_id[kf0] == 0:
            return repaired(self, kf0, kf1)
        states["init."] = map_state(self.map)
        # tpuslam's own BA, on a copy of the map
        copy = SimpleNamespace(map=_tpuslam_map(*states["init."]), camera=self.camera,
                               camspec=self.camspec, inv_sigma2=self.inv_sigma2)
        real_init(copy, kf0, kf1)
        out.update({"init_kf0": np.array(kf0), "init_kf1": np.array(kf1),
                    "init_faulty_kf1_R": copy.map.kf_R[kf1].copy(),
                    "init_faulty_kf1_t": copy.map.kf_t[kf1].copy(),
                    "init_faulty_mp_pos": copy.map.mp_pos[: copy.map.n_mp].copy()})
        repaired(self, kf0, kf1)
        out.update({"init_kf1_R": self.map.kf_R[kf1].copy(),
                    "init_kf1_t": self.map.kf_t[kf1].copy(),
                    "init_mp_pos": self.map.mp_pos[: self.map.n_mp].copy()})

    real_graph, real_weld, real_correct = (j_loop.optimize_essential_graph,
                                           j_mapping.window_ba, lc._correct_loop)

    def graph(mm, loop_edges, corrected, fix_kf, **kw):
        out.update(_poses_points(mm, "graph_in_"))
        ks = sorted(corrected)
        out.update({"graph_corrected_kf": np.array(ks, np.int64),
                    "graph_corrected_s": np.array([float(corrected[k][0]) for k in ks]),
                    "graph_corrected_R": np.array([np.asarray(corrected[k][1]) for k in ks]),
                    "graph_corrected_t": np.array([np.asarray(corrected[k][2]) for k in ks]),
                    "graph_fix_kf": np.array(fix_kf),
                    "graph_fix_kfs": np.array(kw["fix_kfs"], np.int64),
                    "graph_fix_scale": np.array(bool(kw["fix_scale"]))})
        res = real_graph(mm, loop_edges, corrected, fix_kf, **kw)
        ks = sorted(res)
        out.update({"graph_kf": np.array(ks, np.int64),
                    "graph_s": np.array([float(res[k][0]) for k in ks]),
                    "graph_R": np.array([np.asarray(res[k][1]) for k in ks]),
                    "graph_t": np.array([np.asarray(res[k][2]) for k in ks])})
        return res

    def weld(mm, *a, **kw):
        res = real_weld(mm, *a, **kw)
        out.update(_poses_points(mm, "weld_"))
        out["weld_kfs"] = np.array(a[4], np.int64)
        out["weld_fixed"] = np.array(kw["fixed_kfs"], np.int64)
        return res

    def correct(kf, cand, s, R, t, match_pairs, merge=False):
        if not merge:
            return real_correct(kf, cand, s, R, t, match_pairs, merge=merge)
        states["pre."] = map_state(m)
        out.update({"correct_kf": np.array(kf), "correct_cand": np.array(cand),
                    "correct_s": np.array(float(s)), "correct_R": np.asarray(R, np.float64),
                    "correct_t": np.asarray(t, np.float64),
                    "correct_pairs": np.array(match_pairs, np.int64).reshape(-1, 2),
                    "loop_edges": np.array([(a, b) for a, b, _ in lc.loop_edges],
                                           np.int64).reshape(-1, 2)})
        j_loop.optimize_essential_graph, j_mapping.window_ba = graph, weld
        try:
            res = real_correct(kf, cand, s, R, t, match_pairs, merge=merge)
        finally:
            j_loop.optimize_essential_graph, j_mapping.window_ba = real_graph, real_weld
        out.update(_poses_points(m, "post_"))
        return res

    j_tracking.Tracker._initial_ba = initial_ba
    lc._correct_loop = correct
    rows, merges = drive(slam, frames, sessions, stop_after_merge=True)
    j_tracking.Tracker._initial_ba = real_init
    assert len(merges) == 1 and "post_kf_R" in out, merges
    out["correct_frame"] = np.array(merges[0][0])
    out.update(state.pack(states))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB; merge on run frame "
          f"{merges[0][0]}, keyframe {merges[0][1]} onto {merges[0][2]}, Sim3 scale "
          f"{merges[0][3]:.6f}")


if __name__ == "__main__":
    main()
