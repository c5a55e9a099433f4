"""The stereo-inertial merge after the young map's IMU init and VIBA1, on
the mapping thread: the port's merge step replayed through its AsyncMapper
on tpuslam's state, on the CPU.

tests/data/vi_merge_b.npz (tests/test_torch_vi_merge_replay.py says what it
holds) keeps tpuslam's map just before `_correct_loop(merge=True)` of
tests/torch_vi_merge.py's loop_sessions, the correction's arguments and the
map after the correction and its synchronous FullInertialBA. The whole
route with real concurrency takes over 200 s on the CPU at 376x240 (the
second session's 70 frames of fused visual-inertial tracking), so here the
port's LocalMapper and LoopCloser on that state sit behind an AsyncMapper
(`System(async_mapping=True)`'s worker) and the keyframe that closes the
merge is queued to it: the worker runs the correction (the 4-DoF essential
graph, the visual-inertial weld BA and the FullInertialBA, each through
`utils.jacfwd`) under the map lock, while the test's own thread, standing in
for the tracker, waits for the lock as a frame does.

  * The correction ran on the worker thread, with no worker error, and
    lands on tpuslam's keyframe poses, velocities, biases and points within
    the replay's tolerances (the same result as on the calling thread in
    tests/test_torch_vi_merge_replay.py): one map, the young map relabelled,
    the IMU flags kept, map_version bumped so the tracker's handshake runs.
  * The tracker's frame waited for the map lock until the whole correction
    had ended: the loop closer holds the lock through the correction and
    its GBA (ROADMAP §2, a note on speed, not a fault).
"""

import threading
import time

import numpy as np

from tpuslam_torch.map.store import map_state
from tpuslam_torch.parallel.async_mapping import AsyncMapper

import torch_vi_merge_state as state
from test_torch_vi_merge_replay import _closer, _states_agree, data, rig  # noqa: F401


def test_the_merge_step_on_the_mapping_thread(rig, data):
    arrays, feats = state.unpack(data, "pre.")
    lc = _closer("port", rig, arrays, feats)
    lm, m = lc.local_mapper, lc.map
    kf, cand = int(data["correct_kf"]), int(data["correct_cand"])
    version = m.map_version
    ran = {}

    def on_new_keyframe(k):
        # the keyframe's detection confirmed the merge in tpuslam's run: its
        # correction, with the arguments it was given there
        ran.update(thread=threading.current_thread(), t0=time.perf_counter())
        lc._correct_loop(kf, cand, float(data["correct_s"]), data["correct_R"],
                         data["correct_t"], [tuple(p) for p in data["correct_pairs"]],
                         merge=True)
        ran["t1"] = time.perf_counter()

    lm.on_new_keyframe = lambda k, lock=None: None    # mapped before the correction
    lc.on_new_keyframe = on_new_keyframe
    mapper = AsyncMapper(lm, lc, m.lock)
    mapper.on_new_keyframe(kf)
    while "t0" not in ran and mapper.worker.is_alive():
        time.sleep(0.001)
    with m.lock:            # the tracker's next frame
        got_lock = time.perf_counter()
    mapper.flush()
    mapper.shutdown()
    assert mapper.errors == [] and not mapper.worker.is_alive()
    assert ran["thread"] is mapper.worker and ran["thread"] is not threading.current_thread()
    assert got_lock >= ran["t1"], "the frame took the map lock inside the correction"
    print(f"the correction held the map lock {ran['t1'] - ran['t0']:.2f} s")
    want, _ = state.unpack(data, "post.")
    got = map_state(m)[0]
    kfs = np.flatnonzero(want["kf_valid"][: want["n_kf"]])
    assert np.array_equal(got["kf_valid"][: want["n_kf"]], want["kf_valid"][: want["n_kf"]])
    assert np.array_equal(got["kf_map_id"][kfs], want["kf_map_id"][kfs])
    assert np.array_equal(got["mp_valid"], want["mp_valid"])
    for f in ("imu_initialized", "inertial_ba1", "inertial_ba2", "current_map_id"):
        assert got[f] == want[f], f
    _states_agree(got, want, kfs, "the correction on the mapping thread")
    assert m.map_ids() == [0] and m.kf_map_id[kf] == 0 and lc.n_loops_closed == 1
    assert m.map_version > version
