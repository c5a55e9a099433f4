"""Helpers for runs with the mapper on its own thread (`System(...,
async_mapping=True)`), for the async tests and chip_smoke.py. They import
nothing but the standard library, so they serve tpuslam's Systems as well as
the port's.

  * `serialized(slam)`: flush the mapping worker after every track_stereo call,
    so the worker's code runs in a fixed order and a run is deterministic.
  * `paced(slam)`: tests/test_async_mapping.py's bounded back-pressure
    before a frame (at most 2 s waiting for the queue to fall to 2
    keyframes), as a real deployment runs at the camera's frame period.
  * `lagged(slam, lag=LAG)`: the worker held, and run on each keyframe lag
    frames after the frame that made it, inside that frame's host-path extraction:
    after the tracker chose its path, before it takes the map lock, as a
    busy mapping thread lands its work; anything that waits for the worker
    (AsyncMapper.flush) lets it run, and the first frame after
    change_dataset() finds it still busy. Deterministic.
  * `count_rebases(tracker)`: count the handshakes
    (Tracker._sync_imu_from_map) that rebased the last frame.
"""

import threading
import time

MAX_QUEUE, MAX_WAIT = 2, 2.0
LAG = 3     # lagged(): calls from a keyframe's to its mapping


def serialized(slam):
    """Wrap slam.track_stereo: each call flushes the worker afterwards (a
    worker error raises there)."""
    real = slam.track_stereo

    def track_stereo(*a, **kw):
        out = real(*a, **kw)
        slam.async_mapper.flush()
        return out

    slam.track_stereo = track_stereo
    return slam


def lagged(slam, lag=LAG):
    """Wrap a stereo System (see the module's docstring): a keyframe made by
    call k is mapped inside call k + lag's host extraction, or after that
    call where it extracted on the device (the call after, where that is the
    first after change_dataset()); shutdown() releases the worker."""
    gate, due, calls = threading.Event(), [None], [0]
    lm, fe, mapper = slam.local_mapper, slam.tracker.frontend, slam.async_mapper
    real_map, real_extract, real_flush = lm.on_new_keyframe, fe.process_stereo, mapper.flush
    real_track, real_change, real_shutdown = slam.track_stereo, slam.change_dataset, slam.shutdown

    def on_new_keyframe(kf, lock=None):
        gate.wait()
        return real_map(kf, lock=lock)

    def flush(*a, **kw):
        gate.set()
        try:
            return real_flush(*a, **kw)
        finally:
            gate.clear()

    def run_worker_if_due():
        if due[0] == calls[0]:
            mapper.flush()
            due[0] = None

    def process_stereo(*a, **kw):
        run_worker_if_due()
        return real_extract(*a, **kw)

    def track_stereo(*a, **kw):
        n_kf = slam.map.n_kf
        out = real_track(*a, **kw)
        run_worker_if_due()
        if slam.map.n_kf > n_kf and due[0] is None:
            due[0] = calls[0] + lag
        calls[0] += 1
        return out

    def change_dataset():
        if due[0] == calls[0]:
            due[0] += 1
        real_change()

    def shutdown():
        gate.set()
        real_shutdown()

    lm.on_new_keyframe, fe.process_stereo, mapper.flush = on_new_keyframe, process_stereo, flush
    slam.track_stereo, slam.change_dataset, slam.shutdown = track_stereo, change_dataset, shutdown
    return slam


def paced(slam):
    """Wait until the worker's queue holds at most MAX_QUEUE keyframes, or
    MAX_WAIT seconds have passed; returns the seconds waited."""
    t0 = time.perf_counter()
    while slam.async_mapper.queue.qsize() > MAX_QUEUE and time.perf_counter() - t0 < MAX_WAIT:
        time.sleep(0.02)
    return time.perf_counter() - t0


def count_rebases(tracker):
    """Wrap tracker._sync_imu_from_map to count the handshakes that rebased
    the last frame (a new pose from the map's last keyframe); returns the
    counter, a one-entry list."""
    real, n = tracker._sync_imu_from_map, [0]

    def counted():
        last = tracker.last_frame
        before = None if last is None else last.R
        real()
        if last is not None and last.R is not None and last.R is not before:
            n[0] += 1

    tracker._sync_imu_from_map = counted
    return n
