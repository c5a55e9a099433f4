"""Asynchronous local mapping: the reference's thread architecture
(port of tpuslam/parallel/async_mapping.py).

Replaces the LocalMapping/LoopClosing std::threads + queue + mMutexMapUpdate
protocol (ref: System.cc:184,198 thread spawns; LocalMapping::InsertKeyFrame
:278 queue; Map::mMutexMapUpdate held across Track(), Tracking.cc:921):

- the tracker enqueues keyframes and returns immediately;
- a worker thread drains the queue, running local mapping + loop closing
  under the map lock;
- the worker's device work (local BA, Sim3, pose graph) is enqueued on the
  same CUDA stream as the tracker's, and both threads run Python under one
  interpreter lock, so the overlap is what the host leaves between them.
"""

from __future__ import annotations

import queue
import threading
import traceback

from ..utils.verbose import print_mess


class AsyncMapper:
    """Wraps a LocalMapper (+ optional LoopCloser) behind a worker thread.

    API-compatible with the synchronous LocalMapper from the tracker's
    point of view (`on_new_keyframe`); `flush()` waits for the queue to
    drain (tests / end of sequence); `shutdown()` stops the worker.
    """

    def __init__(self, local_mapper, loop_closer=None, map_lock=None):
        self.lm = local_mapper
        self.loop_closer = loop_closer
        self.lock = map_lock if map_lock is not None else threading.RLock()
        self.queue: queue.Queue = queue.Queue()
        self.errors: list = []
        self._stop = threading.Event()
        # a queued KF interrupts the running local BA's second phase
        # (ref: mbAbortBA LocalMapping.cc:103,283)
        local_mapper.abort_check = lambda: not self.queue.empty()
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    # ------------------------------------------------------- tracker-facing
    def on_new_keyframe(self, kf: int):
        """Enqueue and return (ref: LocalMapping::InsertKeyFrame)."""
        self.queue.put(kf)

    # ---------------------------------------------------------------- worker
    def _run(self):
        while not self._stop.is_set():
            try:
                kf = self.queue.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                # stage-level locking: the mapper acquires the map lock
                # per pipeline stage so tracking's short per-frame lock
                # takes interleave with mapping instead of stalling for
                # the whole step
                self.lm.on_new_keyframe(kf, lock=self.lock)
                if self.loop_closer is not None:
                    with self.lock:
                        self.loop_closer.on_new_keyframe(kf)
            except Exception as exc:
                # surface IMMEDIATELY (a silently dead mapper looks like
                # "map stopped growing" to the tracker) and keep for
                # flush(raise_errors=True)
                print_mess("[async_mapping] worker error: "
                           + "".join(traceback.format_exception(exc)))
                self.errors.append(exc)
            finally:
                self.queue.task_done()

    # ------------------------------------------------------------- lifecycle
    def flush(self, raise_errors: bool = True):
        """Block until all queued keyframes are processed."""
        self.queue.join()
        if raise_errors and self.errors:
            raise self.errors[0]

    def idle(self) -> bool:
        return self.queue.unfinished_tasks == 0

    def shutdown(self):
        self.flush(raise_errors=False)
        self._stop.set()
        self.worker.join(timeout=5.0)
