"""chip_smoke.py's phase 16 b async (the async stereo-inertial merge) on a card
with a trace of the tracker and the mapping worker around the first
session's end, where its spread came from.

    python3 scripts/trace_async_vi_merge_torch.py [--runs 2]

(from the repo root, on a CUDA card; ~6 min for two runs side by side.)
Each run is chip_smoke.phase_vi_merge(dev, smi, "b", True) in a process of
its own; for the frames stamped 2.4-3.35 s and 100-100.35 s it records, by
wall time and thread: each track call's state, reference and last keyframe
and map version before and after, the handshake's rebase of the last frame
(Tracker._sync_imu_from_map), the IMU prediction, the fused VI step's
result, the host path, the motion model and the lost handling, and each
keyframe the worker maps. It prints the phase's figures (the joint ATE and
the rows that carry it) and then the trace, one line per entry.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def _centre(R, t):
    return None if R is None else (-R.T @ t).round(3).tolist()


def traced_run(i, queue):
    import threading

    import torch

    import chip_smoke as c
    from tpuslam_torch.engine import local_mapping, tracking

    trace, t_ref, cur = [], time.perf_counter(), {"t": None}

    def note(what, **kw):
        t = cur["t"]
        if t is not None and (2.4 <= t <= 3.35 or 100.0 <= t <= 100.35):
            trace.append((round(time.perf_counter() - t_ref, 3),
                          threading.current_thread().name[:8], round(t, 2), what, kw))

    def wrap(cls, name, fn):
        real = getattr(cls, name)
        setattr(cls, name, lambda self, *a, **kw: fn(real, self, *a, **kw))

    def track(real, self, img, t, **kw):
        cur["t"] = float(t)
        note("track.start", state=self.state.name, ref=self.ref_kf, last_kf=self.last_kf,
             mv=self.map.map_version, seen=self.map_version_seen)
        out = real(self, img, t, **kw)
        note("track.end", state=self.state.name, ref=self.ref_kf, centre=_centre(out.R, out.t))
        return out

    def sync(real, self):
        last = self.last_frame
        before = None if last is None else _centre(last.R, last.t)
        out = real(self)
        note("sync", mv=self.map.map_version, last_before=before,
             last_after=None if last is None else _centre(last.R, last.t))
        return out

    def predict(real, self, frame):
        out = real(self, frame)
        note("predict_imu", centre=None if out is None else _centre(out[0], out[1]))
        return out

    def logged(name):
        def fn(real, self, *a, **kw):
            out = real(self, *a, **kw)
            note(name, res=out if isinstance(out, (bool, type(None))) else None)
            return out
        return fn

    def mapped(real, self, kf, lock=None):
        note("lm.start", kf=kf, time=float(self.map.kf_time[kf]))
        out = real(self, kf, lock=lock)
        note("lm.end", kf=kf, stage=self.viba_stage, mv=self.map.map_version)
        return out

    Tr = tracking.Tracker
    wrap(Tr, "track", track)
    wrap(Tr, "_sync_imu_from_map", sync)
    wrap(Tr, "_predict_imu", predict)
    for name in ("_track_fused_vi", "_track_host", "_track_motion_model", "_handle_lost"):
        wrap(Tr, name, logged(name))
    wrap(local_mapping.LocalMapper, "on_new_keyframe", mapped)
    try:
        out = c.phase_vi_merge(torch.device("cuda", 0), c.nvidia_smi_line(), "b", True)
        status = "ok"
    except BaseException as exc:
        out, status = None, f"error {exc!r}"
    finally:
        c.stop_render_pool()
    queue.put((i, status, out[2] if out else None, trace))


def main(argv=None):
    import multiprocessing

    import torch

    import chip_smoke as c
    from tpuslam_torch import _build, native

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_async_vi_merge_torch: no CUDA device", file=sys.stderr)
        return 1
    c.log(f"[card] {c.nvidia_smi_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build()
    _build.lib()
    if not native.available():
        print("trace_async_vi_merge_torch: the native map core did not load", file=sys.stderr)
        return 1
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=traced_run, args=(i, queue)) for i in range(args.runs)]
    for p in procs:
        p.start()
    code = 0
    for _ in procs:
        i, status, figures, trace = queue.get(timeout=1500)
        code = code or int(status != "ok")
        c.log(f"[run {i}] {status} {figures}")
        for row in trace:
            c.log(f"[trace {i}] {row}")
    for p in procs:
        p.join()
    return code


if __name__ == "__main__":
    sys.exit(main())
