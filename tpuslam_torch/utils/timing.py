"""Per-stage timing instrumentation (port of tpuslam/utils/timing.py).

Replaces the reference's compile-time SAVE_TIMES stopwatches
(src/Tracking.cc:311-315,406-414 writing tracking_times.txt) with an
always-on stage timer of host wall time, plus `device_trace`, a
torch.profiler trace around a region.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    """Accumulates wall-clock per named stage; one instance per engine."""

    def __init__(self):
        self.samples: dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self):
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = dict(
                n=len(a), total_s=float(a.sum()),
                mean_ms=float(a.mean() * 1e3),
                median_ms=float(np.median(a) * 1e3),
                p90_ms=float(np.percentile(a, 90) * 1e3),
            )
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':28s} {'n':>6s} {'median':>9s} {'p90':>9s} {'total':>8s}"]
        for name, s in rows:
            lines.append(
                f"{name:28s} {s['n']:6d} {s['median_ms']:8.2f}m "
                f"{s['p90_ms']:8.2f}m {s['total_s']:7.2f}s")
        return "\n".join(lines)

    def save(self, path: str):
        with open(path, "w") as fh:
            fh.write(self.report() + "\n")


GLOBAL_TIMER = StageTimer()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace (CPU and, where present, CUDA activity) around
    a region; the Chrome trace is written to log_dir/trace.json."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
