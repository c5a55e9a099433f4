"""Profile the PyTorch port's fused stereo tracking step on one CUDA card.

    python scripts/profile_torch_step.py [--frames 16] [--out build/profile]

Same setup as chip_smoke.py (752x480 stereo rendered frames, 1024 ORB
features, local map of P = 2048 rows from frame 0, pose chained on the
device). Reports, per frame over the steady frames (the last --profiled of them
traced by torch.profiler):
  - host wall time of one step that ends in torch.cuda.synchronize();
  - the device's busy time (sum of CUDA kernel and memcpy/memset time in
    the torch.profiler trace) and its idle share of the wall time;
  - the number of kernel launches, and the kernels that take the most
    device time.
Writes the Chrome trace and the full table under --out. Needs a card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--profiled", type=int, default=3, help="frames traced by the profiler")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    import chip_smoke as cs
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
    from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.map.local_map import stereo_local_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n = args.frames + 1
    seq = SyntheticSequence(n_frames=n, fps=20, speed=0.5, baseline=cs.BASELINE,
                            height=cs.H, width=cs.W, fx=cs.FX, fy=cs.FY)
    frames = [np.stack([cs.u8(seq.frame(i)), cs.u8(seq.frame(i, right=True))])
              for i in range(n)]
    step = FusedTrackStep(Pinhole([cs.FX, cs.FY, seq.cx, seq.cy], cs.W, cs.H),
                          OrbConfig(n_features=cs.N_FEATURES), TrackingConfig(),
                          cs.N_LEVELS, cs.SCALE, cs.FX * cs.BASELINE, True, device=dev)
    f0 = step.extract(torch.tensor(frames[0], device=dev))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()}, cs.FX, cs.FY,
                             seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=cs.P_BASE)
    pose0 = np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32)
    inputs = [step_inputs_from_numpy(frames[i], *local, pose0, np.float32([60]), dev)
              for i in range(1, n)]

    def run(frame_inputs, pose):
        walls = []
        for inp in frame_inputs:
            t0 = time.perf_counter()
            pose = step(*inp[:6], pose, inp[7])["pose"]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls, pose

    _, pose = run(inputs[: args.warmup], inputs[0][6])
    steady = inputs[args.warmup:]
    walls, _ = run(steady, pose)             # timed without the profiler
    traced = steady[-args.profiled:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_walls, _ = run(traced, pose)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(traced)
    n_kernels = len(events) / len(traced)
    wall = float(np.median(walls))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "torch_step_trace.json"))
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=40)
    with open(os.path.join(args.out, "torch_step_profile.txt"), "w") as f:
        f.write(table)
    top = sorted(prof.key_averages(), key=lambda k: -k.device_time_total)[:12]
    print(table[:6000])
    print(json.dumps({
        "card": cs.nvidia_smi_line(),
        "frames": len(steady),
        "frames_profiled": len(traced),
        "wall_ms_median": wall,
        "wall_ms_p90": float(np.percentile(walls, 90)),
        "wall_ms_median_profiled": float(np.median(prof_walls)),
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / float(np.mean(prof_walls))),
        "device_events_per_frame": n_kernels,
        "top_device_ms_per_frame": {k.key[:60]: k.device_time_total / 1e3 / len(traced)
                                    for k in top},
    }))


if __name__ == "__main__":
    main()
