"""Profile the PyTorch port's fused stereo tracking step on one CUDA card,
with each of its stereo SAD refinements (TrackingConfig.fused_sad
"pyramid", the default, and "level0") in one run.

    python scripts/profile_torch_step.py [--frames 16] [--out build/profile]

Same setup as chip_smoke.py (752x480 stereo rendered frames, 1024 ORB
features, local map of P = 2048 rows from frame 0, pose chained on the
device). Both modes track the same frames from the same local map; their
timed passes alternate (pyramid, level0, level0, pyramid), so a drift of
the card or the host falls on both. Reports, per mode and per frame over
the steady frames (the last --profiled of them traced by torch.profiler):
  - host wall time of one step that ends in torch.cuda.synchronize();
  - the device's busy time (sum of CUDA kernel and memcpy/memset time in
    the torch.profiler trace) and its idle share of the wall time;
  - the number of kernel launches, and the kernels that take the most
    device time.
Writes the Chrome traces and the full tables under --out. Needs a card.
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
    cam = Pinhole([cs.FX, cs.FY, seq.cx, seq.cy], cs.W, cs.H)
    steps = {sad: FusedTrackStep(cam, OrbConfig(n_features=cs.N_FEATURES),
                                 TrackingConfig(fused_sad=sad), cs.N_LEVELS, cs.SCALE,
                                 cs.FX * cs.BASELINE, True, device=dev)
             for sad in ("pyramid", "level0")}
    step = steps["pyramid"]                  # one local map for both modes
    f0 = step.extract(torch.tensor(frames[0], device=dev))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()}, cs.FX, cs.FY,
                             seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=cs.P_BASE)
    pose0 = np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32)
    inputs = [step_inputs_from_numpy(frames[i], *local, pose0, np.float32([60]), dev)
              for i in range(1, n)]

    def run(sad, frame_inputs, pose):
        walls = []
        for inp in frame_inputs:
            t0 = time.perf_counter()
            pose = steps[sad](*inp[:6], pose, inp[7])["pose"]
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls, pose

    warm = {sad: run(sad, inputs[: args.warmup], inputs[0][6])[1] for sad in steps}
    steady = inputs[args.warmup:]
    walls = {sad: [] for sad in steps}
    for sad in ("pyramid", "level0", "level0", "pyramid"):   # timed without the profiler
        walls[sad] += run(sad, steady, warm[sad])[0]
    traced = steady[-args.profiled:]
    os.makedirs(args.out, exist_ok=True)
    rows = {}
    for sad in steps:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_walls, _ = run(sad, traced, warm[sad])
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(traced)
        prof.export_chrome_trace(os.path.join(args.out, f"torch_step_{sad}_trace.json"))
        table = prof.key_averages().table(sort_by="device_time_total", row_limit=40)
        with open(os.path.join(args.out, f"torch_step_{sad}_profile.txt"), "w") as f:
            f.write(table)
        top = sorted(prof.key_averages(), key=lambda k: -k.device_time_total)[:12]
        print(table[:3000])
        rows[sad] = {
            "card": cs.nvidia_smi_line(),
            "sad": sad,
            "frames": len(walls[sad]),
            "frames_profiled": len(traced),
            "wall_ms_median": float(np.median(walls[sad])),
            "wall_ms_p90": float(np.percentile(walls[sad], 90)),
            "wall_ms_median_profiled": float(np.median(prof_walls)),
            "device_busy_ms_per_frame": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / float(np.mean(prof_walls))),
            "device_events_per_frame": len(events) / len(traced),
            "top_device_ms_per_frame": {k.key[:60]: k.device_time_total / 1e3 / len(traced)
                                        for k in top},
        }
        print(json.dumps(rows[sad]))
    print(json.dumps({"level0_over_pyramid": {
        k: rows["level0"][k] / rows["pyramid"][k]
        for k in ("wall_ms_median", "device_busy_ms_per_frame", "device_events_per_frame")}}))


if __name__ == "__main__":
    main()
