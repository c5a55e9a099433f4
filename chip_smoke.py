"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the fused stereo tracking step
(tpuslam_torch.engine.track_device.FusedTrackStep), at full size:
752x480 stereo, 1024 ORB features, 8 levels at scale 1.2, a local map of
P = 2048 rows. Phases, each raising on failure:
  0. print the card (nvidia-smi name and power limit) and versions;
  1. build the CUDA kernels from tpuslam_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main path, and time both with CUDA events;
  3. render 17 stereo frames, build the local map from frame 0, track
     frames 1..16 through the kernels (pose chained on the device, from
     frame 3 on under torch.cuda.set_sync_debug_mode("error")), check every
     pose against ground truth and against the same step run with the
     plain versions, and check the launch counters.
The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Needs one CUDA card; fails without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 480, 752
N_FEATURES = 1024
P_BASE = 2048
N_LEVELS, SCALE = 8, 1.2
FX = FY = 458.0
BASELINE = 0.11
N_FRAMES = 17          # frame 0 builds the map, 1..16 are tracked
SYNC_CHECK_FROM = 3
N_TIMED = 50


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, n=N_TIMED, warmup=3):
    """Median of n timed calls of fn(), each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def u8(im):
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_kernels(dev, seq):
    """Kernel vs plain version on the card at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.engine.config import OrbConfig
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.ops.fast import _border_mask, cell_threshold_gate, fast_score, nms3x3
    from tpuslam_torch.ops.image import build_pyramid, gaussian_blur, gaussian_kernel1d
    from tpuslam_torch.ops.orb import DESC_R, HALF_PATCH, PAD, _select_level_keypoints
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.solve.pose_opt_cuda import _se3_exp

    records = []
    # -- patch gather: real padded blurred levels of a rendered frame
    cfg = OrbConfig(n_features=N_FEATURES)
    img = torch.tensor(u8(seq.frame(0)), device=dev).float()
    taps = torch.tensor(gaussian_kernel1d(), device=dev)
    calls = []
    for im, budget in zip(build_pyramid(img, cfg.n_levels, cfg.scale), cfg.level_budgets()):
        score = nms3x3(cell_threshold_gate(fast_score(im), cfg.ini_th, cfg.min_th, cfg.th_cell))
        h, w = im.shape
        score = torch.where(_border_mask(h, w, HALF_PATCH + 1, dev), score, 0.0)
        xy, _ = _select_level_keypoints(score, budget, cfg.cell)
        pad_blur = F.pad(gaussian_blur(im, taps)[None, None], (PAD,) * 4,
                         mode="replicate")[0, 0].contiguous()
        yx = (torch.stack([xy[:, 1], xy[:, 0]], -1) + (PAD - DESC_R)).contiguous()
        calls.append((pad_blur, yx))
    size = 2 * DESC_R + 1
    err = 0.0
    for (im, yx), budget in zip(calls, cfg.level_budgets()):
        got = patch_cuda.extract_patches(im, yx, size)
        ref = patch_cuda.extract_patches_plain(im, yx, size)
        torch.cuda.synchronize()
        check(got.shape == (budget, size, size), f"patch shape {tuple(got.shape)}")
        check(torch.equal(got, ref), "patch gather differs from its plain version")
        err = max(err, float((got - ref).abs().max()))
    ms = median_ms(lambda: [patch_cuda.extract_patches(im, yx, size) for im, yx in calls])
    plain_ms = median_ms(lambda: [patch_cuda.extract_patches_plain(im, yx, size)
                                  for im, yx in calls])
    log(f"[kernels] patch gather: bitwise equal on {len(calls)} levels "
        f"(K={cfg.level_budgets()}); 8 launches (one image): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of {N_TIMED})")
    records.append(dict(name="patch_gather", route="cuda",
                        source="tpuslam_torch/csrc/patch.cu",
                        replaces="tpuslam/ops/patch_pallas.py:88",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # -- pose LM: seeded mono and stereo problems, 10% gross outliers
    worst = 0.0
    for stereo in (False, True):
        rng = np.random.RandomState(1 if stereo else 0)
        n, n_out = 1024, 102
        cx, cy = W / 2.0, H / 2.0
        bf = FX * BASELINE if stereo else 0.0
        X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 2], -1).astype(np.float32)
        u = FX * X[:, 0] / X[:, 2] + cx
        v = FY * X[:, 1] / X[:, 2] + cy
        uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3) * 0.3
        uvr[:n_out] += rng.randn(n_out, 3) * 40
        is_st = np.zeros(n, bool)
        if stereo:
            is_st[: n // 2] = True
        dR, dt = _se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.015, 0.01]))
        args = [dR.contiguous(), dt.contiguous(), torch.tensor(X), torch.tensor(uvr, dtype=torch.float32),
                torch.ones(n), torch.tensor(is_st), torch.ones(n, dtype=torch.bool)]
        args = [a.to(dev) for a in args] + [FX, FY, cx, cy, bf]
        Rk, tk, ik, ck = pose_opt_cuda.pose_optimize_fused(*args)
        Rp, tp, ip, cp = pose_opt_cuda.pose_optimize_plain(*args)
        torch.cuda.synchronize()
        eR = float((Rk - Rp).abs().max())
        et = float((tk - tp).abs().max())
        agree = float((ik == ip).float().mean())
        log(f"[kernels] pose LM {'stereo' if stereo else 'mono'}: |dR| {eR:.3g} "
            f"|dt| {et:.3g} inlier agreement {agree:.4f}; |R-I| "
            f"{float((Rk - torch.eye(3, device=dev)).abs().max()):.3g} |t| {float(tk.abs().max()):.3g}")
        check(eR <= 1e-4 and et <= 1e-3 and agree >= 0.99, "pose LM kernel vs plain out of tolerance")
        check(bool(torch.isfinite(ck).all()), "non-finite chi2")
        worst = max(worst, eR, et)
    ms = median_ms(lambda: pose_opt_cuda.pose_optimize_fused(*args))
    plain_ms = median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args))
    log(f"[kernels] pose LM N=1024, 4 rounds x 10 iters (stereo): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of {N_TIMED})")
    records.append(dict(name="pose_lm", route="cuda",
                        source="tpuslam_torch/csrc/pose_opt.cu",
                        replaces="tpuslam/solve/pose_opt_pallas.py:317",
                        max_abs_err=worst, ms=ms, plain_ms=plain_ms))
    return records


class plain_path:
    """Run the step with the kernels' plain versions on the card."""

    def __enter__(self):
        from tpuslam_torch.engine import track_device
        from tpuslam_torch.ops import orb, patch_cuda
        from tpuslam_torch.solve import pose_opt_cuda

        self.saved = (orb.extract_patches, track_device.pose_optimize_fused)
        orb.extract_patches = patch_cuda.extract_patches_plain
        track_device.pose_optimize_fused = pose_opt_cuda.pose_optimize_plain
        return self

    def __exit__(self, *exc):
        from tpuslam_torch.engine import track_device
        from tpuslam_torch.ops import orb

        orb.extract_patches, track_device.pose_optimize_fused = self.saved


def rot_err_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def phase_slice(dev, seq):
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
    from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
    from tpuslam_torch.map.local_map import stereo_local_map
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda

    t0 = time.perf_counter()
    frames = [np.stack([u8(seq.frame(i)), u8(seq.frame(i, right=True))])
              for i in range(N_FRAMES)]
    log(f"[slice] rendered {N_FRAMES} stereo frames {W}x{H} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    cam = Pinhole([FX, FY, seq.cx, seq.cy], W, H)
    bf = FX * BASELINE
    step = FusedTrackStep(cam, OrbConfig(n_features=N_FEATURES), TrackingConfig(),
                          N_LEVELS, SCALE, bf, True, device=dev)
    f0 = step.extract(torch.tensor(frames[0], device=dev))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()},
                             FX, FY, seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=P_BASE)
    n_rows = int(local[2].sum())
    log(f"[slice] local map from frame 0: {n_rows} points, P bucket {local[0].shape[0]}")
    check(local[0].shape[0] == P_BASE, "local map does not fill the P=2048 bucket")
    pose0 = np.concatenate([np.eye(3).ravel(), np.zeros(4)]).astype(np.float32)
    min_req2 = np.float32([2 * TrackingConfig().min_inliers_local])
    inputs = [step_inputs_from_numpy(frames[i], *local, pose0, min_req2, dev)
              for i in range(1, N_FRAMES)]
    torch.cuda.synchronize()

    def run(path_step, pose_ins=None):
        outs, pins, times = [], [], []
        pose = inputs[0][6]
        for k, inp in enumerate(inputs):
            if pose_ins is not None:
                pose = pose_ins[k]
            pins.append(pose)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            sync_check = pose_ins is None and k + 1 >= SYNC_CHECK_FROM
            if sync_check:
                torch.cuda.set_sync_debug_mode("error")
            a.record()
            out = path_step(*inp[:6], pose, inp[7])
            b.record()
            if sync_check:
                torch.cuda.set_sync_debug_mode("default")
            outs.append(out)
            times.append((a, b))
            pose = out["pose"]
        torch.cuda.synchronize()
        return outs, pins, [a.elapsed_time(b) for a, b in times]

    patch_cuda.counter.launches = 0
    pose_opt_cuda.counter.launches = 0
    outs, pose_ins, ms_k = run(step)
    launches = {"patch_gather": patch_cuda.counter.launches,
                "pose_lm": pose_opt_cuda.counter.launches}
    n = len(inputs)
    log(f"[slice] kernel launches over {n} frames: {launches}")
    check(launches == {"patch_gather": 16 * n, "pose_lm": 4 * n},
          f"launch counters {launches} != 16/4 per frame")
    with plain_path():
        outs_p, _, ms_p = run(step, pose_ins)
    check(patch_cuda.counter.launches == launches["patch_gather"]
          and pose_opt_cuda.counter.launches == launches["pose_lm"],
          "plain path launched a kernel")

    Rw0, tw0 = seq.gt_pose_cw(0.0)
    for k, (o, op) in enumerate(zip(outs, outs_p)):
        i = k + 1
        pose = o["pose"].cpu().numpy()
        check(o["pose"].shape == (13,) and np.isfinite(pose).all(), "bad pose output")
        check(o["assoc"].shape == (N_FEATURES,) and o["rowflags"].shape == (2 * P_BASE,),
              "bad output shapes")
        R, t = pose[:9].reshape(3, 3).astype(np.float64), pose[9:12].astype(np.float64)
        Rg, tg = seq.gt_pose_cw(i / seq.fps)
        Rrel = Rg @ Rw0.T
        trel = tg - Rrel @ tw0
        e_t = float(np.linalg.norm(t - trel))
        e_r = rot_err_deg(R, Rrel)
        pp = op["pose"].cpu().numpy()
        dR = float(np.abs(pp[:9] - pose[:9]).max())
        dt = float(np.abs(pp[9:12] - pose[9:12]).max())
        agree = float((o["assoc"] == op["assoc"]).float().mean())
        n_inl = int(pose[12])
        log(f"[slice] frame {i:2d}: |t err| {e_t * 100:.3f} cm, R err {e_r:.4f} deg, "
            f"inliers {n_inl}, vs plain |dR| {dR:.2e} |dt| {dt:.2e} assoc {agree:.4f}, "
            f"{ms_k[k]:.3f} ms (kernels) {ms_p[k]:.3f} ms (plain)")
        check(e_t < 0.05 and e_r < 1.0, f"frame {i}: pose off ground truth")
        check(n_inl >= 50, f"frame {i}: only {n_inl} inliers")
        check(dR <= 5e-4 and dt <= 5e-3 and agree >= 0.95,
              f"frame {i}: kernel path differs from the plain path")
    log(f"[slice] median ms/frame over {n} frames (CUDA events, first frames include "
        f"warm-up): kernels {np.median(ms_k):.3f}, plain {np.median(ms_p):.3f}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpuslam_torch import _build
    from tpuslam_torch.io.synthetic import SyntheticSequence

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"[build] kernels built/loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    seq = SyntheticSequence(n_frames=N_FRAMES, fps=20, speed=0.5, baseline=BASELINE,
                            height=H, width=W, fx=FX, fy=FY)
    records = phase_kernels(dev, seq)
    launches = phase_slice(dev, seq)
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
