"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full size: 752x480, 1024 ORB features, 8
levels at scale 1.2, stereo, monocular with loop closing, and RGB-D.
Phases, each raising on failure:
  0. print the card (nvidia-smi name and power limit) and versions;
  1. build the CUDA kernels from tpuslam_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths (the pose LM at the fused step's N = 1024,
     stereo and mono, at the host tracker's shapes: 700 observations padded
     to 768, f64 inputs cast to f32, and at an RGB-D host frame's: 230
     rows with depth-derived stereo residuals padded to 256), and time both
     with CUDA events;
  3. the fused tracking step (tpuslam_torch.engine.track_device.
     FusedTrackStep) on a local map of P = 2048 rows built from frame 0:
     track frames 1..16 through the kernels (pose chained on the device,
     from frame 3 on under torch.cuda.set_sync_debug_mode("error")), check
     every pose against ground truth and against the same step run with
     the plain versions, and check the launch counters;
  4. the System (tpuslam_torch.engine.system.System.track_stereo) over 60
     frames, twice: (a) synchronous mapping and tracking, with frames
     40..49 on the host tracking path; (b) bench.py's configuration,
     async mapping + pipelined tracking, then shutdown(). Each run must end
     OK with >= 3 keyframes and > 100 map points, an unscaled ATE under
     5 cm and a Horn scale within 3 % of 1, no mapper errors, and launches
     of both kernels;
  5. System.track_monocular with a vocabulary (trained here with the
     port's train_vocabulary on frames of the same room) over the loop
     sequence of tests/test_e2e_loop.py at 752x480, its 92 frames, with
     frames 20..24 on the host tracking path: it must end OK, close at
     least one loop, end with one map, keep a scaled ATE under 5 % of the
     circumference, have no mapper errors, launch both kernels at least
     8 / 4 times per fused dispatch and the pose LM on the host path; a
     second-lap frame it never saw must relocalize through BoW + PnP on a
     first-lap keyframe, within 20 cm and 3 degrees of ground truth after
     the scaled alignment;
  6. System.track_rgbd over 40 frames of rendered image + exact depth:
     OK, unscaled ATE under 5 cm, Horn scale within 3 % of 1, a pose-LM
     launch on every frame (RGB-D frames take the host path), patch-gather
     launches.
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
N_FRAMES = 17          # phase 3: frame 0 builds the map, 1..16 are tracked
SYNC_CHECK_FROM = 3
N_TIMED = 50
N_SYSTEM = 60          # phase 4: frames per System run
HOST_PATH = range(40, 50)  # phase 4 (a): frames tracked by the host path
WARMUP = 5             # phases 4-6: frames left out of the per-frame times
N_LOOP = 92            # phase 5: the loop sequence of tests/test_e2e_loop.py
LOOP_HOST_PATH = range(20, 25)  # phase 5: frames tracked by the host path
CIRCUMFERENCE = 2 * np.pi * 1.6
N_RGBD = 40            # phase 6


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
        if not stereo:
            # the mono fused step's shape: N = 1024, every row monocular
            ms_mono = median_ms(lambda: pose_opt_cuda.pose_optimize_fused(*args))
            plain_ms_mono = median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args), n=10)
            log(f"[kernels] pose LM N=1024 mono (the mono fused step's shape): kernel "
                f"{ms_mono:.4f} ms, plain {plain_ms_mono:.4f} ms (median of {N_TIMED} and 10)")
    ms = median_ms(lambda: pose_opt_cuda.pose_optimize_fused(*args))
    plain_ms = median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args))
    log(f"[kernels] pose LM N=1024, 4 rounds x 10 iters (stereo): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (median of {N_TIMED})")

    # -- pose LM at the host tracker's shapes (Tracker._pose_opt): 700
    # observations from f64 numpy, padded with invalid rows to 768, cast
    # to f32 by the dispatcher
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    rng = np.random.RandomState(2)
    n, nb = 700, 768
    cx, cy = W / 2.0, H / 2.0
    bf = FX * BASELINE
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 2], -1)
    u = FX * X[:, 0] / X[:, 2] + cx
    v = FY * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3) * 0.3
    uvr[:70] += rng.randn(70, 3) * 40
    is_st = np.zeros(nb, bool)
    is_st[: n // 2] = True
    valid = np.zeros(nb, bool)
    valid[:n] = True
    pad = ((0, nb - n), (0, 0))
    dR, dt = _se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.015, 0.01], dtype=torch.float64))
    inv_s2 = SCALE ** (-2.0 * rng.randint(0, N_LEVELS, n))
    f64 = [dR, dt, torch.tensor(np.pad(X, pad)), torch.tensor(np.pad(uvr, pad)),
           torch.tensor(np.pad(inv_s2, (0, nb - n)))]
    args = [a.to(dev) for a in f64] + [torch.tensor(is_st, device=dev),
                                       torch.tensor(valid, device=dev), FX, FY, cx, cy, bf]
    before = pose_opt_cuda.counter.launches
    Rk, tk, ik, _ = pose_optimize_best(*args)
    check(pose_opt_cuda.counter.launches == before + 1, "host-shape solve did not launch")
    args32 = [a.to(torch.float32).contiguous() for a in args[:5]] + args[5:]
    Rp, tp, ip, _ = pose_opt_cuda.pose_optimize_plain(*args32)
    torch.cuda.synchronize()
    eR = float((Rk - Rp).abs().max())
    et = float((tk - tp).abs().max())
    agree = float((ik == ip).float().mean())
    log(f"[kernels] pose LM host shapes (N = {n} padded to {nb}, f64 -> f32): |dR| {eR:.3g} "
        f"|dt| {et:.3g} inlier agreement {agree:.4f}, padded rows inliers "
        f"{int(ik[n:].sum())}")
    check(eR <= 1e-4 and et <= 1e-3 and agree >= 0.99 and not bool(ik[n:].any()),
          "pose LM kernel vs plain out of tolerance at the host shapes")
    worst = max(worst, eR, et)
    ms_h = median_ms(lambda: pose_optimize_best(*args))
    plain_ms_h = median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args32), n=10)
    log(f"[kernels] pose LM N={nb} host shapes: kernel {ms_h:.4f} ms (cast included), "
        f"plain {plain_ms_h:.4f} ms (median of {N_TIMED} and 10)")

    # -- pose LM at an RGB-D host frame's shapes (Tracker._pose_opt on
    # track_rgbd): 230 matches, stereo rows from the depth map's virtual
    # right coordinate u - bf / z, padded to 256
    rng = np.random.RandomState(3)
    n, nb = 230, 256
    bf = FX * 0.08
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 1], -1)
    u = FX * X[:, 0] / X[:, 2] + cx
    v = FY * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3) * 0.3
    uvr[:23] += rng.randn(23, 3) * 40
    is_st = np.zeros(nb, bool)
    is_st[:n] = True
    valid = np.zeros(nb, bool)
    valid[:n] = True
    pad = ((0, nb - n), (0, 0))
    inv_s2 = SCALE ** (-2.0 * rng.randint(0, N_LEVELS, n))
    f64 = [dR, dt, torch.tensor(np.pad(X, pad)), torch.tensor(np.pad(uvr, pad)),
           torch.tensor(np.pad(inv_s2, (0, nb - n)))]
    args = [a.to(dev) for a in f64] + [torch.tensor(is_st, device=dev),
                                       torch.tensor(valid, device=dev), FX, FY, cx, cy, bf]
    before = pose_opt_cuda.counter.launches
    Rk, tk, ik, _ = pose_optimize_best(*args)
    check(pose_opt_cuda.counter.launches == before + 1, "RGB-D host-shape solve did not launch")
    args32 = [a.to(torch.float32).contiguous() for a in args[:5]] + args[5:]
    Rp, tp, ip, _ = pose_opt_cuda.pose_optimize_plain(*args32)
    torch.cuda.synchronize()
    eR = float((Rk - Rp).abs().max())
    et = float((tk - tp).abs().max())
    agree = float((ik == ip).float().mean())
    log(f"[kernels] pose LM RGB-D host shapes (N = {n} depth-derived stereo rows padded to "
        f"{nb}, f64 -> f32): |dR| {eR:.3g} |dt| {et:.3g} inlier agreement {agree:.4f}, padded "
        f"rows inliers {int(ik[n:].sum())}")
    check(eR <= 1e-4 and et <= 1e-3 and agree >= 0.99 and not bool(ik[n:].any()),
          "pose LM kernel vs plain out of tolerance at the RGB-D host shapes")
    worst = max(worst, eR, et)
    ms_r = median_ms(lambda: pose_optimize_best(*args))
    plain_ms_r = median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args32), n=10)
    log(f"[kernels] pose LM N={nb} RGB-D host shapes: kernel {ms_r:.4f} ms (cast included), "
        f"plain {plain_ms_r:.4f} ms (median of {N_TIMED} and 10)")
    records.append(dict(name="pose_lm", route="cuda",
                        source="tpuslam_torch/csrc/pose_opt.cu",
                        replaces="tpuslam/solve/pose_opt_pallas.py:317",
                        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                        mono_ms=ms_mono, mono_plain_ms=plain_ms_mono,
                        host_shapes_ms=ms_h, host_shapes_plain_ms=plain_ms_h,
                        rgbd_host_ms=ms_r, rgbd_host_plain_ms=plain_ms_r))
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


def phase_slice(dev, seq, all_frames):
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
    from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
    from tpuslam_torch.map.local_map import stereo_local_map
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda

    frames = [np.stack(f) for f in all_frames[:N_FRAMES]]
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


def horn_align(est, gt, with_scale):
    """Horn alignment of est onto gt (the protocol of
    tpuslam/eval/ate.py): R, t, s with gt ~ s * R @ est + t."""
    mc, dc = est - est.mean(0), gt - gt.mean(0)
    U, S, Vt = np.linalg.svd(mc.T @ dc)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T
    s = float(np.trace(np.diag(S) @ D) / (mc ** 2).sum()) if with_scale else 1.0
    return R, gt.mean(0) - s * R @ est.mean(0), s


def ate(est, gt, with_scale):
    """RMSE of the positions after Horn alignment of est onto gt and the
    alignment's scale."""
    R, t, s = horn_align(est, gt, with_scale)
    res = s * est @ R.T + t - gt
    return float(np.sqrt((res ** 2).sum(1).mean())), s


def phase_system(dev, seq, frames, smi):
    """System.track_stereo over N_SYSTEM frames, synchronous then
    async + pipelined; returns the launch counts of each run."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    cam = Pinhole([FX, FY, seq.cx, seq.cy], W, H)
    counts = {}
    for name, asyn in (("a_sync", False), ("b_async_pipelined", True)):
        cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                         tracking=TrackingConfig(min_stereo_init_features=200, pipelined=asyn))
        slam = System(cam, cfg, bf=FX * BASELINE, async_mapping=asyn, device=dev)
        GLOBAL_TIMER.samples.clear()
        patch_cuda.counter.launches = 0
        pose_opt_cuda.counter.launches = 0
        wall = []
        for i in range(N_SYSTEM):
            if not asyn:
                slam.tracker.fused_enabled = i not in HOST_PATH
            t0 = time.perf_counter()
            slam.track_stereo(frames[i][0], frames[i][1], i / seq.fps)
            wall.append((time.perf_counter() - t0) * 1e3)
        slam.shutdown()
        torch.cuda.synchronize()
        launches = {"patch_gather": patch_cuda.counter.launches,
                    "pose_lm": pose_opt_cuda.counter.launches}
        n_fused = len(GLOBAL_TIMER.samples.get("fused.dispatch", []))
        errors = slam.async_mapper.errors if slam.async_mapper is not None else []
        m = slam.map
        n_kf = len(m.valid_kf_ids())
        n_mp = int(m.mp_valid[: m.n_mp].sum())
        traj = slam.trajectory_tum()
        est = np.array([r[1:4] for r in traj])
        gt = gt_centers(seq, traj)
        rmse, _ = ate(est, gt, False)
        _, scale = ate(est, gt, True)
        steady = np.array(wall[WARMUP:])
        log(f"[system {name}] state {slam.get_tracking_state().name}, {n_kf} KFs, {n_mp} map "
            f"points, {len(traj)} trajectory rows, ATE {rmse * 100:.3f} cm, Horn scale "
            f"{scale:.5f}, mapper errors {len(errors)}")
        log(f"[system {name}] track_stereo wall ms over frames {WARMUP}..{N_SYSTEM - 1}: "
            f"median {np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max "
            f"{steady.max():.3f}; first frame {wall[0]:.1f} ms; card {smi}")
        stage_table(f"system {name}", GLOBAL_TIMER)
        log(f"[system {name}] launches {launches}; pose LM split: fused step "
            f"{4 * n_fused} ({n_fused} dispatches x 4), host path "
            f"{launches['pose_lm'] - 4 * n_fused}")
        check(slam.get_tracking_state() == State.OK, f"{name}: final state not OK")
        check(n_kf >= 3 and n_mp > 100, f"{name}: {n_kf} KFs / {n_mp} points")
        check(len(traj) >= N_SYSTEM - 2 and np.isfinite(est).all(), f"{name}: trajectory")
        check(rmse < 0.05 and abs(scale - 1.0) < 0.03, f"{name}: ATE {rmse} scale {scale}")
        check(not errors, f"{name}: mapper errors {errors}")
        check(launches["patch_gather"] > 0 and launches["pose_lm"] > 0,
              f"{name}: a kernel was never launched: {launches}")
        check(launches["patch_gather"] >= 16 * n_fused and launches["pose_lm"] >= 4 * n_fused,
              f"{name}: fewer launches than fused dispatches")
        if not asyn:
            check(launches["pose_lm"] > 4 * n_fused, "a_sync: the host path ran no pose LM")
        counts[name] = launches
    return counts


def stage_table(name, timer):
    """Per-stage host wall times of one run (utils/timing.GLOBAL_TIMER)."""
    for stage, st in sorted(timer.summary().items(), key=lambda kv: -kv[1]["total_s"]):
        log(f"[{name}] stage {stage:16s} n {st['n']:3d} median {st['median_ms']:9.3f} ms p90 "
            f"{st['p90_ms']:9.3f} ms max {max(timer.samples[stage]) * 1e3:9.1f} ms total "
            f"{st['total_s'] * 1e3:10.1f} ms")


def gt_centers(seq, traj):
    return np.array([-seq.gt_pose_cw(r[0])[0].T @ seq.gt_pose_cw(r[0])[1] for r in traj])


def phase_mono_loop(dev, smi):
    """System.track_monocular with a vocabulary over the loop sequence of
    tests/test_e2e_loop.py, at full width; returns the launch counts."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.frontend import Frontend
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import Frame, State
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.place import train_vocabulary
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    seq = SyntheticSequence(n_frames=N_LOOP, fps=8, speed=1.0, kind="loop", height=H, width=W,
                            fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = [u8(seq.frame(i)) for i in range(N_LOOP)]
    log(f"[mono_loop] rendered {N_LOOP} frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host)")
    cam = Pinhole([FX, FY, seq.cx, seq.cy], W, H)
    # tests/test_e2e_loop.py's configuration, its pixel radii (the
    # motion-model radius and the two-view init window) scaled by the
    # width ratio
    cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                     tracking=TrackingConfig(max_frames_between_kf=4, min_matches_init=60,
                                             motion_model_radius=25.0 * W / 376.0,
                                             init_window=100.0 * W / 376.0,
                                             time_recently_lost=2.0),
                     loop=LoopConfig(min_proj_matches=35, min_bow_matches=15))
    fe = Frontend(cam, cfg.orb, device=dev)
    t0 = time.perf_counter()
    descs = []
    for i in (0, 10, 20, 30):
        f = fe.process(frames[i])
        descs.append(f.bits[f.valid])
    vocab = train_vocabulary(np.concatenate(descs), k=8, L=3, iters=5, device=dev)
    log(f"[mono_loop] vocabulary k=8 L=3 ({vocab.n_words} words) trained on "
        f"{sum(map(len, descs))} descriptors in {time.perf_counter() - t0:.1f} s")
    slam = System(cam, cfg, sensor=Sensor.MONOCULAR, vocab=vocab, device=dev)
    GLOBAL_TIMER.samples.clear()
    patch_cuda.counter.launches = 0
    pose_opt_cuda.counter.launches = 0
    wall = []
    for i, t in enumerate(seq.timestamps()):
        slam.tracker.fused_enabled = i not in LOOP_HOST_PATH
        t1 = time.perf_counter()
        slam.track_monocular(frames[i], t)
        wall.append((time.perf_counter() - t1) * 1e3)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = {"patch_gather": patch_cuda.counter.launches,
                "pose_lm": pose_opt_cuda.counter.launches}
    n_fused = len(GLOBAL_TIMER.samples.get("fused.dispatch", []))
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    rmse, _ = ate(est, gt_centers(seq, traj), True)
    steady = np.array(wall[WARMUP:])
    lc = slam.loop_closer
    log(f"[mono_loop] state {slam.get_tracking_state().name}, {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, loops closed {lc.n_loops_closed}, maps "
        f"{list(m.map_ids())}, {len(traj)} trajectory rows, scaled ATE {rmse:.5f} (limit "
        f"{0.05 * CIRCUMFERENCE:.5f})")
    log(f"[mono_loop] track_monocular wall ms over frames {WARMUP}..{N_LOOP - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"card {smi}")
    stage_table("mono_loop", GLOBAL_TIMER)
    slow = int(np.argmax(wall))
    log(f"[mono_loop] slowest frame {slow}: {wall[slow]:.1f} ms")
    log(f"[mono_loop] launches {launches}; fused dispatches {n_fused}; pose LM on the host path "
        f"{launches['pose_lm'] - 4 * n_fused}")
    check(slam.get_tracking_state() == State.OK, "mono_loop: final state not OK")
    check(lc.n_loops_closed >= 1, "mono_loop: no loop closed")
    check(len(m.map_ids()) == 1, f"mono_loop: {len(m.map_ids())} maps after shutdown")
    check(len(traj) >= N_LOOP - 20 and np.isfinite(est).all(), "mono_loop: trajectory")
    check(rmse < 0.05 * CIRCUMFERENCE, f"mono_loop: scaled ATE {rmse}")
    check(m.check_essential_graph() == [], "mono_loop: spanning tree broken")
    check(n_fused > 0 and launches["patch_gather"] >= 8 * n_fused
          and launches["pose_lm"] >= 4 * n_fused, "mono_loop: fewer launches than dispatches")
    check(launches["pose_lm"] > 4 * n_fused, "mono_loop: the host path ran no pose LM")
    # a second-lap frame the System never saw (5 s past the run's end)
    # relocalizes by BoW + PnP + pose LM on a keyframe of the first lap;
    # mono map units are arbitrary, so its pose is held against ground
    # truth after the run's trajectory is Sim3-aligned onto it
    lap_s = CIRCUMFERENCE / seq.traj.speed
    i = N_LOOP + 40
    t = i / seq.fps
    frame = Frame(fe.process(u8(seq.frame(i))), t, 10_000 + i)
    ok = slam.tracker._relocalize_bow(frame)
    kf = slam.tracker.ref_kf
    R, tt, s = horn_align(est, gt_centers(seq, traj), True)
    Rcw, tcw = seq.gt_pose_cw(t)
    err = float(np.linalg.norm(s * R @ (-frame.R.T @ frame.t) + tt + Rcw.T @ tcw)) if ok else -1.0
    ang = float(np.degrees(np.arccos(np.clip((np.trace(R @ frame.R.T @ Rcw) - 1) / 2, -1, 1)))) \
        if ok else -1.0
    log(f"[mono_loop] BoW relocalization of unseen frame {i} (t {t:.3f} s, second lap): {ok}, "
        f"keyframe {kf} (t {m.kf_time[kf]:.3f} s), {slam.tracker.n_inliers} inliers, "
        f"{err * 100:.3f} cm and {ang:.3f} deg from ground truth after the scaled alignment")
    check(ok and slam.tracker.n_inliers >= 15 and m.kf_valid[kf] and m.kf_time[kf] < lap_s
          and err < 0.20 and ang < 3.0, "mono_loop: BoW relocalization on the first lap failed")
    return launches


def phase_rgbd(dev, smi):
    """System.track_rgbd over N_RGBD rendered frames with exact depth."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    seq = SyntheticSequence(n_frames=N_RGBD, fps=10, speed=0.5, height=H, width=W, fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = [seq.frame_rgbd(i) for i in range(N_RGBD)]
    frames = [(u8(img), depth) for img, depth in frames]
    log(f"[rgbd] rendered {N_RGBD} image + depth frames {W}x{H} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                     tracking=TrackingConfig(min_stereo_init_features=200))
    slam = System(Pinhole([FX, FY, seq.cx, seq.cy], W, H), cfg, sensor=Sensor.RGBD,
                  bf=FX * 0.08, device=dev)
    GLOBAL_TIMER.samples.clear()
    patch_cuda.counter.launches = 0
    pose_opt_cuda.counter.launches = 0
    wall, per_frame = [], []
    for i, t in enumerate(seq.timestamps()):
        before = pose_opt_cuda.counter.launches
        t1 = time.perf_counter()
        slam.track_rgbd(*frames[i], t)
        wall.append((time.perf_counter() - t1) * 1e3)
        per_frame.append(pose_opt_cuda.counter.launches - before)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = {"patch_gather": patch_cuda.counter.launches,
                "pose_lm": pose_opt_cuda.counter.launches}
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = gt_centers(seq, traj)
    rmse, _ = ate(est, gt, False)
    _, scale = ate(est, gt, True)
    steady = np.array(wall[WARMUP:])
    log(f"[rgbd] state {slam.get_tracking_state().name}, {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, {len(traj)} trajectory rows, ATE "
        f"{rmse * 100:.3f} cm, Horn scale {scale:.5f}")
    log(f"[rgbd] track_rgbd wall ms over frames {WARMUP}..{N_RGBD - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"card {smi}")
    stage_table("rgbd", GLOBAL_TIMER)
    log(f"[rgbd] launches {launches}; pose LM launches per frame after init: "
        f"min {min(per_frame[1:])}, median {int(np.median(per_frame[1:]))}")
    check(slam.get_tracking_state() == State.OK, "rgbd: final state not OK")
    check(len(traj) >= N_RGBD - 2 and np.isfinite(est).all(), "rgbd: trajectory")
    check(rmse < 0.05 and abs(scale - 1.0) < 0.03, f"rgbd: ATE {rmse} scale {scale}")
    check(min(per_frame[1:]) > 0, "rgbd: a frame without a pose-LM launch")
    check(launches["patch_gather"] > 0, "rgbd: the patch gather was never launched")
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

    seq = SyntheticSequence(n_frames=N_SYSTEM, fps=20, speed=0.5, baseline=BASELINE,
                            height=H, width=W, fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = [(u8(seq.frame(i)), u8(seq.frame(i, right=True))) for i in range(N_SYSTEM)]
    log(f"[render] {N_SYSTEM} stereo frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host)")
    records = phase_kernels(dev, seq)
    by_path = {"fused_step": phase_slice(dev, seq, frames)}
    by_path.update(phase_system(dev, seq, frames, smi))
    del frames
    by_path["mono_loop"] = phase_mono_loop(dev, smi)
    by_path["rgbd"] = phase_rgbd(dev, smi)
    for r in records:
        r["launches"] = sum(c[r["name"]] for c in by_path.values())
        r["launches_by_path"] = {k: c[r["name"]] for k, c in by_path.items()}
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
