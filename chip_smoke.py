"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full size: 752x480, 1024 ORB features, 8
levels at scale 1.2, stereo, monocular with loop closing, RGB-D,
mono-inertial, fisheye stereo, the dataset CLI, the distributed BA and the
measuring tools.
Phases, each raising on failure:
  0. print the card (nvidia-smi name and power limit) and versions;
  1. build the CUDA kernels from tpuslam_torch/csrc (one nvcc per source,
     all at once) and the native map core; the pose LM kernel must show no
     stack frame and no spill in ptxas's report, the native core must load;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths: the patch gather over the 8 real levels
     of a rendered image in one launch (bitwise, and against the unfold
     library call); the pose LM at the fused step's N = 1024, stereo and
     mono, at the host tracker's shapes (700 observations padded to 768,
     f64 inputs cast to f32) and at an RGB-D host frame's (230 rows with
     depth-derived stereo residuals padded to 256), bitwise repeatable.
     Each is timed host-inclusive (CUDA events around the wrapper: `ms`,
     as before the redesign) and device-only (a replayed CUDA graph of 100
     launches: `device_ms`) beside its bound (bytes over the HBM rate, or
     f32 operations over the f32 peak, counted from this run's inputs: the
     windows the corners cover, the rows in use and the LM steps taken),
     the plain version and, for the patch gather, the library call;
  3. the fused tracking step (tpuslam_torch.engine.track_device.
     FusedTrackStep) on a local map of P = 2048 rows built from frame 0:
     track frames 1..16 through the kernels (pose chained on the device,
     from frame 3 on under torch.cuda.set_sync_debug_mode("error")), check
     every pose against ground truth and against the same step run with
     the plain versions, and check the launch counters (2 patch-gather and
     4 pose-LM launches per frame);
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
     1 / 4 times per fused dispatch and the pose LM on the host path; a
     second-lap frame it never saw must relocalize through BoW + PnP on a
     first-lap keyframe, within 20 cm and 3 degrees of ground truth after
     the scaled alignment;
  6. System.track_rgbd over 40 frames of rendered image + exact depth:
     OK, unscaled ATE under 5 cm, Horn scale within 3 % of 1, a pose-LM
     launch on every frame (RGB-D frames take the host path), patch-gather
     launches;
  7. mono-inertial: System.track_monocular(..., imu=) on an IMU_MONOCULAR
     System over the sequence of tests/test_e2e_mono_inertial.py at
     752x480 (vi_excite, 55 frames at 10 fps, 0.5 m/s, IMU at 200 Hz, its
     ImuCalib noise, a keyframe at least every 3 frames), its pixel radii
     scaled by the width ratio, the solvers in f32: the IMU must
     initialize and the run end OK, with a Horn scale within 0.4 of 1, a
     scaled ATE under 6 cm, a gravity-aligned world (|R[2, 2]| > 0.99), a
     median keyframe-velocity error under 0.2 m/s and no mapper errors;
     frames before the init take the host path (pose-LM launches), frames
     after it the fused visual-inertial step: 1 patch-gather and 4 pose-LM
     launches, then pose_inertial_solve (its calls per frame counted);
  8. fisheye stereo: System(camera2=, Tlr=).track_stereo at TUM-VI's
     512x512 over 40 frames at 20 fps (0.5 m/s) rendered by the port's
     Kannala-Brandt renderer from seed 0, the rig of
     tests/test_e2e_fisheye.py with fx, fy, cx, cy doubled (its k's kept),
     lapping (0, 511), a 0.2 m baseline: it must end OK with >= 2
     keyframes and > 100 map points, the first keyframe with > 50
     triangulated depths and u_right = bf / depth, a Horn scale within 5 %
     of 1, an unscaled ATE under 8 cm, a median first-keyframe depth in
     (0.5, 8) m and no mapper errors; every frame makes exactly 2
     patch-gather launches (left and right extraction) and the phase no
     pose-LM launch (KB8 solves take the camera-generic solver, as in
     tpuslam). The patch gather's inputs on frame 0 (the left and the right
     image's 8 levels and corners) are kept, and after the run the kernel
     is held on them against its plain version and the unfold library call
     (bitwise) and timed as in phase 2. One generic KB8 pose solve is timed
     on its own and its CUDA kernels counted (torch.profiler must see them);
  9. the dataset CLI (tpuslam_torch.run.main, as `python -m
     tpuslam_torch.run` runs it) from files on disk: phase 4's first 40
     frames (20 fps, seed 0; its renders) written as a stereo + IMU EuRoC
     tree by scripts/make_synth_euroc_torch.py (PNGs, CSVs, ground truth
     and a YAML with ORBextractor.nFeatures 1024), and a second YAML with
     identity LEFT./RIGHT. rectification blocks. A vocabulary (k = 8, L =
     3) is trained here as in phase 5 and written in the reference's text
     and binary formats and as npz: the three loaders must give the same
     tree. Run A, `--sensor stereo --vocab <.txt> --eval --format euroc
     --kf-output --checkpoint` on the card: OK, one map, an unscaled ATE
     under 5 cm and a Horn scale within 3 % of 1 (read back from the
     trajectory file), one trajectory row per tracked frame and one per
     keyframe, exactly 2 patch-gather launches per frame and pose-LM
     launches, and the checkpoint loaded into a fresh System equal to the
     run's map (every array field, mp_obs, covis, kf_feats). Run B, the
     rectification YAML, `--path D,D --async-mapping --pipelined --format
     kitti`: two maps, OK, both kernels launched, and the rectifier's
     identity maps giving frame 0 back on the card within 1e-4 gray levels.
     The PNG decode time per image is printed apart from the track time.
 10. distribution (tpuslam_torch/parallel/dist_ba.py; bench_dist_torch.py's
     problem: K = 30 poses, P = 3000 points, O = 15,360 observations, f32):
     (a) dist_ba_solve on a one-rank NCCL group, held against
     solve/ba.ba_solve_np on the same card (poses within 1e-3, the cost
     within a factor 2), and the LM trial step timed (iters/s); (b) the
     same over 4 gloo ranks that share the card (CUDA tensors; gloo stages
     them through the host): every rank's state bitwise equal, R and t
     within 1e-4 and X within 1 cm of (a); (c) over those ranks, the
     engine's GBA dry run (bench_dist_torch.dryrun_closer: LoopCloser.
     _snapshot_gba -> _solve_gba -> _apply_gba, 3 distributed solves) must
     more than halve the cost and land on the one-rank route (the cost
     within 1e-3, R within 1e-4, t within 1 cm: the scale gauge is flat),
     and a window inertial BA with DIST_VIBA_MIN_OBS = 0
     (bench_dist_torch.vi_window_ba) within 5e-3 of the one-rank route;
     (d) phase 5's mono loop (its frames) as rank 0 of a 2-rank gloo group
     with LoopConfig(dist_gba_min_obs=0, background_gba=False), rank 1
     serving: phase 5's gates, and its GBA on the distributed route. Each
     group has a timeout, and a rank that fails fails the phase.
 11. the level-0 option and the measuring tools, each cut to a few frames:
     (a) phase 3 again with TrackingConfig(fused_sad="level0") (the
     level-0 SAD refinement, ops/stereo.sad_refine): phase 3's gates and
     exactly 2 patch-gather and 4 pose-LM launches per frame; (b)
     bench_frontend_torch's kernel chain over 16 frames (inliers, a finite
     pose, 1 patch-gather and 1 pose-LM launch per frame), then one forward
     of its entry() on __graft_entry__.entry()'s inputs (2 / 4 launches);
     (c) bench_torch.main over 40 frames and one timed pass: its JSON line
     parses with bench.py's fields and metric name, the pass ends OK with
     >= 3 keyframes, both kernels launched; (d) bench_sensors_torch's RGB-D
     row over 20 frames (two passes): OK, a pose-LM launch on every frame
     but the first of each pass; this path's own kernel inputs (frame 0's
     patch gather, K = 700 over 8 levels of 376x240, and the first host
     pose solve at each padded row count) held against the plain versions:
     the gather bitwise, the pose LM with phase 2's tolerances.
Trajectory errors use tpuslam_torch.eval.ate (Horn alignment).
The last lines are the kernels' JSON record (with launches by path and
per frame, phase 10's mono loop as mono_loop_dist, phase 11's paths as
level0_step, frontend_chain, graft_entry, bench_system and
sensors_rgbd, and phase 11 (d)'s shapes as sensors_rgbd_shapes), the
nvidia-smi line
and {"ok": true, "device": {...}}. Needs one CUDA card; fails without one.
"""

import contextlib
import io
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
N_GRAPH = 100          # launches per CUDA graph for the device-only times
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 and f32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations of the pose LM as csrc/pose_opt.cu does them, structural
# zeros (Ju[1], Jv[0], Jur[1]) left out. Per valid observation and
# evaluation, its residual and chi2 (2 residuals mono, 3 stereo); per
# observation in use, also its weight (1), Jacobian rows (mono 16, stereo
# 23) and weighted H and g products (mono 90, stereo 135), and at a trial
# pose its cost delta (2); per trial, the 6x6 solve and SE3 update. The
# Huber branch, taken only above the chi2 threshold, is left out.
OPS_RESIDUAL = {"mono": 32, "stereo": 37}
OPS_IN_USE = {"mono": 1 + 16 + 90, "stereo": 1 + 23 + 135}
OPS_DELTA = 2
OPS_SOLVE = 460
N_SYSTEM = 60          # phase 4: frames per System run
HOST_PATH = range(40, 50)  # phase 4 (a): frames tracked by the host path
WARMUP = 5             # phases 4-6: frames left out of the per-frame times
N_LOOP = 92            # phase 5: the loop sequence of tests/test_e2e_loop.py
LOOP_HOST_PATH = range(20, 25)  # phase 5: frames tracked by the host path
CIRCUMFERENCE = 2 * np.pi * 1.6
N_RGBD = 40            # phase 6
N_VI = 55              # phase 7: the frames of tests/test_e2e_mono_inertial.py
VI_NOISE = dict(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5)
N_FISH, FISH_FPS, FISH_WH = 40, 20, 512   # phase 8: TUM-VI's camera rate and size
FISH_BASELINE = 0.2
N_CLI, CLI_FPS = 40, 20   # phase 9: the EuRoC tree written to disk
N_DIST_RANKS = 4       # phase 10 (b, c): gloo ranks sharing the card
DIST_TIMEOUT = 300.0   # phase 10: every group's collectives and every rank's run (s)
N_CHAIN = 16           # phase 11 (b): frames of bench_frontend_torch's chain
N_BENCH = 40           # phase 11 (c): bench_torch's frames (a warm pass and one timed)
N_SENSORS = 20         # phase 11 (d): bench_sensors_torch's RGB-D frames (two passes)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def median_ms(fn, n=N_TIMED, warmup=3):
    """Host-inclusive time: median of n timed calls of fn(), each between
    two CUDA events (what the host takes to enqueue, or the device to run,
    whichever is longer)."""
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


def device_ms(fn, n=N_GRAPH, reps=5):
    """Device-only time of one fn(): a CUDA graph captures n calls, and
    the median over reps replays of the time between two events around a
    replay, divided by n, is what the device takes without the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return float(np.median(times))


def bound(n_bytes, n_flops):
    """The least time (ms) the card could take: bytes over its memory rate
    or f32 operations over its f32 peak (outside the tensor cores),
    whichever is longer; and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes", "hbm") if t_bytes >= t_ops else (t_ops, "operations", "f32 compute")


def pose_lm_ops(rounds, n_valid):
    """f32 operations one pose LM solve needs, from the plain version's
    per-round work (`rounds`) and the valid rows, {"mono": .., "stereo": ..}:
    each round evaluates its start pose (re-classifying every valid row)
    and one trial per LM step; the outputs take one more residual per
    valid row."""
    ops = sum(OPS_RESIDUAL[k] * n_valid[k] for k in n_valid)      # the outputs
    for r in rounds:
        in_use = sum(OPS_IN_USE[k] * r[k] for k in n_valid)
        trial = sum((OPS_RESIDUAL[k] + OPS_DELTA) * r[k] for k in n_valid) + in_use
        ops += sum(OPS_RESIDUAL[k] * n_valid[k] for k in n_valid) + in_use
        ops += r["steps"] * (trial + OPS_SOLVE)
    return ops


def window_bytes(levels, corners, size):
    """Bytes of level pixels that the size x size windows at `corners` cover
    (their union on each level, read once)."""
    import torch

    total = 0
    span = torch.arange(size, device=levels[0].device)
    for lv, c in zip(levels, corners):
        h, w = lv.shape
        rows, cols = c[:, :1].long() + span, c[:, 1:].long() + span
        inside = ((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :]
        covered = torch.zeros(h * w, dtype=torch.bool, device=lv.device)
        covered[(rows[:, :, None] * w + cols[:, None, :])[inside]] = True
        total += int(covered.sum()) * lv.element_size()
    return total


def u8(im):
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def ptxas_report(log, kernel):
    """(registers, stack, spill stores, spill loads) of `kernel` from the
    build's `nvcc -Xptxas -v` output."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and kernel in line:
            nums = [int(w) for w in lines[i + 1].replace(",", " ").split() if w.isdigit()]
            regs = next(int(l.split("Used ")[1].split()[0]) for l in lines[i + 2:]
                        if "Used " in l)
            return regs, nums[0], nums[1], nums[2]
    raise AssertionError(f"no ptxas report for {kernel}")


def pose_problem(n, stereo, seed, dev, n_valid=None, bf=None, f64=False):
    """A seeded pose problem: points 2-6 m ahead (1-5 m with bf given),
    0.3 px noise, 10 % gross outliers; n_valid rows, then invalid padding
    to n; half the valid rows stereo (all of them with bf given)."""
    import torch

    from tpuslam_torch.solve.pose_opt_cuda import _se3_exp

    rng = np.random.RandomState(seed)
    nv = n if n_valid is None else n_valid
    cx, cy = W / 2.0, H / 2.0
    rgbd = bf is not None
    bf = (FX * BASELINE if stereo else 0.0) if bf is None else bf
    X = np.stack([rng.randn(nv), rng.randn(nv), rng.rand(nv) * 4 + (1 if rgbd else 2)], -1)
    u = FX * X[:, 0] / X[:, 2] + cx
    v = FY * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(nv, 3) * 0.3
    uvr[: nv // 10] += rng.randn(nv // 10, 3) * 40
    is_st = np.zeros(n, bool)
    if stereo:
        is_st[: nv if rgbd else nv // 2] = True
    valid = np.zeros(n, bool)
    valid[:nv] = True
    pad = ((0, n - nv), (0, 0))
    ftype = torch.float64 if f64 else torch.float32
    dR, dt = _se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.015, 0.01], dtype=ftype))
    inv_s2 = SCALE ** (-2.0 * rng.randint(0, N_LEVELS, nv)) if n_valid is not None else np.ones(n)
    arrays = [dR, dt, torch.tensor(np.pad(X, pad)), torch.tensor(np.pad(uvr, pad)),
              torch.tensor(np.pad(inv_s2, (0, n - len(inv_s2))))]
    arrays = [a.to(ftype).contiguous().to(dev) for a in arrays]
    return arrays + [torch.tensor(is_st, device=dev), torch.tensor(valid, device=dev),
                     FX, FY, cx, cy, bf]


def patch_compare(levels, yx, budgets, size, what):
    """The patch gather on one image's padded blurred levels and corners:
    bitwise equal to its plain version and to the unfold library call, each
    timed host-inclusive and device-only, beside its bound."""
    import torch

    from tpuslam_torch.ops import patch_cuda

    corners = list(torch.split(yx, list(budgets)))

    def kernel():
        return patch_cuda.extract_patches_levels(levels, yx, budgets, size)

    def plain():
        return patch_cuda.extract_patches_levels_plain(levels, yx, budgets, size)

    def library():  # one PyTorch call per level: every window, then the corners'
        return torch.cat([lv.unfold(0, size, 1).unfold(1, size, 1)[c[:, 0].long(),
                                                                    c[:, 1].long()]
                          for lv, c in zip(levels, corners)])

    got, ref, lib = kernel(), plain(), library()
    torch.cuda.synchronize()
    check(yx.shape[0] == sum(budgets) and got.shape == (yx.shape[0], size, size),
          f"{what}: patch shape {tuple(got.shape)} for {yx.shape[0]} corners")
    check(torch.equal(got, ref), f"{what}: patch gather differs from its plain version")
    check(torch.equal(lib, ref), f"{what}: the unfold library call differs from the plain gather")
    timed = {}
    for rep in range(2):  # kernel, plain, library, then in reverse
        order = (kernel, plain, library) if rep == 0 else (library, plain, kernel)
        for fn in order:
            timed.setdefault(fn, []).append((median_ms(fn), device_ms(fn)))
    host_ms, dev_ms = (float(np.median([t[i] for t in timed[kernel]])) for i in (0, 1))
    plain_ms, plain_dev = (float(np.median([t[i] for t in timed[plain]])) for i in (0, 1))
    lib_ms, lib_dev = (float(np.median([t[i] for t in timed[library]])) for i in (0, 1))
    n_bytes = window_bytes(levels, corners, size) + yx.numel() * 4 + got.numel() * 4
    b_ms, b_by, b_res = bound(n_bytes, 0)
    log(f"[kernels] patch gather, {what}: bitwise equal to its plain version and to the unfold "
        f"library call over {len(levels)} levels {[tuple(lv.shape) for lv in levels]} "
        f"(K={list(budgets)}), one launch per image: kernel device {dev_ms:.5f} ms, "
        f"host-inclusive {host_ms:.5f} ms; plain {plain_ms:.5f} ms (device {plain_dev:.5f}); "
        f"library (8 unfold calls) {lib_ms:.5f} ms (device {lib_dev:.5f}); bound {b_ms:.5f} ms "
        f"({n_bytes} bytes: the output, the corners and the union of the windows on each level; "
        f"{b_res}); the bound is {b_ms / dev_ms:.3f} of the device time")
    return dict(max_abs_err=float((got - ref).abs().max()), ms=host_ms, device_ms=dev_ms,
                plain_ms=plain_ms, plain_device_ms=plain_dev, bound_ms=b_ms, bound_by=b_by,
                bound_resource=b_res, bytes=n_bytes, library_ms=lib_ms, library_device_ms=lib_dev)


def pose_lm_compare(solve, args, what, kw=None):
    """One pose-LM launch through `solve` (the kernel's wrapper, or
    pose_optimize_best, which casts to f32) against the plain version on
    the same f32 inputs: |dR| <= 1e-4, |dt| <= 1e-3, inlier flags equal on
    >= 99 % of the rows, no padded row an inlier, chi2 finite. Returns
    (|dR|, |dt|, agreement, the kernel's outputs, the plain LM's rounds)."""
    import torch

    from tpuslam_torch.solve import pose_opt_cuda

    args32 = [a.to(torch.float32).contiguous() for a in args[:5]] + list(args[5:])
    before = pose_opt_cuda.counter.launches
    out = solve(*args, **(kw or {}))
    check(pose_opt_cuda.counter.launches == before + 1, f"pose LM {what}: the solve did not launch")
    rounds = []
    Rp, tp, ip, _ = pose_opt_cuda.pose_optimize_plain(*args32, rounds=rounds)
    torch.cuda.synchronize()
    Rk, tk, ik, ck = out
    eR = float((Rk - Rp).abs().max())
    et = float((tk - tp).abs().max())
    agree = float((ik == ip).float().mean())
    check(eR <= 1e-4 and et <= 1e-3 and agree >= 0.99,
          f"pose LM {what}: kernel vs plain out of tolerance (|dR| {eR}, |dt| {et}, {agree})")
    check(not bool(ik[int(args[6].sum()):].any()), f"pose LM {what}: a padded row is an inlier")
    check(bool(torch.isfinite(ck).all()), f"pose LM {what}: non-finite chi2")
    return eR, et, agree, out, rounds


def phase_kernels(dev, seq):
    """Kernel vs plain version on the card at main-path shapes; each timed
    host-inclusive (events around the wrapper) and device-only (a replayed
    CUDA graph of N_GRAPH launches), beside its bound."""
    import torch
    import torch.nn.functional as F

    from tpuslam_torch.engine.config import OrbConfig
    from tpuslam_torch.ops.fast import _border_mask, cell_threshold_gate, fast_score, nms3x3
    from tpuslam_torch.ops.image import build_pyramid, gaussian_blur, gaussian_kernel1d
    from tpuslam_torch.ops.orb import DESC_R, HALF_PATCH, PAD, _select_level_keypoints
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    records = []
    # -- patch gather: the real padded blurred levels of a rendered frame,
    # all 8 levels of one image in one launch
    cfg = OrbConfig(n_features=N_FEATURES)
    img = torch.tensor(u8(seq.frame(0)), device=dev).float()
    taps = torch.tensor(gaussian_kernel1d(), device=dev)
    levels, corners = [], []
    budgets = cfg.level_budgets()
    for im, budget in zip(build_pyramid(img, cfg.n_levels, cfg.scale), budgets):
        score = nms3x3(cell_threshold_gate(fast_score(im), cfg.ini_th, cfg.min_th, cfg.th_cell))
        h, w = im.shape
        score = torch.where(_border_mask(h, w, HALF_PATCH + 1, dev), score, 0.0)
        xy, _ = _select_level_keypoints(score, budget, cfg.cell)
        levels.append(F.pad(gaussian_blur(im, taps)[None, None], (PAD,) * 4,
                            mode="replicate")[0, 0].contiguous())
        corners.append(torch.stack([xy[:, 1], xy[:, 0]], -1) + (PAD - DESC_R))
    yx = torch.cat(corners).contiguous()
    rec = patch_compare(levels, yx, budgets, 2 * DESC_R + 1, f"pinhole {W}x{H}")
    records.append(dict(name="patch_gather", route="cuda",
                        source="tpuslam_torch/csrc/patch.cu",
                        replaces="tpuslam/ops/patch_pallas.py:88", **rec,
                        library="Tensor.unfold(0, 37, 1).unfold(1, 37, 1)[rows, cols], "
                                "one call per level"))

    # -- pose LM at the four shapes of the main paths: the fused step's
    # N = 1024 (stereo and mono), the host tracker's 700 rows padded to 768
    # (f64 inputs cast to f32), an RGB-D host frame's 230 depth-derived
    # stereo rows padded to 256
    shapes = {
        "stereo_1024": pose_problem(1024, True, 1, dev),
        "mono_1024": pose_problem(1024, False, 0, dev),
        "host_768": pose_problem(768, True, 2, dev, n_valid=700, f64=True),
        "rgbd_256": pose_problem(256, True, 3, dev, n_valid=230, bf=FX * 0.08, f64=True),
    }
    worst, shape_rec = 0.0, {}
    for name, args in shapes.items():
        host = name in ("host_768", "rgbd_256")
        args32 = [a.to(torch.float32).contiguous() for a in args[:5]] + args[5:]
        eR, et, agree, out, rounds = pose_lm_compare(
            pose_optimize_best if host else pose_opt_cuda.pose_optimize_fused, args, name)
        again = pose_opt_cuda.pose_optimize_fused(*args32)
        torch.cuda.synchronize()
        n_valid = int(args[6].sum())
        repeat = all(torch.equal(a, b) for a, b in zip(again, out))
        check(repeat, f"pose LM {name}: two launches on the same inputs differ")
        worst = max(worst, eR, et)
        fused = lambda: pose_opt_cuda.pose_optimize_fused(*args32)  # noqa: E731
        wrapper = (lambda: pose_optimize_best(*args)) if host else fused
        t = {"kernel": [], "plain": []}
        for what in ("kernel", "plain", "plain", "kernel"):
            if what == "kernel":
                t["kernel"].append((median_ms(wrapper), device_ms(fused)))
            else:
                t["plain"].append(median_ms(lambda: pose_opt_cuda.pose_optimize_plain(*args32),
                                            n=10))
        host_ms = float(np.median([x[0] for x in t["kernel"]]))
        dev_ms = float(np.median([x[1] for x in t["kernel"]]))
        plain_ms = float(np.median(t["plain"]))
        n = args[2].shape[0]
        st = args[5] & args[6]
        n_valid_by = {"mono": n_valid - int(st.sum()), "stereo": int(st.sum())}
        steps = [r["steps"] for r in rounds]
        in_use = [(r["mono"], r["stereo"]) for r in rounds]
        n_flops = pose_lm_ops(rounds, n_valid_by)
        n_bytes = n * (3 * 4 + 3 * 4 + 4 + 1 + 1) + 2 * (9 + 3) * 4 + n * (1 + 4)
        b_ms, b_by, b_res = bound(n_bytes, n_flops)
        shape_rec[name] = dict(n=n, valid=n_valid_by, ms=host_ms, device_ms=dev_ms,
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, rounds=rounds,
                               flops=n_flops, bytes=n_bytes)
        log(f"[kernels] pose LM {name}: |dR| {eR:.3g} |dt| {et:.3g} inlier agreement "
            f"{agree:.4f}, bitwise repeatable; kernel device {dev_ms:.5f} ms, host-inclusive "
            f"{host_ms:.5f} ms{' (f64 cast included)' if host else ''}; plain {plain_ms:.4f} ms; "
            f"LM steps per round {steps}, rows in use (mono, stereo) {in_use}; bound "
            f"{b_ms:.6f} ms ({n_flops} f32 operations, {n_bytes} bytes: {b_res}); the bound "
            f"is {b_ms / dev_ms:.4f} of the device time")
    main = shape_rec["stereo_1024"]
    records.append(dict(name="pose_lm", route="cuda",
                        source="tpuslam_torch/csrc/pose_opt.cu",
                        replaces="tpuslam/solve/pose_opt_pallas.py:317",
                        max_abs_err=worst, ms=main["ms"], device_ms=main["device_ms"],
                        plain_ms=main["plain_ms"],
                        mono_ms=shape_rec["mono_1024"]["ms"],
                        mono_plain_ms=shape_rec["mono_1024"]["plain_ms"],
                        host_shapes_ms=shape_rec["host_768"]["ms"],
                        host_shapes_plain_ms=shape_rec["host_768"]["plain_ms"],
                        rgbd_host_ms=shape_rec["rgbd_256"]["ms"],
                        rgbd_host_plain_ms=shape_rec["rgbd_256"]["plain_ms"],
                        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                        bound_resource=("hbm" if main["bound_by"] == "bytes" else "f32 compute"),
                        library_ms=None, library="none: no single PyTorch call solves an LM "
                        "problem", shapes=shape_rec))
    return records


def counts_now():
    """Both kernels' launch counters."""
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda

    return {"patch_gather": patch_cuda.counter.launches, "pose_lm": pose_opt_cuda.counter.launches}


def reset_counts():
    """Both kernels' launch counters to 0, just before a path is driven."""
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda

    patch_cuda.counter.launches = 0
    pose_opt_cuda.counter.launches = 0


class plain_path:
    """Run the step with the kernels' plain versions on the card."""

    def __enter__(self):
        from tpuslam_torch.engine import track_device
        from tpuslam_torch.ops import orb, patch_cuda
        from tpuslam_torch.solve import pose_opt_cuda

        self.saved = (orb.extract_patches_levels, track_device.pose_optimize_fused)
        orb.extract_patches_levels = patch_cuda.extract_patches_levels_plain
        track_device.pose_optimize_fused = pose_opt_cuda.pose_optimize_plain
        return self

    def __exit__(self, *exc):
        from tpuslam_torch.engine import track_device
        from tpuslam_torch.ops import orb

        orb.extract_patches_levels, track_device.pose_optimize_fused = self.saved


def rot_err_deg(Ra, Rb):
    c = (np.trace(Ra @ Rb.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def phase_slice(dev, seq, all_frames, sad="pyramid"):
    """The bare fused step (TrackingConfig(fused_sad=sad)) over frames
    1..16 against ground truth and its plain path; returns the launches."""
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
    step = FusedTrackStep(cam, OrbConfig(n_features=N_FEATURES), TrackingConfig(fused_sad=sad),
                          N_LEVELS, SCALE, bf, True, device=dev)
    tag = "slice" if sad == "pyramid" else f"slice {sad}"
    f0 = step.extract(torch.tensor(frames[0], device=dev))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()},
                             FX, FY, seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=P_BASE)
    n_rows = int(local[2].sum())
    log(f"[{tag}] local map from frame 0: {n_rows} points, P bucket {local[0].shape[0]}")
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

    reset_counts()
    outs, pose_ins, ms_k = run(step)
    launches = counts_now()
    n = len(inputs)
    log(f"[{tag}] kernel launches over {n} frames: {launches}")
    check(launches == {"patch_gather": 2 * n, "pose_lm": 4 * n},
          f"launch counters {launches} != 2 / 4 per frame")
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
        log(f"[{tag}] frame {i:2d}: |t err| {e_t * 100:.3f} cm, R err {e_r:.4f} deg, "
            f"inliers {n_inl}, vs plain |dR| {dR:.2e} |dt| {dt:.2e} assoc {agree:.4f}, "
            f"{ms_k[k]:.3f} ms (kernels) {ms_p[k]:.3f} ms (plain)")
        check(e_t < 0.05 and e_r < 1.0, f"frame {i}: pose off ground truth")
        check(n_inl >= 50, f"frame {i}: only {n_inl} inliers")
        check(dR <= 5e-4 and dt <= 5e-3 and agree >= 0.95,
              f"frame {i}: kernel path differs from the plain path")
    log(f"[{tag}] median ms/frame over {n} frames (CUDA events, first frames include "
        f"warm-up): kernels {np.median(ms_k):.3f}, plain {np.median(ms_p):.3f}")
    return launches


def phase_system(dev, seq, frames, smi):
    """System.track_stereo over N_SYSTEM frames, synchronous then
    async + pipelined; returns the launch counts of each run."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    cam = Pinhole([FX, FY, seq.cx, seq.cy], W, H)
    counts = {}
    for name, asyn in (("a_sync", False), ("b_async_pipelined", True)):
        cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                         tracking=TrackingConfig(min_stereo_init_features=200, pipelined=asyn))
        slam = System(cam, cfg, sensor=Sensor.STEREO, bf=FX * BASELINE, async_mapping=asyn,
                      device=dev)
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        wall = []
        for i in range(N_SYSTEM):
            if not asyn:
                slam.tracker.fused_enabled = i not in HOST_PATH
            t0 = time.perf_counter()
            slam.track_stereo(frames[i][0], frames[i][1], i / seq.fps)
            wall.append((time.perf_counter() - t0) * 1e3)
        slam.shutdown()
        torch.cuda.synchronize()
        launches = counts_now()
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
        check(launches["patch_gather"] >= 2 * n_fused and launches["pose_lm"] >= 4 * n_fused,
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


def loop_sequence():
    from tpuslam_torch.io.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=N_LOOP, fps=8, speed=1.0, kind="loop", height=H, width=W,
                             fx=FX, fy=FY)


def render_loop():
    """The N_LOOP frames of loop_sequence() (phases 5 and 10)."""
    seq = loop_sequence()
    t0 = time.perf_counter()
    frames = [u8(seq.frame(i)) for i in range(N_LOOP)]
    log(f"[mono_loop] rendered {N_LOOP} frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host)")
    return frames


def phase_mono_loop(dev, smi, frames, dist=False):
    """System.track_monocular with a vocabulary over the loop sequence of
    tests/test_e2e_loop.py (`frames`, render_loop's), at full width;
    returns the launch counts. dist: the run is rank 0 of a process group
    (phase 10 d) and every GBA is the distributed solve, run synchronously
    (dist_gba_min_obs = 0, background_gba = False): it must take that route."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.frontend import Frontend
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import Frame, State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.parallel import dist_ba
    from tpuslam_torch.place import train_vocabulary
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    tag = "mono_loop_dist" if dist else "mono_loop"
    seq = loop_sequence()
    cam = Pinhole([FX, FY, seq.cx, seq.cy], W, H)
    # tests/test_e2e_loop.py's configuration, its pixel radii (the
    # motion-model radius and the two-view init window) scaled by the
    # width ratio
    loop_kw = dict(dist_gba_min_obs=0, background_gba=False) if dist else {}
    cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                     tracking=TrackingConfig(max_frames_between_kf=4, min_matches_init=60,
                                             motion_model_radius=25.0 * W / 376.0,
                                             init_window=100.0 * W / 376.0,
                                             time_recently_lost=2.0),
                     loop=LoopConfig(min_proj_matches=35, min_bow_matches=15, **loop_kw))
    fe = Frontend(cam, cfg.orb, device=dev)
    t0 = time.perf_counter()
    descs = []
    for i in (0, 10, 20, 30):
        f = fe.process(frames[i])
        descs.append(f.bits[f.valid])
    vocab = train_vocabulary(np.concatenate(descs), k=8, L=3, iters=5, device=dev)
    log(f"[{tag}] vocabulary k=8 L=3 ({vocab.n_words} words) trained on "
        f"{sum(map(len, descs))} descriptors in {time.perf_counter() - t0:.1f} s")
    slam = System(cam, cfg, sensor=Sensor.MONOCULAR, vocab=vocab, device=dev)
    GLOBAL_TIMER.samples.clear()
    dist_ba.counter.__init__()
    reset_counts()
    wall = []
    for i, t in enumerate(seq.timestamps()):
        slam.tracker.fused_enabled = i not in LOOP_HOST_PATH
        t1 = time.perf_counter()
        slam.track_monocular(frames[i], t)
        wall.append((time.perf_counter() - t1) * 1e3)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = counts_now()
    n_fused = len(GLOBAL_TIMER.samples.get("fused.dispatch", []))
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    rmse, _ = ate(est, gt_centers(seq, traj), True)
    steady = np.array(wall[WARMUP:])
    lc = slam.loop_closer
    log(f"[{tag}] state {slam.get_tracking_state().name}, {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, loops closed {lc.n_loops_closed}, maps "
        f"{list(m.map_ids())}, {len(traj)} trajectory rows, scaled ATE {rmse:.5f} (limit "
        f"{0.05 * CIRCUMFERENCE:.5f})")
    log(f"[{tag}] track_monocular wall ms over frames {WARMUP}..{N_LOOP - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"card {smi}")
    stage_table(tag, GLOBAL_TIMER)
    slow = int(np.argmax(wall))
    log(f"[{tag}] slowest frame {slow}: {wall[slow]:.1f} ms")
    log(f"[{tag}] launches {launches}; fused dispatches {n_fused}; pose LM on the host path "
        f"{launches['pose_lm'] - 4 * n_fused}")
    check(slam.get_tracking_state() == State.OK, f"{tag}: final state not OK")
    check(lc.n_loops_closed >= 1, f"{tag}: no loop closed")
    check(len(m.map_ids()) == 1, f"{tag}: {len(m.map_ids())} maps after shutdown")
    check(len(traj) >= N_LOOP - 20 and np.isfinite(est).all(), f"{tag}: trajectory")
    check(rmse < 0.05 * CIRCUMFERENCE, f"{tag}: scaled ATE {rmse}")
    check(m.check_essential_graph() == [], f"{tag}: spanning tree broken")
    check(n_fused > 0 and launches["patch_gather"] >= n_fused
          and launches["pose_lm"] >= 4 * n_fused, f"{tag}: fewer launches than dispatches")
    check(launches["pose_lm"] > 4 * n_fused, f"{tag}: the host path ran no pose LM")
    check(dist_ba.counter.ba > 0 if dist else dist_ba.counter.ba == 0,
          f"{tag}: {dist_ba.counter.ba} distributed GBA solves")
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
    R, tt, s, _ = horn_align(est, gt_centers(seq, traj), True)
    Rcw, tcw = seq.gt_pose_cw(t)
    err = float(np.linalg.norm(s * R @ (-frame.R.T @ frame.t) + tt + Rcw.T @ tcw)) if ok else -1.0
    ang = float(np.degrees(np.arccos(np.clip((np.trace(R @ frame.R.T @ Rcw) - 1) / 2, -1, 1)))) \
        if ok else -1.0
    log(f"[{tag}] BoW relocalization of unseen frame {i} (t {t:.3f} s, second lap): {ok}, "
        f"keyframe {kf} (t {m.kf_time[kf]:.3f} s), {slam.tracker.n_inliers} inliers, "
        f"{err * 100:.3f} cm and {ang:.3f} deg from ground truth after the scaled alignment")
    check(ok and slam.tracker.n_inliers >= 15 and m.kf_valid[kf] and m.kf_time[kf] < lap_s
          and err < 0.20 and ang < 3.0, f"{tag}: BoW relocalization on the first lap failed")
    return launches


def mono_loop_rank(rank, world, device, smi, frames):
    """Phase 10 (d) on one rank of a gloo group: rank 0 runs phase 5's mono
    loop with its GBA distributed (phase_mono_loop(dist=True)) and returns
    its launch counts and distributed solves; the other ranks serve those
    solves and return how many they served."""
    import torch

    from tpuslam_torch.parallel import dist_ba

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank:
        return dist_ba.serve(device=dev)
    try:
        launches = phase_mono_loop(dev, smi, frames, dist=True)
    finally:
        dist_ba.release_followers()
    return launches, dist_ba.counter.ba


def phase_dist(dev, smi, loop_frames):
    """Phase 10: the distributed BA. Returns the launch counts of (d)."""
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import bench_dist_torch as BD
    from tpuslam_torch.parallel import dist_ba, launch
    from tpuslam_torch.solve.ba import ba_solve_np

    t_phase = time.perf_counter()
    args = BD.problem_args()
    # (a) bench_dist_torch's problem on a one-rank NCCL group, against the
    # single-device solver on the same card
    launch.init_rank(0, 1, launch.free_port(), "nccl", DIST_TIMEOUT)
    try:
        dist_ba.counter.__init__()
        t0 = time.perf_counter()
        Ra, ta, Xa, _ = dist_ba.dist_ba_solve(None, *args, n_iters=10, device=dev)
        solve_a = time.perf_counter() - t0
        acc_a, trials_a = dist_ba.counter.accepted, dist_ba.counter.trials
        step_a = BD.time_step(None, dev, reps=20)
        step, step_args = BD.trial_step(None, dev)
        step(*step_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(*step_args)
            torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(evs, "dist a: torch.profiler saw no CUDA kernel in a trial step")
    busy_a = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    nccl_a = sum("nccl" in e.name.lower() for e in evs)
    t0 = time.perf_counter()
    R1, t1, X1, _, _ = ba_solve_np(*args, n_iters=10, device=dev)
    solve_1 = time.perf_counter() - t0
    cost_a, cost_1 = BD.problem_cost(Ra, ta, Xa), BD.problem_cost(R1, t1, X1)
    err = (np.abs(Ra - R1).max(), np.abs(ta - t1).max())
    log(f"[dist a] K30 / P3000 / O15360, f32, one-rank NCCL group: dist_ba_solve {solve_a:.3f} s "
        f"({acc_a} steps accepted of {trials_a}), cost {cost_a:.3f}; ba_solve_np on the same card "
        f"{solve_1:.3f} s, cost {cost_1:.3f}; |dR| {err[0]:.2e} |dt| {err[1]:.2e}; the trial step "
        f"(15 PCG iterations) {step_a * 1e3:.3f} ms = {1.0 / step_a:.2f} iters/s, one step "
        f"{len(evs)} CUDA kernels ({nccl_a} NCCL), device busy {busy_a:.3f} ms; card {smi}")
    check(err[0] < 1e-3 and err[1] < 1e-3, f"dist a: pose error {err} against ba_solve_np")
    check(0.5 < cost_a / cost_1 < 2.0, f"dist a: cost {cost_a} against ba_solve_np's {cost_1}")
    # (b) the same over N_DIST_RANKS gloo ranks that share the card; (c) the
    # engine's GBA dry run and a window inertial BA over them
    t0 = time.perf_counter()
    res = launch.run(BD.dist_checks_rank, N_DIST_RANKS, args=(str(dev),), timeout=DIST_TIMEOUT)
    wall_bc = time.perf_counter() - t0
    lead = res[0]
    Rb, tb, Xb, cost_b = lead["problem"]
    err_b = (np.abs(Rb - Ra).max(), np.abs(tb - ta).max(), np.abs(Xb - Xa).max())
    same = all(np.array_equal(a, b) for r in res[1:] for a, b in zip(lead["problem"], r["problem"]))
    log(f"[dist b] {N_DIST_RANKS} gloo ranks on the card (CUDA tensors staged through the host): "
        f"{lead['accepted']} steps accepted of {lead['trials']}; against (a) |dR| {err_b[0]:.2e} "
        f"|dt| {err_b[1]:.2e} |dX| {err_b[2]:.2e}; every rank's state bitwise equal: {same}; "
        f"the trial step {lead['step_s'] * 1e3:.3f} ms on rank 0 "
        f"({[round(r['step_s'] * 1e3, 3) for r in res]} ms by rank); ranks' run {wall_bc:.1f} s")
    check(same, "dist b: the ranks' states differ")
    check(err_b[0] < 1e-4 and err_b[1] < 1e-4 and err_b[2] < 1e-2,
          f"dist b: {N_DIST_RANKS} ranks against one: {err_b}")
    served = lead["ba_solves"] + lead["viba_solves"]
    check(all(r["served"] == served for r in res[1:]), "dist c: a follower missed a solve")
    lc, snap, cost = BD.dryrun_closer(device=dev)
    t0 = time.perf_counter()
    R1, t1, X1 = lc._solve_gba(snap, n_iters=6)
    gba_1 = time.perf_counter() - t0
    d = lead["dryrun"]
    Rd, td, _ = d["solved"]
    err_c = (np.abs(Rd - R1).max(), np.abs(td - t1).max())
    log(f"[dist c] the engine's GBA dry run (K30 / P3000, {d['obs']} observations) over "
        f"{N_DIST_RANKS} ranks: cost {d['cost_before']:.4f} -> {d['cost_after']:.4f} in "
        f"{d['solve_s']:.3f} s ({lead['ba_solves']} distributed solves); one rank: "
        f"{cost(R1, t1, X1):.4f} in {gba_1:.3f} s; |dR| {err_c[0]:.2e} |dt| {err_c[1]:.2e}")
    check(d["obs"] > 10_000 and lead["ba_solves"] == 3, "dist c: the dry run's route")
    check(d["cost_after"] < 0.5 * d["cost_before"], f"dist c: cost {d['cost_before']} -> "
          f"{d['cost_after']}")
    # the cost and the rotations agree; the translations within 1 cm, as
    # the scale gauge of a GBA with one fixed keyframe and no stereo is flat
    check(abs(d["cost_after"] / cost(R1, t1, X1) - 1.0) < 1e-3 and err_c[0] < 1e-4
          and err_c[1] < 1e-2, f"dist c: the dry run against one rank: {err_c}")
    vi1 = BD.vi_window_ba(dev)
    vi = lead["vi"]
    err_vi = [float(np.abs(a - b).max()) for a, b in zip(vi["state"], vi1["state"])]
    log(f"[dist c] window inertial BA ({vi['obs']} observations, f32) over {N_DIST_RANKS} ranks "
        f"in {vi['solve_s']:.3f} s ({lead['viba_solves']} distributed solve), one rank "
        f"{vi1['solve_s']:.3f} s; |dR| |dt| |dv| {err_vi}")
    check(lead["viba_solves"] == 1 and max(err_vi) < 5e-3,
          f"dist c: the window inertial BA against one rank: {err_vi}")
    # (d) phase 5's mono loop as rank 0 of a 2-rank group
    t0 = time.perf_counter()
    (launches, n_gba), served = launch.run(mono_loop_rank, 2, args=(str(dev), smi, loop_frames),
                                           timeout=DIST_TIMEOUT)
    log(f"[dist d] mono loop on rank 0 of 2: {n_gba} distributed GBA solves, {served} served by "
        f"rank 1; launches {launches}; ranks' run {time.perf_counter() - t0:.1f} s")
    check(n_gba > 0 and served == n_gba, "dist d: the loop's GBA did not take the distributed "
          "route")
    log(f"[dist] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_rgbd(dev, smi):
    """System.track_rgbd over N_RGBD rendered frames with exact depth."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.io.synthetic import SyntheticSequence
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
    reset_counts()
    wall, per_frame = [], []
    for i, t in enumerate(seq.timestamps()):
        before = pose_opt_cuda.counter.launches
        t1 = time.perf_counter()
        slam.track_rgbd(*frames[i], t)
        wall.append((time.perf_counter() - t1) * 1e3)
        per_frame.append(pose_opt_cuda.counter.launches - before)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = counts_now()
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


def phase_mono_vi(dev, smi):
    """System.track_monocular(..., imu=) on an IMU_MONOCULAR System over the
    sequence of tests/test_e2e_mono_inertial.py at full width; returns the
    launch counts."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import patch_cuda
    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    seq = SyntheticSequence(n_frames=N_VI, fps=10, speed=0.5, imu_rate=200.0, kind="vi_excite",
                            height=H, width=W, fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = [u8(seq.frame(i)) for i in range(N_VI)]
    times = seq.timestamps()
    imu = [None] + [np.column_stack(seq.imu_between(times[i - 1], times[i]))
                    for i in range(1, N_VI)]
    log(f"[mono_vi] rendered {N_VI} frames {W}x{H} and {sum(len(x) for x in imu[1:])} IMU "
        f"samples in {time.perf_counter() - t0:.1f} s (host)")
    # the test's configuration, its pixel radii (the motion-model radius and
    # the two-view init window, defaults there) scaled by the width ratio
    base = TrackingConfig()
    cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                     tracking=TrackingConfig(max_frames_between_kf=3,
                                             motion_model_radius=base.motion_model_radius * W
                                             / 376.0,
                                             init_window=base.init_window * W / 376.0))
    slam = System(Pinhole([FX, FY, seq.cx, seq.cy], W, H), cfg, sensor=Sensor.IMU_MONOCULAR,
                  imu_calib=ImuCalib(**VI_NOISE, freq=seq.imu_rate), device=dev)
    GLOBAL_TIMER.samples.clear()
    reset_counts()
    wall, rows = [], []

    def counts():
        # kernel launches, then the tracker's timed stages: one
        # "pose_inertial" sample per pose-inertial solve (plain torch)
        return (patch_cuda.counter.launches, pose_opt_cuda.counter.launches,
                *(len(GLOBAL_TIMER.samples.get(s, []))
                  for s in ("pose_inertial", "track_fused_vi", "track")))

    for i in range(N_VI):
        before = counts()
        initialized = slam.map.imu_initialized
        t1 = time.perf_counter()
        slam.track_monocular(frames[i], times[i], imu=imu[i])
        wall.append((time.perf_counter() - t1) * 1e3)
        rows.append(dict(initialized=initialized,
                         **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host"),
                                    (a - b for a, b in zip(counts(), before))))))
    slam.shutdown()
    torch.cuda.synchronize()
    launches = counts_now()
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = gt_centers(seq, traj)
    rmse, scale = ate(est, gt, True)
    R, _, s, _ = horn_align(est, gt, True)
    vel_err = float(np.median([np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
                               for k in m.valid_kf_ids()]))
    steady = np.array(wall[WARMUP:])
    fused = [r for r in rows if r["fused_vi"] and not r["host"]]
    host_pre = [r for r in rows if not r["initialized"] and r["host"]]
    init_frame = next((i for i, r in enumerate(rows[1:], 1) if r["initialized"]), -1) - 1
    log(f"[mono_vi] state {slam.get_tracking_state().name}, IMU initialized "
        f"{m.imu_initialized} (after frame {init_frame}), {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, {len(traj)} trajectory rows, Horn scale "
        f"{scale:.5f}, scaled ATE {rmse * 100:.3f} cm, |R[2,2]| {abs(R[2, 2]):.6f}, median "
        f"KF velocity error {vel_err:.4f} m/s")
    log(f"[mono_vi] track_monocular wall ms over frames {WARMUP}..{N_VI - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"card {smi}")
    stage_table("mono_vi", GLOBAL_TIMER)
    log(f"[mono_vi] launches {launches}; fused VI frames {len(fused)} (patch gather "
        f"{sorted(set(r['patch'] for r in fused))}, pose LM {sorted(set(r['pose'] for r in fused))}"
        f" per frame), pose_inertial_solve calls per fused VI frame "
        f"{sorted(set(r['vi_solves'] for r in fused))}, per frame after the init "
        f"{np.mean([r['vi_solves'] for r in rows if r['initialized']] or [0.0]):.3f}; host-path "
        f"frames before the init {len(host_pre)}, pose LM launches there "
        f"{sum(r['pose'] for r in host_pre)}")
    check(m.imu_initialized, "mono_vi: the IMU never initialized")
    check(slam.get_tracking_state() == State.OK, "mono_vi: final state not OK")
    check(len(traj) >= N_VI - 10 and np.isfinite(est).all(), "mono_vi: trajectory")
    check(abs(scale - 1.0) < 0.4 and rmse < 0.06, f"mono_vi: Horn scale {scale}, ATE {rmse}")
    check(abs(R[2, 2]) > 0.99, f"mono_vi: not gravity-aligned, R[2,2] {R[2, 2]}")
    check(vel_err < 0.2, f"mono_vi: median KF velocity error {vel_err}")
    check(slam.async_mapper is None or not slam.async_mapper.errors, "mono_vi: mapper errors")
    check(len(fused) >= 1, "mono_vi: no frame took the fused visual-inertial step")
    check(all(r["patch"] == 1 and r["pose"] == 4 and r["vi_solves"] >= 1 for r in fused),
          "mono_vi: a fused VI frame did not make 1 patch-gather and 4 pose-LM launches and a "
          "pose-inertial solve")
    check(sum(r["pose"] for r in host_pre) > 0, "mono_vi: no pose LM on the host path before init")
    return launches


def kb8_pose_solve(dev, cam, n_valid=500, n=768, seed=4):
    """One camera-generic KB8 pose solve at the fisheye host tracker's
    shape (n_valid observations padded to n, f32): its wall time (median
    of 10, synchronised) and the CUDA kernels one solve launches (from
    torch.profiler, which must see at least one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best
    from tpuslam_torch.solve.pose_opt_cuda import _se3_exp

    rng = np.random.RandomState(seed)
    theta = rng.uniform(0.0, np.deg2rad(75.0), n_valid)
    phi = rng.uniform(-np.pi, np.pi, n_valid)
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    X = d * (rng.uniform(1.0, 6.0, n_valid) / d[:, 2])[:, None]
    uv = cam.project_np(X) + rng.randn(n_valid, 2) * 0.5
    uv[: n_valid // 10] += rng.randn(n_valid // 10, 2) * 40
    pad = ((0, n - n_valid), (0, 0))
    dR, dt = _se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.015, 0.01]))
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    args = [dR.to(dev), dt.to(dev)] + [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in (np.pad(X, pad), np.pad(np.concatenate([uv, -np.ones((n_valid, 1))], 1), pad),
                  np.ones(n))] + [torch.zeros(n, dtype=torch.bool, device=dev),
                                  torch.tensor(valid, device=dev),
                                  cam.fx, cam.fy, cam.cx, cam.cy, cam.fx * FISH_BASELINE]
    before = pose_opt_cuda.counter.launches

    def solve():
        return pose_optimize_best(*args, cam=cam.spec)

    R, t, inl, _ = solve()
    torch.cuda.synchronize()
    check(pose_opt_cuda.counter.launches == before, "a KB8 solve launched the pose-LM kernel")
    check(bool(torch.isfinite(R).all()) and int(inl.sum()) > 0.8 * n_valid,
          "the generic KB8 pose solve failed")
    err = float(np.linalg.norm(t.cpu().numpy()))
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(evs, "torch.profiler saw no CUDA kernel in a generic KB8 pose solve")
    busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
    return float(np.median(times)), len(evs), busy, int(inl.sum()), err


def phase_fisheye(dev, smi):
    """System(camera2=, Tlr=).track_stereo over the fisheye rig; returns
    the launch counts."""
    import torch

    from bench_sensors_torch import KB_L, KB_R
    from tpuslam_torch.cameras import KannalaBrandt8
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import orb, patch_cuda
    from tpuslam_torch.solve import pose_opt_dispatch
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    def rig(p):  # bench_sensors_torch's 256 px rig, fx, fy, cx, cy doubled
        return [2 * v for v in p[:4]] + p[4:]

    lap = (0, FISH_WH - 1)
    cam = KannalaBrandt8(rig(KB_L), FISH_WH, FISH_WH, lapping=lap)
    cam2 = KannalaBrandt8(rig(KB_R), FISH_WH, FISH_WH, lapping=lap)
    Trl = np.eye(4)
    Trl[:3, 3] = [-FISH_BASELINE, 0.0, 0.0]
    seq = SyntheticSequence(seed=0, n_frames=N_FISH, fps=FISH_FPS, speed=0.5, camera=cam,
                            camera2=cam2, Trl=Trl)
    t0 = time.perf_counter()
    frames = [(u8(seq.frame(i)), u8(seq.frame(i, right=True))) for i in range(N_FISH)]
    log(f"[fisheye] rendered {N_FISH} KB8 stereo pairs {FISH_WH}x{FISH_WH} in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    bf = cam.fx * FISH_BASELINE
    cfg = SlamConfig(orb=OrbConfig(n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE),
                     tracking=TrackingConfig(min_stereo_init_features=150))
    slam = System(cam, cfg, sensor=Sensor.STEREO, bf=bf, camera2=cam2, Tlr=np.linalg.inv(Trl),
                  device=dev)
    generic = []
    real_solve = pose_opt_dispatch.pose_optimize

    def counted(*a, **kw):  # the camera-generic solves, by frame
        generic[-1] += 1
        return real_solve(*a, **kw)

    gathers = []   # the patch gather's inputs on frame 0: left, then right image
    real_gather = orb.extract_patches_levels

    def captured(levels, yx, budgets, size):
        if len(gathers) < 2:
            gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets), size))
        return real_gather(levels, yx, budgets, size)

    pose_opt_dispatch.pose_optimize = counted
    orb.extract_patches_levels = captured
    GLOBAL_TIMER.samples.clear()
    reset_counts()
    wall, per_frame = [], []
    try:
        for i in range(N_FISH):
            generic.append(0)
            before = patch_cuda.counter.launches
            t1 = time.perf_counter()
            slam.track_stereo(*frames[i], i / seq.fps)
            wall.append((time.perf_counter() - t1) * 1e3)
            per_frame.append(patch_cuda.counter.launches - before)
        slam.shutdown()
        torch.cuda.synchronize()
    finally:
        pose_opt_dispatch.pose_optimize = real_solve
        orb.extract_patches_levels = real_gather
    launches = counts_now()
    # the kernel against its plain version on exactly what this path gave it
    check(len(gathers) == 2, f"fisheye: {len(gathers)} patch gathers captured on frame 0")
    shapes = {side: patch_compare(*g, f"fisheye {FISH_WH}x{FISH_WH} frame 0 {side}")
              for side, g in zip(("left", "right"), gathers)}
    m = slam.map
    n_kf, n_mp = len(m.valid_kf_ids()), int(m.mp_valid[: m.n_mp].sum())
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = gt_centers(seq, traj)
    rmse, _ = ate_rmse(est, gt, False)
    _, scale = ate_rmse(est, gt, True)
    f = m.kf_feats[m.valid_kf_ids()[0]]
    have = f.depth > 0
    depths = f.depth[have]
    ur_err = float(np.abs(f.u_right[have] * f.depth[have] / bf - 1.0).max()) if have.any() else 1.0
    errors = slam.async_mapper.errors if slam.async_mapper is not None else []
    steady = np.array(wall[WARMUP:])
    log(f"[fisheye] state {slam.get_tracking_state().name}, {n_kf} KFs, {n_mp} map points, "
        f"{len(traj)} trajectory rows, ATE {rmse * 100:.3f} cm, Horn scale {scale:.5f}; first "
        f"KF: {int(have.sum())} depths, median {np.median(depths):.3f} m, max |u_right * depth / "
        f"bf - 1| {ur_err:.2e}; mapper errors {len(errors)}")
    log(f"[fisheye] track_stereo wall ms over frames {WARMUP}..{N_FISH - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"first frame {wall[0]:.1f} ms; card {smi}")
    stage_table("fisheye", GLOBAL_TIMER)
    log(f"[fisheye] launches {launches}; patch gather per frame {sorted(set(per_frame))}; "
        f"generic KB8 pose solves per frame: mean {np.mean(generic):.3f}, "
        f"{sorted(set(generic))}")
    solve_ms, n_kernels, busy_ms, n_inl, t_err = kb8_pose_solve(dev, cam)
    log(f"[fisheye] one generic KB8 pose solve (500 observations padded to 768, f32): wall "
        f"{solve_ms:.3f} ms (median of 10, synchronised), {n_inl} inliers, translation error "
        f"{t_err:.3g} m; CUDA kernels per solve {n_kernels}, device busy {busy_ms:.3f} ms "
        f"(torch.profiler)")
    check(slam.get_tracking_state() == State.OK, "fisheye: final state not OK")
    check(n_kf >= 2 and n_mp > 100, f"fisheye: {n_kf} KFs / {n_mp} points")
    check(have.sum() > 50 and ur_err <= 1e-5, "fisheye: first-KF depths or u_right = bf / depth")
    check(len(traj) >= N_FISH - 2 and np.isfinite(est).all(), "fisheye: trajectory")
    check(abs(scale - 1.0) < 0.05 and rmse < 0.08, f"fisheye: ATE {rmse} scale {scale}")
    check(0.5 < np.median(depths) < 8.0 and (depths < 15.0).mean() > 0.8,
          f"fisheye: first-KF depths median {np.median(depths)}")
    check(not errors, f"fisheye: mapper errors {errors}")
    check(per_frame == [2] * N_FISH, f"fisheye: patch-gather launches per frame {per_frame}")
    check(launches["pose_lm"] == 0, f"fisheye: {launches['pose_lm']} pose-LM launches")
    check(sum(generic) >= N_FISH - 1, "fisheye: frames without a generic KB8 pose solve")
    return launches, shapes


class recorded_systems:
    """Keep every System that tpuslam_torch.run.main builds, so the phase
    can read the run's map after the call."""

    def __enter__(self):
        from tpuslam_torch import run

        self.systems, self.saved = [], run.System
        systems, base = self.systems, run.System

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                systems.append(self)

        run.System = Recorded
        return self.systems

    def __exit__(self, *exc):
        from tpuslam_torch import run

        run.System = self.saved


def same_tree(a, b, what, exact_weights=True):
    check(a.k == b.k and a.L == b.L and a.node_level == b.node_level, f"{what}: tree shape")
    check(all(np.array_equal(x, y) for x, y in zip(a.level_descs, b.level_descs)),
          f"{what}: node descriptors differ")
    tol = 0.0 if exact_weights else 1e-6 * max(1.0, float(np.abs(b.word_weight).max()))
    check(a.word_weight.shape == b.word_weight.shape
          and float(np.abs(a.word_weight - b.word_weight).max()) <= tol, f"{what}: word weights")


def phase_cli(dev, smi, images):
    """python -m tpuslam_torch.run on an EuRoC tree written to disk; returns
    the launch counts of run A and run B. images: phase 4's first N_CLI
    rendered stereo pairs, the frames of this phase's sequence."""
    import importlib.util
    import shutil

    import torch

    from tpuslam_torch import _build, run
    from tpuslam_torch.engine.config import OrbConfig
    from tpuslam_torch.engine.frontend import Frontend
    from tpuslam_torch.engine.system import System
    from tpuslam_torch.eval.ate import associate, ate_rmse
    from tpuslam_torch.io import datasets
    from tpuslam_torch.io.settings import load_settings
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.map import checkpoint
    from tpuslam_torch.place import (load_orbvoc, save_orbvoc_binary, save_orbvoc_text,
                                     train_vocabulary)
    from tpuslam_torch.place.store import load_vocabulary, save_vocabulary
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    t_phase = time.perf_counter()
    root = _build.BUILD_DIR.parent / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    tree = root / "euroc"
    spec = importlib.util.spec_from_file_location(
        "make_synth_euroc_torch", _build.ROOT.parent / "scripts" / "make_synth_euroc_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seq = SyntheticSequence(seed=0, n_frames=N_CLI, fps=CLI_FPS, speed=0.5, baseline=BASELINE,
                            height=H, width=W, fx=FX, fy=FY)
    check(np.array_equal(u8(seq.frame(N_CLI - 1, right=True)), images[N_CLI - 1][1]),
          "cli: phase 4's frames are not this sequence's")
    t0 = time.perf_counter()
    yaml_path = script.write_euroc(seq, str(tree), n_features=N_FEATURES, images=images)
    rect_path = root / "rect.yaml"
    with open(yaml_path) as fh:
        rect_path.write_text(fh.read() + script.identity_rectification_yaml(seq))
    log(f"[cli] wrote {N_CLI} stereo frames {W}x{H} (phase 4's renders) + IMU + ground truth "
        f"as a EuRoC tree with scripts/make_synth_euroc_torch.py in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    # the host PNG decode, apart from tracking
    disk = datasets.load_euroc(str(tree), stereo=True, with_imu=True)
    decode = []
    for i in range(len(disk)):
        for read in (disk.frame, disk.frame_right):
            t0 = time.perf_counter()
            img = read(i)
            decode.append((time.perf_counter() - t0) * 1e3)
    check(len(disk) == N_CLI and img.shape == (H, W) and disk.imu is not None
          and disk.gt.shape == (N_CLI, 8), "cli: the tree does not load back")
    log(f"[cli] PNG decode per {W}x{H} image (io/png.py, native unfilter): median "
        f"{np.median(decode):.3f} ms, p90 {np.percentile(decode, 90):.3f} ms over "
        f"{len(decode)} images (host)")

    # a vocabulary trained here, in the reference's two formats and as npz
    cam_cfg = load_settings(yaml_path)
    fe = Frontend(cam_cfg.camera, OrbConfig(n_features=N_FEATURES), device=dev)
    t0 = time.perf_counter()
    descs = []
    for i in range(0, N_CLI, N_CLI // 4):     # frames 0, 10, 20, 30 as in phase 5
        f = fe.process(disk.frame(i))
        descs.append(f.bits[f.valid])
    vocab = train_vocabulary(np.concatenate(descs), k=8, L=3, iters=5, device=dev)
    paths = {ext: str(root / f"voc.{ext}") for ext in ("txt", "bin", "npz")}
    save_orbvoc_text(vocab, paths["txt"])
    save_orbvoc_binary(vocab, paths["bin"])
    save_vocabulary(vocab, paths["npz"])
    from_txt, from_bin = load_orbvoc(paths["txt"]), load_orbvoc(paths["bin"])
    same_tree(from_txt, vocab, "vocabulary .txt")
    same_tree(from_bin, vocab, "vocabulary .bin", exact_weights=False)
    same_tree(load_vocabulary(paths["npz"]), vocab, "vocabulary .npz")
    q = np.concatenate(descs)[:512]
    words = [v.transform(q, np.ones(len(q), bool), device=dev)[0]
             for v in (vocab, from_txt, from_bin)]
    check(all(np.array_equal(w, words[0]) for w in words), "cli: the loaders quantize differently")
    log(f"[cli] vocabulary k=8 L=3 ({vocab.n_words} words) trained on "
        f"{sum(map(len, descs))} descriptors and written as .txt / .bin / .npz in "
        f"{time.perf_counter() - t0:.1f} s; the three loaders give the same tree")

    # run A: stereo, the text vocabulary, --eval, EuRoC format, keyframes,
    # checkpoint, on the card (the default device)
    out = {k: str(root / n) for k, n in (("traj", "a_traj.txt"), ("kf", "a_kf.txt"),
                                         ("ck", "a_map.npz"), ("kitti", "b_traj.txt"))}
    argv = ["--dataset", "euroc", "--path", str(tree), "--settings", yaml_path, "--sensor",
            "stereo", "--vocab", paths["txt"], "--eval", "--format", "euroc", "--output",
            out["traj"], "--kf-output", out["kf"], "--checkpoint", out["ck"]]
    counts = {}
    with recorded_systems() as systems:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # its report is logged below
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["cli"] = counts_now()
    slam = systems[0]
    log(f"[cli A] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[cli A] report {json.dumps(rep)}; run.main wall {wall:.1f} s; card {smi}")
    stage_table("cli A", GLOBAL_TIMER)
    traj = np.loadtxt(out["traj"], ndmin=2)          # t_ns x y z qw qx qy qz
    kfs = np.loadtxt(out["kf"], ndmin=2)
    i_e, i_g = associate(traj[:, 0] * 1e-9, disk.gt[:, 0])
    rmse, _ = ate_rmse(traj[i_e, 1:4], disk.gt[i_g, 1:4], with_scale=False)
    _, scale = ate_rmse(traj[i_e, 1:4], disk.gt[i_g, 1:4], with_scale=True)
    log(f"[cli A] trajectory file: {len(traj)} rows ({len(i_e)} matched to ground truth), "
        f"ATE {rmse * 100:.3f} cm, Horn scale {scale:.5f}; keyframe file {len(kfs)} rows; "
        f"launches {counts['cli']}")
    check(rep["state"] == "OK" and rep["maps"] == 1 and rep["frames"] == N_CLI,
          f"cli A: report {rep}")
    check(rep["ate_rmse"] < 0.05 and rmse < 0.05 and abs(scale - 1.0) < 0.03,
          f"cli A: ATE {rmse} scale {scale}")
    check(len(traj) == len(slam.trajectory_tum()) >= N_CLI - 2 and len(i_e) == len(traj)
          and np.isfinite(traj).all(), "cli A: trajectory file rows")
    check(len(kfs) == rep["keyframes"] == len(slam.map.valid_kf_ids()) >= 2,
          "cli A: keyframe file rows")
    fresh = System(slam.camera, slam.cfg, sensor=slam.sensor, device=dev)
    fresh.load_checkpoint(out["ck"])
    m, m2 = slam.map, fresh.map
    for name in checkpoint._ARRAY_FIELDS + ("scale_factors",):
        check(np.array_equal(getattr(m2, name), getattr(m, name)), f"cli A: checkpoint {name}")
    check(m2.mp_obs == m.mp_obs and m2.covis == m.covis, "cli A: checkpoint mp_obs / covis")
    check(all((a is None) == (b is None) and (a is None or all(
        np.array_equal(getattr(a, k), getattr(b, k)) for k in ("xy", "und_xy", "norm_xy",
                                                               "octave", "bits", "valid")))
        for a, b in zip(m2.kf_feats, m.kf_feats)), "cli A: checkpoint kf_feats")
    log(f"[cli A] checkpoint {os.path.getsize(out['ck'])} bytes loads into a fresh System equal "
        f"to the run's map ({m.n_kf} KFs, {m.n_mp} points)")
    check(counts["cli"]["patch_gather"] == 2 * N_CLI,
          f"cli A: {counts['cli']['patch_gather']} patch-gather launches, not 2 per frame")
    check(counts["cli"]["pose_lm"] > 0, "cli A: no pose-LM launch")

    # run B: identity rectification, two sessions, async + pipelined, KITTI
    argv = ["--dataset", "euroc", "--path", f"{tree},{tree}", "--settings", str(rect_path),
            "--sensor", "stereo", "--async-mapping", "--pipelined", "--format", "kitti",
            "--output", out["kitti"]]
    with recorded_systems() as systems:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["cli_b"] = counts_now()
    slam = systems[0]
    log(f"[cli B] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[cli B] report {json.dumps(rep)}; run.main wall {wall:.1f} s; launches "
        f"{counts['cli_b']}; mapper errors {len(slam.async_mapper.errors)}")
    stage_table("cli B", GLOBAL_TIMER)
    rows = np.loadtxt(out["kitti"], ndmin=2)
    rec = load_settings(str(rect_path)).make_rectifier(dev)
    img_l, img_r = disk.frame(0), disk.frame_right(0)
    got = rec.rectify(img_l, img_r)
    err = max(float((g - torch.as_tensor(im, device=dev)).abs().max())
              for g, im in zip(got, (img_l, img_r)))
    log(f"[cli B] KITTI file {rows.shape}; identity rectification of frame 0 on "
        f"{got[0].device}: max |out - in| {err:.3g} gray levels")
    check(rep["maps"] == 2 and rep["state"] == "OK" and rep["frames"] == 2 * N_CLI,
          f"cli B: report {rep}")
    check(not slam.async_mapper.errors, f"cli B: mapper errors {slam.async_mapper.errors}")
    check(rows.shape == (len(slam.trajectory_tum()), 12) and len(rows) >= 2 * N_CLI - 4
          and np.isfinite(rows).all(), "cli B: KITTI trajectory file")
    check(got[0].device.type == "cuda" and err <= 1e-4, f"cli B: identity rectification {err}")
    check(counts["cli_b"]["patch_gather"] >= 2 * (2 * N_CLI - 2) and counts["cli_b"]["pose_lm"] > 0,
          f"cli B: launches {counts['cli_b']}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[cli] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return counts


def last_json(out):
    """The last JSON object line a tool printed."""
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def phase_tools(dev, smi, seq, frames):
    """Phase 11: the level-0 fused step and the measuring tools
    (bench_frontend_torch, its entry(), bench_torch, bench_sensors_torch),
    each cut to a few frames; returns the launch counts by path and the
    RGB-D row's kernel shapes with their agreement."""
    import torch

    import bench_frontend_torch
    import bench_sensors_torch
    import bench_torch
    from tpuslam_torch.engine import tracking
    from tpuslam_torch.ops import orb
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    t_phase = time.perf_counter()
    counts = {"level0_step": phase_slice(dev, seq, frames, sad="level0")}

    # (b) bench_frontend_torch's chain: 1 patch gather and 1 pose LM a frame
    forward, inputs = bench_frontend_torch.kernel_chain(dev)
    bench_frontend_torch.chain_time(forward, inputs, 1)
    reset_counts()
    dt, inliers, (R, t) = bench_frontend_torch.chain_time(forward, inputs, N_CHAIN)
    counts["frontend_chain"] = counts_now()
    finite = bool(torch.isfinite(R).all()) and bool(torch.isfinite(t).all())
    log(f"[tools] frontend chain over {N_CHAIN} frames: {dt / N_CHAIN * 1e3:.3f} ms/frame "
        f"(host clock, one synchronize), last frame {inliers} inliers, pose finite {finite}, "
        f"launches {counts['frontend_chain']}; card {smi}")
    check(inliers > 0 and finite, "frontend chain: no inliers or a non-finite pose")
    check(counts["frontend_chain"] == {"patch_gather": N_CHAIN, "pose_lm": N_CHAIN},
          f"frontend chain: launches {counts['frontend_chain']} != 1 / 1 per frame")
    fwd, args = bench_frontend_torch.entry(dev)
    reset_counts()
    pose, assoc, rowflags = fwd(*args)
    torch.cuda.synchronize()
    counts["graft_entry"] = counts_now()
    log(f"[tools] entry(): one fused step on the graft entry inputs, pose "
        f"{pose[:12].cpu().numpy().round(4).tolist()}, {int(pose[12])} inliers, launches "
        f"{counts['graft_entry']}")
    check(pose.shape == (13,) and bool(torch.isfinite(pose).all()) and assoc.shape == (N_FEATURES,)
          and rowflags.shape == (2 * P_BASE,), "entry(): bad outputs")
    check(counts["graft_entry"] == {"patch_gather": 2, "pose_lm": 4},
          f"entry(): launches {counts['graft_entry']} != 2 / 4")

    # (c) bench_torch's System run, cut to N_BENCH frames and one pass
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        med = bench_torch.main(["--frames", str(N_BENCH), "--passes", "1"])
    counts["bench_system"] = counts_now()
    row = last_json(out.getvalue())
    log(f"[tools] bench_torch --frames {N_BENCH} --passes 1 ({time.perf_counter() - t0:.1f} s, "
        f"rendering included): {json.dumps(row)}; pass {med}; launches "
        f"{counts['bench_system']}; card {smi}")
    check(set(row) == {"metric", "value", "unit", "vs_baseline"}
          and row["metric"] == "system_track_stereo_fps_752x480_1024feat" and row["value"] > 0,
          f"bench_torch: JSON line {row}")
    check(med["state"] == "OK" and med["kfs"] >= 3, f"bench_torch: pass {med}")
    check(min(counts["bench_system"].values()) > 0,
          f"bench_torch: a kernel was never launched: {counts['bench_system']}")

    # (d) bench_sensors_torch's RGB-D row: a pose LM on every frame. Frame
    # 0's patch-gather inputs and the first host pose solve at each padded
    # row count are captured, to hold both kernels on this path's own shapes
    gathers, solves = [], {}
    real_gather, real_solve = orb.extract_patches_levels, tracking.pose_optimize

    def captured_gather(levels, yx, budgets, size):
        if not gathers:
            gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets), size))
        return real_gather(levels, yx, budgets, size)

    def captured_solve(*a, **kw):
        solves.setdefault(a[2].shape[0], ([x.clone() if torch.is_tensor(x) else x for x in a],
                                          kw))
        return real_solve(*a, **kw)

    orb.extract_patches_levels, tracking.pose_optimize = captured_gather, captured_solve
    reset_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            bench_sensors_torch.main(["--sensors", "rgbd", "--frames", str(N_SENSORS)])
    finally:
        orb.extract_patches_levels, tracking.pose_optimize = real_gather, real_solve
    counts["sensors_rgbd"] = counts_now()
    row = last_json(out.getvalue())
    log(f"[tools] bench_sensors_torch --sensors rgbd --frames {N_SENSORS}: {json.dumps(row)}; "
        f"launches {counts['sensors_rgbd']}; card {smi}")
    check(row["metric"] == "system_track_rgbd_376x240_700feat_fps" and row["state"] == "OK"
          and row["value"] > 0, f"bench_sensors_torch: row {row}")
    check(counts["sensors_rgbd"]["pose_lm"] >= 2 * N_SENSORS - 2
          and counts["sensors_rgbd"]["patch_gather"] >= 2 * N_SENSORS,
          f"bench_sensors_torch: launches {counts['sensors_rgbd']}")
    # both kernels against their plain versions on what this path gave them
    check(len(gathers) == 1 and solves, f"RGB-D row: {len(gathers)} gathers, {len(solves)} "
                                        f"pose solves captured")
    shapes = {"patch_gather": patch_compare(*gathers[0], "RGB-D row 376x240 frame 0")}
    for n, (a, kw) in sorted(solves.items()):
        eR, et, agree, _, rounds = pose_lm_compare(pose_optimize_best, a, f"RGB-D row N={n}", kw)
        shapes[f"pose_lm_{n}"] = dict(n=n, valid=int(a[6].sum()), stereo=int((a[5] & a[6]).sum()),
                                      dR=eR, dt=et, agreement=agree,
                                      steps=[r["steps"] for r in rounds])
        log(f"[tools] RGB-D row pose LM, first solve at N={n} ({shapes[f'pose_lm_{n}']['valid']} "
            f"valid rows): |dR| {eR:.3g} |dt| {et:.3g} inlier agreement {agree:.4f}")
    log(f"[tools] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return counts, shapes


def main():
    import torch

    t_start = time.perf_counter()

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
    from tpuslam_torch import _build, native
    from tpuslam_torch.io.synthetic import SyntheticSequence

    # build every kernel and the native map core from the sources here
    t0 = time.perf_counter()
    _build.LIB.unlink(missing_ok=True)
    _build.build(verbose=True)
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s (nvcc, one "
        f"process per source, {_build.build_seconds:.1f} s)")
    for kernel in ("pose_lm_kernel", "patch_gather_kernel"):
        regs, stack, st, ld = ptxas_report(_build.build_log, kernel)
        log(f"[build] {kernel}: {regs} registers, {stack} bytes stack frame, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
        check(kernel != "pose_lm_kernel" or stack == st == ld == 0,
              "the pose LM kernel has a stack frame or spills")
    native.LIB.unlink(missing_ok=True)
    check(native.available(), "the native map core did not build or load")
    log(f"[build] native map core built and loaded from "
        f"{native.LIB.relative_to(_build.ROOT.parent)}")

    seq = SyntheticSequence(n_frames=N_SYSTEM, fps=20, speed=0.5, baseline=BASELINE,
                            height=H, width=W, fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = [(u8(seq.frame(i)), u8(seq.frame(i, right=True))) for i in range(N_SYSTEM)]
    log(f"[render] {N_SYSTEM} stereo frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host)")
    records = phase_kernels(dev, seq)
    by_path = {"fused_step": phase_slice(dev, seq, frames)}
    by_path.update(phase_system(dev, seq, frames, smi))
    cli_images = frames[:N_CLI]
    del frames
    loop_frames = render_loop()
    by_path["mono_loop"] = phase_mono_loop(dev, smi, loop_frames)
    by_path["rgbd"] = phase_rgbd(dev, smi)
    by_path["mono_vi"] = phase_mono_vi(dev, smi)
    by_path["fisheye_stereo"], fish_shapes = phase_fisheye(dev, smi)
    by_path.update(phase_cli(dev, smi, cli_images))
    by_path["mono_loop_dist"] = phase_dist(dev, smi, loop_frames)
    tools, rgbd_shapes = phase_tools(dev, smi, seq, cli_images)
    by_path.update(tools)
    patch, lm = records
    patch["fisheye_shapes"] = fish_shapes
    patch["sensors_rgbd_shapes"] = rgbd_shapes.pop("patch_gather")
    patch["max_abs_err"] = max([patch["max_abs_err"], patch["sensors_rgbd_shapes"]["max_abs_err"]]
                               + [r["max_abs_err"] for r in fish_shapes.values()])
    lm["sensors_rgbd_shapes"] = rgbd_shapes
    lm["max_abs_err"] = max([lm["max_abs_err"]]
                            + [max(r["dR"], r["dt"]) for r in rgbd_shapes.values()])
    frames_by_path = {"fused_step": N_FRAMES - 1, "a_sync": N_SYSTEM,
                      "b_async_pipelined": N_SYSTEM, "mono_loop": N_LOOP,
                      "mono_loop_dist": N_LOOP, "rgbd": N_RGBD,
                      "mono_vi": N_VI, "fisheye_stereo": N_FISH, "cli": N_CLI,
                      "cli_b": 2 * N_CLI, "level0_step": N_FRAMES - 1,
                      "frontend_chain": N_CHAIN, "graft_entry": 1, "bench_system": 2 * N_BENCH,
                      "sensors_rgbd": 2 * N_SENSORS}
    for r in records:
        r["launches"] = sum(c[r["name"]] for c in by_path.values())
        r["launches_by_path"] = {k: c[r["name"]] for k, c in by_path.items()}
        r["launches_per_frame"] = {k: c[r["name"]] / frames_by_path[k]
                                   for k, c in by_path.items()}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
