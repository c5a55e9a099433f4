"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full size: 752x480, 1024 ORB features, 8
levels at scale 1.2 (the dataset routes of phase 18 at their published
sizes), stereo, monocular with loop closing, RGB-D,
mono-inertial (sync and async), fisheye stereo, the dataset CLI, the
distributed BA, the measuring tools, stereo-inertial, TUM-VI's fisheye
stereo-inertial and mono-inertial routes, the inertial mapper's whole
IMU schedule, the multi-session stereo-inertial merge, and the mapper on
its own thread for stereo-inertial SLAM and across both merges, the
multi-session monocular merge, the multi-session mono-inertial merge, and
the dataset CLI on KITTI (stereo and mono), TUM RGB-D and the fork's CSV.
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
     sequence of tests/test_e2e_loop.py at 752x480, 104 frames (its 92 and
     1.5 s more of the second lap), with frames 20..24 on the host
     tracking path: it must end OK, close at
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
     (b) the same run on the same renders with async_mapping=True (the
     mapper, IMU init and VI BAs on the worker thread) under the bounded
     back-pressure of tests/test_async_mapping.py (at most 2 s waiting for
     the queue to fall to 2 keyframes), then flush() and shutdown():
     tpuslam's async gates (IMU initialized, OK, scaled ATE under 8 cm),
     no worker errors, at least one async handshake
     (Tracker._sync_imu_from_map) that rebased the last frame, both
     kernels launched; 7 and (b) each render the frames and run in a
     process of their own (PhaseInChild) beside phases 3-8;
  8. fisheye stereo: System(camera2=, Tlr=).track_stereo at TUM-VI's
     512x512 over 20 frames at 20 fps (0.5 m/s) rendered by the port's
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
     Run C, two sessions over one place merged into one Atlas map (EuRoC's
     MH01 -> MH02): run A's tree, then phase 4's frames 20..59 written as a
     second tree (scripts/make_synth_euroc_torch.SessionView: stamped from
     100 s, its ground truth in the same world), `--path A,B --sensor
     stereo --vocab <.txt>` (synchronous mapping, background GBA): OK,
     one map, exactly one merge (recorded on LoopCloser._correct_loop),
     inside the second session, one loop closed, a joint unscaled ATE of
     both sessions' rows against both trees' ground truth under 5 cm,
     exactly 2 patch-gather launches per frame and pose-LM launches; the
     merge frame, the stage table (loop, loop.correct, gba.solve,
     gba.apply), the host ms of each call of the loop closer's solvers
     and each session's median and p90 frame ms are printed. Run D, run C's
     command with `--async-mapping --pipelined` (bench.py's configuration
     across the session boundary): run C's gates and no worker error; the
     merge's frame against run C's, the frames tracked, lost and
     relocalized after the correction (which runs on the mapping thread),
     each session's median and p90 frame ms and the longest frame wall are
     printed. Run E, in a process of its own beside runs C-D and phase 10
     (chip_smoke.phase_cli_e): run C's trees as two MONOCULAR sessions
     (`--sensor mono --path A,B --vocab <.txt>`, the multi-session line of
     scripts/euroc_examples_torch.sh), each map at the scale of its own
     two-view init, the merge a Sim3 with a free scale: OK, one map,
     exactly one merge inside the second session, every frame from it on
     OK (none lost or relocalized), nothing left in the young map, a joint
     scaled ATE under 0.10 and the two sessions' Horn scales (each aligned
     alone) within 5 % of each other, 1 patch gather per frame and 4 pose
     LMs per fused frame; the merge's frame, keyframe pair, Sim3 scale and
     loop.correct ms are printed, and on the first fused frame after the
     merge both kernels are held against their plain versions (the gather
     bitwise, the 4 pose-LM calls with phase 2's tolerances) and timed. Its
     control, the same command without a vocabulary: 2 maps, OK, the
     sessions' Horn scales more than 5 % apart.
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
 12. stereo-inertial: System.track_stereo(..., imu=) on an IMU_STEREO
     System over 34 frames of the heave sequence (tests/torch_vi_heave.py:
     vi_excite plus a 0.10 m vertical heave at 4 rad/s, which passes the
     stereo-inertial init gate; 10 fps, 0.5 m/s, IMU at 200 Hz) at 752x480
     with the phase constants' rig (fx = fy = 458, baseline 0.11 m),
     phase 7's ImuCalib and radii, f32 solvers: the stereo init on the
     gate, the IMU init in the mapper, then the fused visual-inertial step.
     It must end OK with the IMU initialized, an unscaled ATE under 5 cm, a
     Horn scale within 3 % of 1, |R[2, 2]| > 0.99, a median keyframe-
     velocity error under 0.2 m/s and no mapper errors; every frame makes
     exactly 2 patch-gather launches, host frames before the IMU init
     launch the pose LM, and every fused visual-inertial frame makes 4
     pose-LM launches and one pose_inertial_solve. A frame after the init
     that falls back to the host path is counted and printed; at least one
     must take the fused step. The 4 pose-LM calls of the first fused VI
     frame are kept and held against the plain version (phase 2's
     tolerances), and the last (4 rounds) timed as in phase 2. (b) the
     same over 42 frames with async_mapping=True (the mapper, its IMU init and inertial
     BAs on the worker thread) under phase 7 (b)'s bounded back-pressure,
     in a process of its own beside phases 9-12: phase 12's gates,
     at least one handshake rebase, no worker error, and both kernels held
     on the first fused VI frame after the async IMU init (its two patch
     gathers bitwise); the IMU init frame, the pose_inertial stage and the
     longest frame wall are printed against phase 12's;
 13. fisheye stereo-inertial, TUM-VI's main configuration:
     System(KB8, IMU_STEREO, camera2=, Tlr=).track_stereo(..., imu=) over
     36 frames of the heave sequence seen by phase 8's rig
     (tests/torch_fisheye_rig.py at 512x512, 0.2 m baseline), at 10 fps
     (cut from TUM-VI's 20 Hz: the IMU init needs 10 keyframes and 2 s of
     them), IMU at 200 Hz, phase 7's ImuCalib, 1024 features, the CPU
     tests' radii scaled from 256 px, f32 solvers. Every frame takes the
     host path: the camera-generic KB8 pose solves before the IMU init,
     pose_inertial_solve with the KB8 camera after it. It must end OK with
     the IMU initialized, an unscaled ATE under 8 cm, a Horn scale within
     3 % of 1, |R[2, 2]| > 0.99, a median keyframe-velocity error under
     0.2 m/s and no mapper errors; every frame makes exactly 2 patch-gather
     launches, the phase no pose-LM launch, every tracked frame before the
     init a camera-generic solve and every frame after it (at least 6) a
     KB8 pose_inertial_solve. The patch gather is held bitwise against its
     plain version on frame 0's left and right inputs and timed as in
     phase 2. The stereo-init and IMU-init frames, the errors, the stage
     table and the host frame times before and after the init are printed;
 14. fisheye mono-inertial (TUM-VI's `--sensor mono_imu`):
     System(KB8, IMU_MONOCULAR).track_monocular(..., imu=) over 33 frames
     of vi_excite seen by the rig's left camera, phase 13's settings:
     phase 7's gates (IMU initialized, OK, Horn scale within 0.4 of 1,
     scaled ATE under 6 cm, |R[2, 2]| > 0.99, median keyframe-velocity
     error under 0.2 m/s), exactly 1 patch-gather launch per frame, no
     pose-LM launch, phase 13's solver routes, the patch gather held
     against its plain version on frame 0, and phase 13's figures with the
     two-view init frame. Phases 13 and 14 run in processes of their own
     beside phases 9-12.
 15. the inertial mapper's whole schedule: scripts/vi_f32_experiment_torch.
     run (tpuslam's vi_f32_experiment.py run: mono-inertial on vi_excite at
     0.3 m/s, 376x240, 600 features, IMU at 200 Hz, f32) over 64 frames with
     the schedule shortened to the script's SHORT_SCHEDULE (VIBA1 0.5 s and
     VIBA2 1.0 s after the IMU init, for 5 s and 15 s): it must end OK with
     the IMU initialized, the mapper's events imu_init, viba1, viba2 in that
     order, at least one scale refinement and one local inertial BA with
     zero bias priors after VIBA2, the script's RESULT rule (scaled ATE
     under 0.15 m, OK, trajectory rows over 0.9 x frames), |R[2, 2]| > 0.99
     and finite keyframe poses, velocities and biases; every fused
     visual-inertial frame makes 1 patch-gather and 4 pose-LM launches and
     at least one pose_inertial_solve. The script prints the events, the
     refinements, the largest |R^T R - I| of the keyframes and the stage
     ms. Both kernels are held against their plain versions on what this
     path gave them: frame 0's patch gather (K = 600 over 8 levels of
     376x240, bitwise) and the first fused VI frame's 4 pose-LM calls
     (mono rows, phase 2's tolerances), the last of them timed as in
     phase 2. It runs in a process of its own (PhaseInChild) started after
     phase 2, beside phases 3-10, so its times are taken while the phases
     share the host's cores and the card. The script's full 220-frame
     runs take ~10 min each on an H100, so they run on their own, not
     here;
 16. two stereo-inertial sessions over one place merged into one Atlas
     map (tests/torch_vi_merge.py; 752x480, 1024 features, f32): (a) its
     heave_sessions, the second session trailing the first by 6 frames so
     that it sees the first long before its own IMU init, written as two
     EuRoC trees with IMU and run by `run.main --sensor stereo_imu --path
     A,B --vocab` (a vocabulary trained here; the settings make a keyframe
     at least every 10 frames, so each session is ~8-10 s); (b) its
     loop_sessions, the second session coming round a circle to the first
     only after its own IMU init and VIBA1 (the short schedule), through
     System.track_stereo(..., imu=). Each must make exactly one merge,
     inside the second session and with its IMU initialized ((b): after
     VIBA1), the map count 2 -> 1, end OK with nothing left in the young
     map, and pass the stereo-inertial gates on one alignment of both
     sessions' rows (unscaled ATE under 5 cm, Horn scale within 3 %,
     |R[2, 2]| > 0.99, median KF velocity error under 0.2 m/s, finite
     keyframe states); every frame makes 2 patch-gather launches, every
     fused VI frame 4 pose-LM launches and one pose_inertial_solve. On the
     first fused VI frame after the merge both kernels are held against
     their plain versions (its two patch gathers bitwise, its 4 pose-LM
     calls with phase 2's tolerances) and timed. The IMU events, the merges
     aborted before the young map's init, the merge's Sim3 scale and the
     rotation the yaw projection removed, the weld's size, the stage table
     and the second session's frame ms before and after the merge are
     printed. Both branches run in processes of their own (PhaseInChild)
     beside phases 9-12. Branch (b) runs
     a second time (its second session 74 frames) with async_mapping=True
     (the merge's detection, correction, weld BA and FullInertialBA on the
     mapping thread) under phase 7 (b)'s bounded
     back-pressure, with (b)'s gates and no worker error; the merge's frame,
     the correction's ms and the longest frame wall of the second session
     while the correction holds the map lock are printed against (b)'s;
     this run is started after phase 2, beside phases 3-8. Every branch also prints which rows carry its joint ATE: the RMS of
     the first session's rows, of the second's before the merge and from
     it on, and the 8 largest row errors with their frame, how many frames
     from the merge's and whether the frame overlapped the correction;
 17. two mono-inertial sessions over one place merged into one Atlas map
     (tests/torch_mono_vi_merge.py: tests/torch_vi_merge.py's loop_sessions
     seen by the left camera; 752x480, 1024 features, f32, IMU at 200 Hz, a
     keyframe at least every 3 frames, the IMU init after 6 keyframes over
     1 s and VIBA1 / VIBA2 0.5 / 1.0 s after it): the first session runs
     its two-view init, IMU init, VIBA1 and VIBA2, the second comes round
     to the first's arc just after its own two-view init and IMU init,
     through System(sensor=IMU_MONOCULAR, vocab=).track_monocular(..., imu=)
     with change_dataset() between them. It must make exactly one merge,
     inside the second session and after its IMU init, the map count 2 ->
     1, end OK with the IMU initialized and nothing left in the young map,
     and pass the mono-inertial gates on one alignment of both sessions'
     rows (scaled ATE under 6 cm, Horn scale within 0.4 of 1, |R[2, 2]| >
     0.99, median KF velocity error under 0.2 m/s) with the two sessions'
     Horn scales (each aligned alone) within 5 %; every frame makes 1
     patch-gather launch, every fused VI frame 4 pose-LM launches and one
     pose_inertial_solve. On the first fused VI frame after the merge both
     kernels are held against their plain versions (the gather bitwise, the
     4 pose-LM calls with phase 2's tolerances) and timed. The IMU events of
     each session, the merges aborted, the rotation the yaw projection
     removed, each map's Horn scale just before the correction, the weld's
     size, the stage table and the second session's frame ms before and
     after the merge are printed. Its control, the same sessions without a
     vocabulary cut to the frames before each session's IMU init (A's
     first 24, B's first 8): 2 maps, OK, no merge, run after it in the same
     process of its own, beside phases 3-10 and 15;
 18. the dataset CLI's other formats at their published sizes, each tree
     rendered here, written by scripts/make_synth_euroc_torch.py under a
     temporary directory of build/ and run through run.main on the card
     (tests/torch_datasets.py's sequences and gates): (a) KITTI00-02
     stereo: 1241x376, fx 718.856, bf 386.1448, 2000 features, 40 frames
     at 10 fps through the room at 1 m/s, `--format kitti --kf-output`: OK,
     one map, one 12-value KITTI row per frame, an unscaled ATE under 5 cm
     and a Horn scale within 3 % of 1 from those rows, 2 patch gathers per
     frame and 4 pose LMs per fused frame; (b) the same sequence's image_0
     with KITTI00-02's monocular file over its first 20 frames (1.9 m; the
     mono gate was set on a 1.4 m path): the two-view init's frame printed,
     tests/test_e2e_mono.py's gates (OK, >= 3 keyframes, > 100 map points,
     >= 8 rows, scaled ATE under 0.10); (c) TUM3 RGB-D: 640x480, 40 frames
     at 30 fps, 0.5 m/s, colour PNGs, uint16 depth at 5000 per metre
     (DepthMapFactor applied once), epoch stamps, ground truth at 100 Hz,
     `--eval`: OK, the report's ate_rmse under 5 cm, the rows' Horn scale
     within 3 % of 1, a pose-LM launch on every frame but the first; (d)
     phase 9's 752x480 left frames as the fork's CSV (seq.csv with ns
     stamps from EuRoC MH01's first): the mono gates, and the rows' stamps
     the CSV's seconds. On (a)'s first fused frame (2 patch gathers, 4
     pose-LM calls at N = 2000, the first launch above 48 KB of shared
     memory) and (c)'s first host frame (its patch gather and the host
     tracker's pose solves) both kernels are held against their plain
     versions (the gather bitwise, the pose LM with phase 2's tolerances
     and every inlier flag equal) and timed as in phase 2 beside their
     bounds. Runs in a process of its own, started after phase 2 beside
     phases 3-10.
Trajectory errors use tpuslam_torch.eval.ate (Horn alignment).
The last lines are the kernels' JSON record (with launches by path and
per frame, phase 10's mono loop as mono_loop_dist, phase 11's paths as
level0_step, frontend_chain, graft_entry, bench_system and
sensors_rgbd, and phase 11 (d)'s shapes as sensors_rgbd_shapes; phase 7
(b) as mono_vi_async, phase 9's runs as cli, cli_b and cli_c, phase 12 as
stereo_vi with its first fused frame's
pose-LM calls as stereo_vi_shapes, phases 13-14 as fisheye_stereo_vi and
fisheye_mono_vi with their frame-0 patch gathers in fisheye_shapes, phase
15 as vi_schedule with its kernel inputs in vi_schedule_shapes, phase 16
as vi_merge_a and vi_merge_b with the kernel inputs of their first fused VI
frame after the merge in vi_merge_shapes; phase 12 (b) as stereo_vi_async
with its first fused VI frame's kernel inputs as stereo_vi_async_shapes,
phase 9's run D as cli_d, phase 16 (b) async as vi_merge_b_async, phase
9's run E as cli_e with the kernel inputs of its first fused frame after the
merge as cli_e_shapes, phase 17 as mono_vi_merge with the kernel inputs of
its first fused VI frame after the merge as mono_vi_merge_shapes, phase 18
as kitti_stereo, kitti_mono, tum_rgbd and csv_mono with the kernel inputs of
(a)'s first fused frame and (c)'s first host frame as datasets_shapes), the
nvidia-smi line
and {"ok": true, "device": {...}}. Needs one CUDA card; fails without one.
"""

import contextlib
import io
import json
import os
import sys
import time

import numpy as np

from tpuslam_torch.utils.probes import gt_centers, nvidia_smi_line, vi_counts

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
# phase 5: the loop sequence of tests/test_e2e_loop.py, 12 frames past its 92. The
# lap ends on frame 80.4; on an H100 the loop is first detected on frame 84-86 and
# closes two frames later (three keyframes in a row confirm it), so over 92 frames a
# detection broken once has no keyframes left to be confirmed on
N_LOOP = 104
LOOP_RELOC_FRAME = 132  # phase 5: the unseen second-lap frame that must relocalize
LOOP_HOST_PATH = range(20, 25)  # phase 5: frames tracked by the host path
CIRCUMFERENCE = 2 * np.pi * 1.6
N_RGBD = 40            # phase 6
N_VI = 55              # phase 7: the frames of tests/test_e2e_mono_inertial.py
VI_NOISE = dict(noise_gyro=1e-4, noise_acc=1e-3, walk_gyro=1e-6, walk_acc=1e-5)
N_FISH, FISH_FPS, FISH_WH = 20, 20, 512   # phase 8: TUM-VI's camera rate and size
FISH_BASELINE = 0.2
N_CLI, CLI_FPS = 40, 20   # phase 9: the EuRoC tree written to disk
# phase 9 run C: the second session, phase 4's frames 20..59, stamped from
# 100 s (after all of the first session's, as EuRoC's MH02 follows MH01)
CLI_B_START, CLI_B_T0 = 20, 100.0
# phase 9 run E (the same trees, --sensor mono): tests/test_e2e_mono.py's scaled
# ATE gate on this room, and how close the two sessions' Horn scales must come
MONO_ATE_GATE, MONO_SCALE_AGREE = 0.10, 0.05
N_DIST_RANKS = 4       # phase 10 (b, c): gloo ranks sharing the card
DIST_TIMEOUT = 300.0   # phase 10: every group's collectives and every rank's run (s)
N_CHAIN = 16           # phase 11 (b): frames of bench_frontend_torch's chain
N_BENCH = 40           # phase 11 (c): bench_torch's frames (a warm pass and one timed)
N_SENSORS = 20         # phase 11 (d): bench_sensors_torch's RGB-D frames (two passes)
N_STEREO_VI = 34       # phase 12: frames of the heave sequence (tests/torch_vi_heave.py)
# phase 12 (b): the async IMU init lands some frames after the synchronous
# run's (after frame 28), so (b) runs 8 frames more for its fused VI frames
N_STEREO_VI_ASYNC = 42
# phases 13-14: TUM-VI's fisheye visual-inertial routes at FISH_WH, cut from
# TUM-VI's 20 Hz to 10 fps: the IMU init needs 10 keyframes and 2 s of them
N_FISH_STEREO_VI, N_FISH_MONO_VI, FISH_VI_FPS = 36, 33, 10   # the IMU init + ~7-8 frames
# phase 15: frames of scripts/vi_f32_experiment_torch.py's run. Its RESULT rule
# wants trajectory rows > 0.9 x frames; at 0.3 m/s the two-view init takes 6
# frames on the card and on the CPU, so 64 frames leave 58 rows against 57.6.
# The shortened schedule ends by ~45
N_VI_SCHEDULE = 64
# phase 16: (A's frames, the second session's first frame in the sequence, its
# frames) of branch a (tests/torch_vi_merge.py's heave_sessions through the
# CLI, whose settings make a keyframe at least every 10 frames: A's IMU
# initializes on its frame 79, B's on its frame 83, the merge two keyframes
# later on B's frame 103) and branch b (its loop_sessions, a keyframe at least
# every 3 frames: C's init on its frame 25, the merge on its frame 58); each
# second session ends ~10 frames after its merge. b_async: branch b with the
# mapper on its own thread, whose merge lands some frames later
N_VI_MERGE = {"a": (84, 6, 114), "b": (33, 45, 68), "b_async": (33, 45, 74)}
# phase 17: tests/torch_mono_vi_merge.py's sessions (A's frames, B's first frame in
# the sequence, B's frames). A runs 41 frames against the CPU tests' 26: at 752x480 and
# fx = 458 its two-view init comes on its frame 16, not 5 (376x240, fx = 200), its IMU
# init on 25-27, VIBA1 6 frames and VIBA2 11 frames later; B from 90 (the CPU tests:
# 88) is recognised after its VIBA1 and before its VIBA2 (from 88: after its VIBA2;
# from 92 or 94 its two-view init waits until its frame 30 on an H100)
N_MONO_VI_MERGE = (41, 90, 26)
# phase 17's control without a vocabulary: each session cut to the frames
# before its IMU init (A's two-view init on its frame 16 and IMU init on its
# 25-27, B's on its 3 and 10 on the H100), so that it runs no fused VI
# frame and no IMU stage
N_MONO_VI_CONTROL = (24, 8)
N_KITTI, KITTI_SPEED = 40, 1.0   # phase 18 (a): KITTI00-02 frames at 10 fps
# phase 18 (b): the frames of the mono route, 1.9 m at 1 m/s (tests/test_e2e_mono.py's
# scaled-ATE gate was set on a 1.4 m path; over all 40 frames, 3.84 m, it read 18.2 cm)
N_KITTI_MONO = 20
N_TUM = 40                       # phase 18 (c): TUM3 frames at 30 fps, 0.5 m/s
RENDER_WORKERS = 7     # host processes that render a phase's frames (the card host has 8 cores)


def log(*a):
    print(*a, flush=True)


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


def pose_lm_bytes(n):
    """Bytes one pose LM solve over n rows must move: X, uvr, inv_sigma2 and
    the two masks in, the pose in and out, the inlier flags and chi2 out."""
    return n * (3 * 4 + 3 * 4 + 4 + 1 + 1) + 2 * (9 + 3) * 4 + n * (1 + 4)


def pose_lm_times(wrapper, kernel, plain):
    """(host-inclusive ms of wrapper(), device-only ms of kernel(), ms of
    plain()), medians over the turns kernel, plain, plain, kernel."""
    t = {"kernel": [], "plain": []}
    for what in ("kernel", "plain", "plain", "kernel"):
        if what == "kernel":
            t["kernel"].append((median_ms(wrapper), device_ms(kernel)))
        else:
            t["plain"].append(median_ms(plain, n=10))
    return (float(np.median([x[0] for x in t["kernel"]])),
            float(np.median([x[1] for x in t["kernel"]])), float(np.median(t["plain"])))


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


def _render_part(seq, idx, kind):
    """Frames idx of seq, rendered in a worker process: uint8 images,
    uint8 stereo pairs ("stereo") or (uint8 image, depth) ("rgbd")."""
    if kind == "rgbd":
        return [(u8(img), depth) for img, depth in (seq.frame_rgbd(i) for i in idx)]
    if kind == "stereo":
        return [(u8(seq.frame(i)), u8(seq.frame(i, right=True))) for i in idx]
    return [u8(seq.frame(i)) for i in idx]


_render_pool = None


def stop_render_pool():
    """End render()'s worker processes (main() does so before it returns)."""
    global _render_pool
    if _render_pool is not None:
        _render_pool.shutdown()
        _render_pool = None


def _phase_in_child(queue, name, args):
    """Body of PhaseInChild's process: run phase function `name`(*args) and
    put ("ok", what it returned) or ("error", the traceback) on queue. The
    kernels and the native map core load from what the parent built."""
    import traceback

    try:
        queue.put(("ok", globals()[name](*args)))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
    finally:
        stop_render_pool()


class PhaseInChild:
    """Phase function `name`(*args) in a spawned process of its own, beside
    the parent's next phases: every phase is bound by the host, and the card
    idles most of the time. result() waits for it and returns what the
    phase returned; a phase that raised raises here."""

    def __init__(self, name, *args):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.name, self.queue = name, ctx.Queue()
        self.proc = ctx.Process(target=_phase_in_child, args=(self.queue, name, args))
        self.proc.start()

    def result(self, timeout=1200.0):
        import queue

        try:
            status, value = self.queue.get(timeout=timeout)
        except queue.Empty:
            status, value = "error", f"no result in {timeout} s, exit code {self.proc.exitcode}"
        finally:
            self.proc.join(timeout=60.0)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join()
        check(status == "ok", f"{self.name} in its own process failed:\n{value}")
        return value


def render(seq, n, kind="mono", only=None):
    """Frames 0..n-1 of seq (see _render_part), in order; only: the frames
    to render (the others None). The renderer is
    numpy on the host, one frame at a time, so RENDER_WORKERS spawned
    processes share the frames. They are started on the first call and kept
    for the next phases (each takes seconds to import before its first
    frame) until stop_render_pool()."""
    global _render_pool
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    if _render_pool is None:
        _render_pool = ProcessPoolExecutor(RENDER_WORKERS,
                                           mp_context=multiprocessing.get_context("spawn"))
    idx = list(range(n)) if only is None else sorted(only)
    parts = [idx[w::RENDER_WORKERS] for w in range(RENDER_WORKERS)]
    done = list(_render_pool.map(_render_part, [seq] * RENDER_WORKERS, parts,
                                 [kind] * RENDER_WORKERS))
    frames = [None] * n
    for part, got in zip(parts, done):
        for i, frame in zip(part, got):
            frames[i] = frame
    return frames


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
    plain_kw = {k: v for k, v in (kw or {}).items() if k == "n_rounds"}
    Rp, tp, ip, _ = pose_opt_cuda.pose_optimize_plain(*args32, rounds=rounds, **plain_kw)
    torch.cuda.synchronize()
    Rk, tk, ik, ck = out
    eR = float((Rk - Rp).abs().max())
    et = float((tk - tp).abs().max())
    agree = float((ik == ip).float().mean())
    check(eR <= 1e-4 and et <= 1e-3 and agree >= 0.99,
          f"pose LM {what}: kernel vs plain out of tolerance (|dR| {eR}, |dt| {et}, {agree})")
    check(not bool(ik[~args[6]].any()), f"pose LM {what}: an invalid row is an inlier")
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
        host_ms, dev_ms, plain_ms = pose_lm_times(
            wrapper, fused, lambda: pose_opt_cuda.pose_optimize_plain(*args32))
        n = args[2].shape[0]
        st = args[5] & args[6]
        n_valid_by = {"mono": n_valid - int(st.sum()), "stereo": int(st.sum())}
        steps = [r["steps"] for r in rounds]
        in_use = [(r["mono"], r["stereo"]) for r in rounds]
        n_flops = pose_lm_ops(rounds, n_valid_by)
        n_bytes = pose_lm_bytes(n)
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


def loop_sequence():
    from tpuslam_torch.io.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=N_LOOP, fps=8, speed=1.0, kind="loop", height=H, width=W,
                             fx=FX, fy=FY)


def render_loop():
    """The N_LOOP frames of loop_sequence() (phases 5 and 10)."""
    seq = loop_sequence()
    t0 = time.perf_counter()
    frames = render(seq, N_LOOP)
    log(f"[mono_loop] rendered {N_LOOP} frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host, "
        f"{RENDER_WORKERS} processes)")
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
    wall, timeline, seen = [], [], None
    for i, t in enumerate(seq.timestamps()):
        slam.tracker.fused_enabled = i not in LOOP_HOST_PATH
        t1 = time.perf_counter()
        slam.track_monocular(frames[i], t)
        wall.append((time.perf_counter() - t1) * 1e3)
        # the loop closer's common region as this frame left it: (frame,
        # candidate keyframe, confirmations, misses in a row, loops closed)
        p = slam.loop_closer.pending
        now = (None if p is None else (p["cand"], p["count"], p["not_found"]),
               slam.loop_closer.n_loops_closed)
        if now != seen:
            timeline.append((i,) + (now[0] or (None, 0, 0)) + (now[1],))
            seen = now
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
    log(f"[{tag}] the loop closer's common region by frame (frame, candidate keyframe, "
        f"confirmations, misses in a row, loops closed): {timeline}")
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
    # a second-lap frame the System never saw (3.5 s past the run's end)
    # relocalizes by BoW + PnP + pose LM on a keyframe of the first lap;
    # mono map units are arbitrary, so its pose is held against ground
    # truth after the run's trajectory is Sim3-aligned onto it
    lap_s = CIRCUMFERENCE / seq.traj.speed
    i = LOOP_RELOC_FRAME
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
    frames = render(seq, N_RGBD, "rgbd")
    log(f"[rgbd] rendered {N_RGBD} image + depth frames {W}x{H} in "
        f"{time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
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


def render_mono_vi():
    """Phase 7's sequence (tests/test_e2e_mono_inertial.py's at full width):
    the sequence, its frames and each frame's IMU samples."""
    from tpuslam_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=N_VI, fps=10, speed=0.5, imu_rate=200.0, kind="vi_excite",
                            height=H, width=W, fx=FX, fy=FY)
    t0 = time.perf_counter()
    frames = render(seq, N_VI)
    times = seq.timestamps()
    imu = [None] + [np.column_stack(seq.imu_between(times[i - 1], times[i]))
                    for i in range(1, N_VI)]
    log(f"[mono_vi] rendered {N_VI} frames {W}x{H} and {sum(len(x) for x in imu[1:])} IMU "
        f"samples in {time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
    return seq, frames, imu


def vi_config():
    """The VI tests' configuration (a keyframe at least every 3 frames),
    their pixel radii (the motion-model radius and the two-view init window,
    defaults there) scaled by the width ratio."""
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig

    base = TrackingConfig()
    return SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                      tracking=TrackingConfig(max_frames_between_kf=3,
                                              motion_model_radius=base.motion_model_radius * W
                                              / 376.0,
                                              init_window=base.init_window * W / 376.0))


def vi_run_summary(name, slam, rows, wall, smi):
    """Print the per-frame launch summary of a VI run; returns (fused VI
    frames, VI frames that fell back to the host path, host-path frames
    before the IMU init)."""
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    fused = [r for r in rows if r["fused_vi"] and not r["host"]]
    fallback = [i for i, r in enumerate(rows) if r["initialized"] and r["host"]]
    host_pre = [r for r in rows if not r["initialized"] and r["host"]]
    steady = np.array(wall[WARMUP:])
    log(f"[{name}] track wall ms over frames {WARMUP}..{len(wall) - 1}: median "
        f"{np.median(steady):.3f}, p90 {np.percentile(steady, 90):.3f}, max {steady.max():.3f}; "
        f"card {smi}")
    stage_table(name, GLOBAL_TIMER)
    log(f"[{name}] launches {counts_now()}; fused VI frames {len(fused)} (patch gather "
        f"{sorted(set(r['patch'] for r in fused))}, pose LM {sorted(set(r['pose'] for r in fused))}"
        f" per frame), pose_inertial_solve calls per fused VI frame "
        f"{sorted(set(r['vi_solves'] for r in fused))}, per frame after the init "
        f"{np.mean([r['vi_solves'] for r in rows if r['initialized']] or [0.0]):.3f}; frames "
        f"after the init that fell back to the host path {len(fallback)} {fallback}; host-path "
        f"frames before the init {len(host_pre)}, pose LM launches there "
        f"{sum(r['pose'] for r in host_pre)}")
    return fused, fallback, host_pre


def phase_mono_vi(dev, smi, data, async_mapping=False):
    """Phase 7: System.track_monocular(..., imu=) on an IMU_MONOCULAR System
    over phase 7's sequence (render_mono_vi); (b) with async_mapping, the
    mapper on its worker thread under tests/test_async_mapping.py's bounded
    back-pressure, then flush() and shutdown(). Returns the launch counts."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_async import count_rebases, paced

    name = "mono_vi_async" if async_mapping else "mono_vi"
    seq, frames, imu = data
    times = seq.timestamps()
    slam = System(Pinhole([FX, FY, seq.cx, seq.cy], W, H), vi_config(),
                  sensor=Sensor.IMU_MONOCULAR, imu_calib=ImuCalib(**VI_NOISE, freq=seq.imu_rate),
                  async_mapping=async_mapping, device=dev)
    rebases = count_rebases(slam.tracker)
    GLOBAL_TIMER.samples.clear()
    reset_counts()
    wall, rows, waits = [], [], []
    for i in range(N_VI):
        if async_mapping:
            # bounded back-pressure (tests/test_async_mapping.py)
            waits.append(paced(slam))
        before = vi_counts()
        initialized = slam.map.imu_initialized
        t1 = time.perf_counter()
        slam.track_monocular(frames[i], times[i], imu=imu[i])
        wall.append((time.perf_counter() - t1) * 1e3)
        rows.append(dict(initialized=initialized,
                         **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host"),
                                    (a - b for a, b in zip(vi_counts(), before))))))
    errors = []
    if async_mapping:
        slam.async_mapper.flush(raise_errors=False)
        errors = list(slam.async_mapper.errors)
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
    init_frame = next((i for i, r in enumerate(rows[1:], 1) if r["initialized"]), -1) - 1
    log(f"[{name}] state {slam.get_tracking_state().name}, IMU initialized "
        f"{m.imu_initialized} (after frame {init_frame}), {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, {len(traj)} trajectory rows, Horn scale "
        f"{scale:.5f}, scaled ATE {rmse * 100:.3f} cm, |R[2,2]| {abs(R[2, 2]):.6f}, median "
        f"KF velocity error {vel_err:.4f} m/s; handshake rebases {rebases[0]}"
        + (f"; worker errors {errors}, back-pressure waits {sum(waits):.2f} s in all"
           if async_mapping else ""))
    fused, _, host_pre = vi_run_summary(name, slam, rows, wall, smi)
    check(m.imu_initialized, f"{name}: the IMU never initialized")
    check(slam.get_tracking_state() == State.OK, f"{name}: final state not OK")
    check(len(traj) >= N_VI - 10 and np.isfinite(est).all(), f"{name}: trajectory")
    check(not errors, f"{name}: mapper errors {errors}")
    if async_mapping:
        # tests/test_async_mapping.py::test_async_mono_inertial_quality's gates
        check(rmse < 0.08, f"{name}: scaled ATE {rmse}")
        check(rebases[0] >= 1, f"{name}: no handshake rebased the last frame")
        check(min(launches.values()) > 0, f"{name}: a kernel was never launched: {launches}")
        return launches
    check(abs(scale - 1.0) < 0.4 and rmse < 0.06, f"{name}: Horn scale {scale}, ATE {rmse}")
    check(abs(R[2, 2]) > 0.99, f"{name}: not gravity-aligned, R[2,2] {R[2, 2]}")
    check(vel_err < 0.2, f"{name}: median KF velocity error {vel_err}")
    check(len(fused) >= 1, f"{name}: no frame took the fused visual-inertial step")
    check(all(r["patch"] == 1 and r["pose"] == 4 and r["vi_solves"] >= 1 for r in fused),
          f"{name}: a fused VI frame did not make 1 patch-gather and 4 pose-LM launches and a "
          f"pose-inertial solve")
    check(sum(r["pose"] for r in host_pre) > 0,
          f"{name}: no pose LM on the host path before init")
    return launches


def phase_mono_vi_alone(dev, smi, async_mapping):
    """Phase 7, or 7 (b) with the mapper on its own thread, in a process of
    its own: phase 7's frames rendered there."""
    import torch

    torch.set_num_threads(2)
    return phase_mono_vi(dev, smi, render_mono_vi(), async_mapping=async_mapping)


def redecided_frames(rows, events, name):
    """The frames of a VI run (rows of launch counts) that extracted their
    features for the host path and then took the fused VI step: with the
    mapper on its own thread the IMU init can land between the tracker's
    choice of path and the map lock, and the tracker decides again under the
    lock (4 patch gathers on that frame). At most one per IMU init."""
    out = [i for i, r in enumerate(rows) if r["patch"] == 4 and r["fused_vi"] and not r["host"]]
    n_init = sum(e["event"] == "imu_init" for e in events)
    log(f"[{name}] frames that took the fused VI step after choosing the host path: {out}")
    check(len(out) <= n_init, f"{name}: {len(out)} frames re-decided for {n_init} IMU inits")
    return out


def fused_vi_lm_compare(calls, what, smi, frame="fused VI frame", host=False):
    """The pose LM on the inputs a path's first fused VI frame (or the
    `frame` named) gave it (its 4 calls, (args, kwargs) each): every call
    held against the plain version (pose_lm_compare), the last (4 rounds)
    timed as in phase 2 beside its bound. host: the host tracker's solves
    of a host frame, through pose_optimize_best (the f64 cast in the
    host-inclusive time, as phase 2's host shapes). Returns the records by
    call, with max_abs_err."""
    import torch

    from tpuslam_torch.solve import pose_opt_cuda
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    solve = pose_optimize_best if host else pose_opt_cuda.pose_optimize_fused
    shapes, worst = {}, 0.0
    for j, (a, kw) in enumerate(calls):
        eR, et, agree, _, rounds = pose_lm_compare(solve, a, f"{what} call {j}", kw)
        worst = max(worst, eR, et)
        st = a[5] & a[6]
        n_valid = int(a[6].sum())
        valid_by = {"mono": n_valid - int(st.sum()), "stereo": int(st.sum())}
        shapes[f"call_{j}"] = dict(n=int(a[2].shape[0]), valid=valid_by,
                                   n_rounds=kw.get("n_rounds", 4), dR=eR, dt=et,
                                   agreement=agree, steps=[r["steps"] for r in rounds],
                                   in_use=[(r["mono"], r["stereo"]) for r in rounds],
                                   flops=pose_lm_ops(rounds, valid_by))
        log(f"[{what}] pose LM call {j} of the first {frame} (N={a[2].shape[0]}, "
            f"valid {valid_by}, {shapes[f'call_{j}']['n_rounds']} rounds): |dR| {eR:.3g} |dt| "
            f"{et:.3g} inlier agreement {agree:.4f}, LM steps {shapes[f'call_{j}']['steps']}")
    a, kw = calls[-1]
    args32 = [x.to(torch.float32).contiguous() for x in a[:5]] + list(a[5:])
    kw32 = {k: v for k, v in kw.items() if k == "n_rounds"} if host else kw
    fused_call = lambda: pose_opt_cuda.pose_optimize_fused(*args32, **kw32)  # noqa: E731
    host_ms, dev_ms, plain_ms = pose_lm_times(
        (lambda: solve(*a, **kw)) if host else fused_call, fused_call,
        lambda: pose_opt_cuda.pose_optimize_plain(*args32, **kw32))
    rec = shapes[f"call_{len(calls) - 1}"]
    n_bytes = pose_lm_bytes(rec["n"])
    b_ms, b_by, b_res = bound(n_bytes, rec["flops"])
    rec.update(ms=host_ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=n_bytes)
    log(f"[{what}] pose LM on the first {frame}'s last call: kernel device "
        f"{dev_ms:.5f} ms, host-inclusive {host_ms:.5f} ms{' (f64 cast included)' if host else ''}"
        f"; plain {plain_ms:.4f} ms; bound {b_ms:.7f} ms ({rec['flops']} f32 operations, "
        f"{n_bytes} bytes: {b_res}); the bound is {b_ms / dev_ms:.5f} of the device time; card "
        f"{smi}")
    return dict(shapes, max_abs_err=worst)


def phase_stereo_vi(dev, smi, async_mapping=False):
    """Phase 12: System.track_stereo(..., imu=) on an IMU_STEREO System over
    the heave sequence (tests/torch_vi_heave.py) at full width; the pose-LM
    kernel's inputs on the first fused visual-inertial frame are held
    against its plain version and timed. (b) with async_mapping: the mapper
    and its IMU stage on the worker thread under tests/test_async_mapping.py's
    bounded back-pressure, then flush() and shutdown(); the first fused VI
    frame after the async IMU init also holds its two patch gathers against
    the plain version. Returns the launch counts, the kernel records and the
    run's figures (the IMU init frame, the pose_inertial stage, the longest
    frame wall)."""
    import torch

    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine import track_device
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.ops import orb
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_async import count_rebases, paced
    from torch_vi_heave import heave_sequence

    if async_mapping:
        torch.set_num_threads(2)   # (b) runs in a process of its own beside other phases
    name = "stereo_vi_async" if async_mapping else "stereo_vi"
    n_frames = N_STEREO_VI_ASYNC if async_mapping else N_STEREO_VI
    t_phase = time.perf_counter()
    seq = heave_sequence(n_frames=n_frames, fps=10, speed=0.5, imu_rate=200.0,
                         baseline=BASELINE, height=H, width=W, fx=FX, fy=FY)
    frames = render(seq, n_frames, "stereo")
    times = seq.timestamps()
    imu = [None] + [np.column_stack(seq.imu_between(times[i - 1], times[i]))
                    for i in range(1, n_frames)]
    log(f"[{name}] rendered {n_frames} stereo frames {W}x{H} of the heave sequence and "
        f"{sum(len(x) for x in imu[1:])} IMU samples in {time.perf_counter() - t_phase:.1f} s "
        f"(host, {RENDER_WORKERS} processes)")
    slam = System(Pinhole([FX, FY, seq.cx, seq.cy], W, H), vi_config(),
                  sensor=Sensor.IMU_STEREO, imu_calib=ImuCalib(**VI_NOISE, freq=seq.imu_rate),
                  bf=FX * BASELINE, async_mapping=async_mapping, device=dev)
    rebases = count_rebases(slam.tracker)
    # the fused step's pose-LM calls and patch gathers of each frame; those of
    # the first fused visual-inertial frame are kept
    calls, gathers, captured = [], [], []
    real_lm, real_gather = track_device.pose_optimize_fused, orb.extract_patches_levels

    def capture_lm(*a, **kw):
        if not captured:
            calls.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw)))
        return real_lm(*a, **kw)

    def capture_gather(levels, yx, budgets, size):
        if not captured:
            gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets), size))
        return real_gather(levels, yx, budgets, size)

    track_device.pose_optimize_fused = capture_lm
    orb.extract_patches_levels = capture_gather
    GLOBAL_TIMER.samples.clear()
    reset_counts()
    wall, rows, waits = [], [], []
    try:
        for i in range(n_frames):
            if async_mapping:
                waits.append(paced(slam))
            before = vi_counts()
            initialized = slam.map.imu_initialized
            calls.clear()
            gathers.clear()
            t1 = time.perf_counter()
            slam.track_stereo(*frames[i], times[i], imu=imu[i])
            wall.append((time.perf_counter() - t1) * 1e3)
            row = dict(initialized=initialized, state=slam.get_tracking_state().name,
                       **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host"),
                                  (a - b for a, b in zip(vi_counts(), before)))))
            rows.append(row)
            if (not captured and row["fused_vi"] and not row["host"] and len(calls) == 4
                    and len(gathers) == 2):
                captured.append((list(gathers), list(calls), i))
        errors = []
        if async_mapping:
            slam.async_mapper.flush(raise_errors=False)
            errors = list(slam.async_mapper.errors)
    finally:
        track_device.pose_optimize_fused = real_lm
        orb.extract_patches_levels = real_gather
    slam.shutdown()
    torch.cuda.synchronize()
    launches = counts_now()
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = gt_centers(seq, traj)
    rmse, _ = ate(est, gt)
    R, _, s, _ = horn_align(est, gt, True)
    vel_err = float(np.median([np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
                               for k in m.valid_kf_ids()]))
    ok_frame = next((i for i, r in enumerate(rows) if r["state"] == "OK"), -1)
    init_frame = next((i for i, r in enumerate(rows[1:], 1) if r["initialized"]), -1) - 1
    pose_inertial = GLOBAL_TIMER.samples.get("pose_inertial", [])
    figures = dict(init_frame=init_frame, max_frame_ms=max(wall),
                   pose_inertial_ms=float(np.median(pose_inertial)) * 1e3 if pose_inertial
                   else None,
                   rebases=rebases[0], ate=rmse, scale=s)
    log(f"[{name}] state {slam.get_tracking_state().name}, stereo init on frame {ok_frame}, "
        f"IMU initialized {m.imu_initialized} (after frame {init_frame}), "
        f"{len(m.valid_kf_ids())} KFs, {int(m.mp_valid[: m.n_mp].sum())} map points, "
        f"{len(traj)} trajectory rows, unscaled ATE {rmse * 100:.3f} cm, Horn scale {s:.5f}, "
        f"|R[2,2]| {abs(R[2, 2]):.6f}, median KF velocity error {vel_err:.4f} m/s; mapper "
        f"events {[e['event'] for e in slam.local_mapper.debug_events]}; handshake rebases "
        f"{rebases[0]}; longest frame wall {max(wall):.1f} ms (frame {int(np.argmax(wall))}); "
        f"pose_inertial median {figures['pose_inertial_ms']} ms over {len(pose_inertial)} solves"
        + (f"; worker errors {errors}, back-pressure waits {sum(waits):.2f} s in all"
           if async_mapping else ""))
    fused, fallback, host_pre = vi_run_summary(name, slam, rows, wall, smi)
    check(m.imu_initialized, f"{name}: the IMU never initialized")
    check(slam.get_tracking_state() == State.OK, f"{name}: final state not OK")
    check(len(traj) >= n_frames - 10 and np.isfinite(est).all(), f"{name}: trajectory")
    check(rmse < 0.05 and abs(s - 1.0) < 0.03, f"{name}: ATE {rmse}, Horn scale {s}")
    check(abs(R[2, 2]) > 0.99, f"{name}: not gravity-aligned, R[2,2] {R[2, 2]}")
    check(vel_err < 0.2, f"{name}: median KF velocity error {vel_err}")
    check(not errors, f"{name}: mapper errors {errors}")
    check(not async_mapping or rebases[0] >= 1, f"{name}: no handshake rebased the last frame")
    redecided = redecided_frames(rows, slam.local_mapper.debug_events, name)
    check(all(r["patch"] == 2 for i, r in enumerate(rows) if i not in redecided),
          f"{name}: patch-gather launches per frame {sorted(set(r['patch'] for r in rows))}"
          f" != 2")
    check(sum(r["pose"] for r in host_pre) > 0,
          f"{name}: no pose LM on the host path before the IMU init")
    check(len(fused) >= 1 and len(captured) == 1,
          f"{name}: no frame after the IMU init took the fused VI step")
    check(all(r["pose"] == 4 and r["vi_solves"] == 1 for r in fused),
          f"{name}: a fused VI frame did not make 4 pose-LM launches and one "
          "pose_inertial_solve")
    frame_gathers, frame_calls, at = captured[0]
    shapes = fused_vi_lm_compare(frame_calls, name, smi)
    if async_mapping:
        check(len(frame_gathers) == 2, f"{name}: {len(frame_gathers)} gathers kept on frame {at}")
        shapes = {"patch_gather": {side: patch_compare(*g, f"{name} frame {at} {side}")
                                   for side, g in zip(("left", "right"), frame_gathers)},
                  "pose_lm": shapes, "frame": at}
    log(f"[{name}] phase 12{' (b)' if async_mapping else ''} in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, shapes, figures


def fisheye_vi_config():
    """The CPU tests' fisheye visual-inertial configuration (a keyframe at
    least every 3 frames, a stereo init from 150 features) at FISH_WH: their
    pixel radii scaled from 256 px."""
    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig

    base, k = TrackingConfig(), FISH_WH / 256.0
    return SlamConfig(orb=OrbConfig(n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE),
                      tracking=TrackingConfig(max_frames_between_kf=3,
                                              min_stereo_init_features=150,
                                              motion_model_radius=base.motion_model_radius * k,
                                              init_window=base.init_window * k))


def phase_fisheye_vi(dev, smi, stereo):
    """Phases 13 (stereo) and 14 (mono): TUM-VI's fisheye visual-inertial
    routes, System(KB8, IMU_STEREO, camera2=, Tlr=).track_stereo(..., imu=)
    over the heave sequence, or System(KB8, IMU_MONOCULAR)
    .track_monocular(..., imu=) over vi_excite, at FISH_WH with
    tests/torch_fisheye_rig.py's rig; the patch gather held against its
    plain version on frame 0's inputs. Returns the launch counts and the
    patch gather's records."""
    import torch

    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse as ate
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import orb
    from tpuslam_torch.solve import pose_opt_dispatch
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_fisheye_rig import kb8_rig
    from torch_vi_heave import heave_sequence

    name, n = ("fisheye_stereo_vi", N_FISH_STEREO_VI) if stereo else ("fisheye_mono_vi",
                                                                        N_FISH_MONO_VI)
    t_phase = time.perf_counter()
    cam, cam2, Trl = kb8_rig(FISH_WH, FISH_BASELINE)
    if stereo:
        seq = heave_sequence(n_frames=n, fps=FISH_VI_FPS, speed=0.5, imu_rate=200.0,
                             camera=cam, camera2=cam2, Trl=Trl)
    else:
        seq = SyntheticSequence(n_frames=n, fps=FISH_VI_FPS, speed=0.5, imu_rate=200.0,
                                kind="vi_excite", camera=cam)
    frames = render(seq, n, "stereo" if stereo else "mono")
    times = seq.timestamps()
    imu = [None] + [np.column_stack(seq.imu_between(times[i - 1], times[i]))
                    for i in range(1, n)]
    log(f"[{name}] rendered {n} KB8 {'stereo pairs' if stereo else 'images'} "
        f"{FISH_WH}x{FISH_WH} and {sum(len(x) for x in imu[1:])} IMU samples in "
        f"{time.perf_counter() - t_phase:.1f} s (host, {RENDER_WORKERS} processes)")
    calib = ImuCalib(**VI_NOISE, freq=seq.imu_rate)
    if stereo:
        slam = System(cam, fisheye_vi_config(), sensor=Sensor.IMU_STEREO, imu_calib=calib,
                      bf=cam.fx * FISH_BASELINE, camera2=cam2, Tlr=np.linalg.inv(Trl),
                      device=dev)
    else:
        slam = System(cam, fisheye_vi_config(), sensor=Sensor.IMU_MONOCULAR, imu_calib=calib,
                      device=dev)
    generic, gathers = [0], []   # camera-generic pose solves; frame 0's gather inputs
    real_solve, real_gather = pose_opt_dispatch.pose_optimize, orb.extract_patches_levels

    def counted(*a, **kw):
        generic[0] += 1
        return real_solve(*a, **kw)

    def captured(levels, yx, budgets, size):
        if len(gathers) < (2 if stereo else 1):
            gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets), size))
        return real_gather(levels, yx, budgets, size)

    pose_opt_dispatch.pose_optimize = counted
    orb.extract_patches_levels = captured
    GLOBAL_TIMER.samples.clear()
    reset_counts()
    wall, rows = [], []
    try:
        for i in range(n):
            before = (*vi_counts(), generic[0])
            initialized = slam.map.imu_initialized
            t1 = time.perf_counter()
            if stereo:
                slam.track_stereo(*frames[i], times[i], imu=imu[i])
            else:
                slam.track_monocular(frames[i], times[i], imu=imu[i])
            wall.append((time.perf_counter() - t1) * 1e3)
            rows.append(dict(initialized=initialized, state=slam.get_tracking_state().name,
                             **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host",
                                         "generic"),
                                        (a - b for a, b in zip((*vi_counts(), generic[0]),
                                                               before))))))
        slam.shutdown()
        torch.cuda.synchronize()
    finally:
        pose_opt_dispatch.pose_optimize = real_solve
        orb.extract_patches_levels = real_gather
    launches = counts_now()
    m = slam.map
    traj = slam.trajectory_tum()
    est = np.array([r[1:4] for r in traj])
    gt = gt_centers(seq, traj)
    rmse, _ = ate(est, gt)
    scaled, _ = ate(est, gt, True)
    R, _, s, _ = horn_align(est, gt, True)
    vel_err = float(np.median([np.linalg.norm(s * R @ m.kf_vel[k] - seq.traj.vel(m.kf_time[k]))
                               for k in m.valid_kf_ids()]))
    ok_frame = next((i for i, r in enumerate(rows) if r["state"] == "OK"), -1)
    init_frame = next((i for i, r in enumerate(rows[1:], 1) if r["initialized"]), -1) - 1
    post = [r for r in rows if r["initialized"]]
    pre_host = [r for r in rows[ok_frame + 1:] if not r["initialized"]]
    errors = slam.async_mapper.errors if slam.async_mapper is not None else []
    log(f"[{name}] state {slam.get_tracking_state().name}, "
        f"{'stereo' if stereo else 'two-view'} init on frame {ok_frame}, IMU initialized "
        f"{m.imu_initialized} (after frame {init_frame}), {len(m.valid_kf_ids())} KFs, "
        f"{int(m.mp_valid[: m.n_mp].sum())} map points, {len(traj)} trajectory rows, unscaled "
        f"ATE {rmse * 100:.3f} cm, scaled ATE {scaled * 100:.3f} cm, Horn scale {s:.5f}, "
        f"|R[2,2]| {abs(R[2, 2]):.6f}, median KF velocity error {vel_err:.4f} m/s; mapper "
        f"events {[e['event'] for e in slam.local_mapper.debug_events]}")
    stage_table(name, GLOBAL_TIMER)
    for what, part in (("before", [w for w, r in zip(wall, rows) if not r["initialized"]]),
                       ("after", [w for w, r in zip(wall, rows) if r["initialized"]])):
        log(f"[{name}] host frames {what} the IMU init: {len(part)}, wall ms median "
            f"{np.median(part or [np.nan]):.3f} max {max(part or [np.nan]):.3f}; card {smi}")
    log(f"[{name}] launches {launches}; patch gather per frame "
        f"{sorted(set(r['patch'] for r in rows))}; camera-generic KB8 pose solves per tracked "
        f"frame before the init {sorted(set(r['generic'] for r in pre_host))}, after it "
        f"{sorted(set(r['generic'] for r in post))}; pose_inertial_solve calls per frame after "
        f"the init {[r['vi_solves'] for r in post]}; fused VI frames "
        f"{sum(r['fused_vi'] for r in rows)}")
    # the kernel against its plain version on exactly what this path gave it
    check(len(gathers) == (2 if stereo else 1),
          f"{name}: {len(gathers)} patch gathers captured on frame 0")
    sides = ("left", "right") if stereo else ("left",)
    shapes = {f"{name}_{side}": patch_compare(*g, f"{name} {FISH_WH}x{FISH_WH} frame 0 {side}")
              for side, g in zip(sides, gathers)}
    check(slam.tracker.camspec.kind == "kb8", f"{name}: the tracker's camera is not KB8")
    check(m.imu_initialized, f"{name}: the IMU never initialized")
    check(slam.get_tracking_state() == State.OK, f"{name}: final state not OK")
    check(len(traj) >= n - 10 and np.isfinite(est).all(), f"{name}: trajectory")
    if stereo:   # tests/test_torch_fisheye_inertial_e2e.py's gates
        check(rmse < 0.08 and abs(s - 1.0) < 0.03, f"{name}: ATE {rmse}, Horn scale {s}")
    else:        # phase 7's
        check(scaled < 0.06 and abs(s - 1.0) < 0.4, f"{name}: scaled ATE {scaled}, scale {s}")
    check(abs(R[2, 2]) > 0.99, f"{name}: not gravity-aligned, R[2,2] {R[2, 2]}")
    check(vel_err < 0.2, f"{name}: median KF velocity error {vel_err}")
    check(not errors, f"{name}: mapper errors {errors}")
    check(all(r["patch"] == len(sides) for r in rows),
          f"{name}: patch-gather launches per frame {[r['patch'] for r in rows]}")
    check(launches["pose_lm"] == 0, f"{name}: {launches['pose_lm']} pose-LM launches")
    check(all(r["generic"] >= 1 for r in pre_host),
          f"{name}: a tracked frame before the IMU init without a camera-generic pose solve")
    check(len(post) >= 6 and all(r["vi_solves"] >= 1 and not r["fused_vi"] for r in post),
          f"{name}: {len(post)} frames after the IMU init, or one without a KB8 "
          f"pose_inertial_solve")
    log(f"[{name}] phase {13 if stereo else 14} in {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes


def phase_vi_schedule(dev, smi):
    """Phase 15: scripts/vi_f32_experiment_torch.run, mono-inertial over
    N_VI_SCHEDULE frames of its sequence (376x240, 600 features) on the card
    in f32, with the inertial mapper's schedule shortened (the script's
    SHORT_SCHEDULE) so that the run crosses all of it: the IMU init, a scale
    refinement, VIBA1, VIBA2 and the zero-prior local inertial BAs after it.
    Both kernels are held against their plain versions on what this path
    gave them: frame 0's patch gather (bitwise) and the first fused VI
    frame's pose-LM calls (phase 2's tolerances), the last of them timed as
    in phase 2. Returns the launch counts and those records."""
    import torch

    from tpuslam_torch.engine import track_device
    from tpuslam_torch.engine.config import InertialConfig
    from tpuslam_torch.eval.ate import horn_align
    from tpuslam_torch.ops import orb
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import vi_f32_experiment_torch as script

    t_phase = time.perf_counter()
    # frame 0's patch gather, and the pose-LM calls of the first fused VI
    # frame: with an IMU every fused-step call is a fused VI frame's, and
    # that frame's "track_fused_vi" sample lands after its calls
    gathers, calls = [], []
    real_gather, real_lm = orb.extract_patches_levels, track_device.pose_optimize_fused

    def captured_gather(levels, yx, budgets, size):
        if not gathers:
            gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets), size))
        return real_gather(levels, yx, budgets, size)

    def captured_lm(*a, **kw):
        if not GLOBAL_TIMER.samples.get("track_fused_vi"):
            calls.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw)))
        return real_lm(*a, **kw)

    orb.extract_patches_levels, track_device.pose_optimize_fused = captured_gather, captured_lm
    reset_counts()
    try:
        res = script.run(N_VI_SCHEDULE, stereo=False, device=dev,
                         inertial=InertialConfig(**script.SHORT_SCHEDULE),
                         log=lambda line: log(f"[vi_schedule] {line.strip()}"))
        torch.cuda.synchronize()
        launches = counts_now()
    finally:
        orb.extract_patches_levels, track_device.pose_optimize_fused = real_gather, real_lm
    m = res["slam"].map
    kfs = m.valid_kf_ids()
    R, _, s, _ = horn_align(res["est"], res["gt"], True)
    fused = [r for r in res["rows"] if r["fused_vi"] and not r["host"]]
    events = [e["event"] for e in res["events"]]
    log(f"[vi_schedule] schedule {script.SHORT_SCHEDULE}: events "
        f"{[(e['event'], e['frame']) for e in res['events']]} (event, frame), scale refinements "
        f"{res['refinements']}, zero-prior local inertial BAs {res['zero_prior_local_ba']}, "
        f"max |R^T R - I| {res['orthonormality']:.3e}, Horn scale {s:.5f}, |R[2,2]| "
        f"{abs(R[2, 2]):.6f}; launches {launches}, fused VI frames {len(fused)}; card {smi}")
    check(res["state"] == "OK" and m.imu_initialized,
          "vi_schedule: not OK, or the IMU never initialized")
    check(events == ["imu_init", "viba1", "viba2"], f"vi_schedule: mapper events {events}")
    check(res["refinements"] >= 1, "vi_schedule: no scale refinement")
    check(res["zero_prior_local_ba"] >= 1, "vi_schedule: no zero-prior local inertial BA")
    check(res["ok"], f"vi_schedule: RESULT FAIL (scaled ATE {res['rmse']}, state "
          f"{res['state']}, {len(res['traj'])} trajectory rows)")
    check(abs(R[2, 2]) > 0.99, f"vi_schedule: not gravity-aligned, R[2,2] {R[2, 2]}")
    check(all(np.isfinite(np.asarray(getattr(m, f))[kfs]).all()
              for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")),
          "vi_schedule: a keyframe state is not finite")
    check(len(fused) >= 1 and all(r["patch"] == 1 and r["pose"] == 4 and r["vi_solves"] >= 1
                                  for r in fused),
          "vi_schedule: a fused VI frame did not make 1 patch-gather and 4 pose-LM launches "
          "and a pose-inertial solve")
    # both kernels on the inputs this path gave them
    check(len(gathers) == 1 and len(calls) == 4,
          f"vi_schedule: {len(gathers)} patch gathers and {len(calls)} pose-LM calls of the "
          f"first fused VI frame captured")
    shapes = {"patch_gather": patch_compare(*gathers[0], "vi_schedule 376x240 frame 0")}
    shapes["pose_lm"] = fused_vi_lm_compare(calls, "vi_schedule", smi)
    log(f"[vi_schedule] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes


class vi_merge_probe:
    """Phase 16's instruments: per-frame rows (launches, solves, state, map
    count, host wall ms) of every System attached to it, with run.main's
    System attached as it is built; the merges its loop closer corrects and
    the parts of the inertial merge route (the Sim3 before the gates and the
    rotation the yaw projection removed, the essential graph's DoF, the weld
    BA's size, the GBA snapshot's kind); and the kernel inputs of the first
    fused visual-inertial frame after each merge (its patch gathers and its
    4 pose-LM calls)."""

    def __init__(self, gathers=2):
        self.gathers = gathers      # patch gathers per frame: 2 stereo, 1 mono

    def __enter__(self):
        import torch

        from tpuslam_torch import run
        from tpuslam_torch.engine import loop_closing, track_device
        from tpuslam_torch.ops import orb

        self.rows, self.wall, self.merges, self.tries, self.parts = [], [], [], [], []
        self.spans = []     # (start, end) perf_counter of each track_stereo call
        self.captured, self.systems = [], []
        probe, frame_gathers, frame_lm, raw = self, [], [], [None]
        LC = loop_closing.LoopCloser
        self.saved = dict(gather=orb.extract_patches_levels, lm=track_device.pose_optimize_fused,
                          System=run.System, try_loop=LC._try_loop, correct=LC._correct_loop,
                          snapshot=LC._snapshot_gba,
                          **{n: getattr(loop_closing, n) for n in
                             ("optimize_sim3", "optimize_essential_graph",
                              "window_inertial_ba")})
        sv = self.saved

        def pending():
            return len(probe.captured) < len(probe.merges)

        def gather(levels, yx, budgets, size):
            if pending():
                frame_gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets),
                                      size))
            return sv["gather"](levels, yx, budgets, size)

        def lm(*a, **kw):
            if pending():
                frame_lm.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw)))
            return sv["lm"](*a, **kw)

        def probed(slam, real):
            def track(*a, **kw):
                before, init = vi_counts(), slam.map.imu_initialized
                frame_gathers.clear()
                frame_lm.clear()
                t0 = time.perf_counter()
                out = real(*a, **kw)
                t1 = time.perf_counter()
                probe.wall.append((t1 - t0) * 1e3)
                probe.spans.append((t0, t1))
                row = dict(initialized=init, state=slam.get_tracking_state().name,
                           maps=len(slam.map.map_ids()),
                           **dict(zip(("patch", "pose", "vi_solves", "fused_vi", "host"),
                                      (x - y for x, y in zip(vi_counts(), before)))))
                probe.rows.append(row)
                if (pending() and row["fused_vi"] and not row["host"] and len(frame_lm) == 4
                        and len(frame_gathers) == probe.gathers):
                    probe.captured.append((list(frame_gathers), list(frame_lm),
                                           len(probe.rows) - 1))
                return out

            return track

        def attach(slam):
            slam.track_stereo = probed(slam, slam.track_stereo)
            slam.track_monocular = probed(slam, slam.track_monocular)
            probe.systems.append(slam)
            return slam

        class Probed(sv["System"]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                attach(self)

        def try_loop(closer, kf, cand, merge=False):
            raw[0] = None
            out = sv["try_loop"](closer, kf, cand, merge=merge)
            if merge and raw[0] is not None:
                s, R = raw[0]
                removed = None
                if out is not None:
                    R_kept = out["sim3"][1]
                    removed = float(np.arccos(np.clip((np.trace(R.T @ R_kept) - 1) / 2, -1, 1)))
                probe.tries.append(dict(frame=len(probe.rows), kf=int(kf), cand=int(cand),
                                        s=s, ok=out is not None, yaw_removed=removed))
            return out

        def correct(closer, kf, cand, *a, merge=False, **kw):
            m = closer.map
            if merge:
                probe.merges.append(dict(frame=len(probe.rows), kf=int(kf), cand=int(cand),
                                         imu=bool(m.imu_initialized), ba1=bool(m.inertial_ba1),
                                         aborted_before=list(closer.merges_aborted)))
            t0 = time.perf_counter()
            out = sv["correct"](closer, kf, cand, *a, merge=merge, **kw)
            if merge:
                t1 = time.perf_counter()
                probe.merges[-1].update(ms=(t1 - t0) * 1e3, span=(t0, t1))
            return out

        def snapshot(closer, fix_kf):
            snap = sv["snapshot"](closer, fix_kf)
            probe.parts.append(("gba", None if snap is None else snap.get("kind", "visual")))
            return snap

        def opt(*a, **kw):
            out = sv["optimize_sim3"](*a, **kw)
            raw[0] = (float(out[0]), out[1].cpu().numpy().astype(np.float64))
            return out

        def graph(*a, **kw):
            probe.parts.append(("essential_graph", dict(four_dof=bool(kw["four_dof"]),
                                                        fixed=len(kw["fix_kfs"]))))
            return sv["optimize_essential_graph"](*a, **kw)

        def weld(*a, **kw):
            probe.parts.append(("weld", dict(optimized=len(kw["opt_kfs"]),
                                             fixed=len(kw["fixed_kfs"]))))
            return sv["window_inertial_ba"](*a, **kw)

        self.attach = attach
        orb.extract_patches_levels, track_device.pose_optimize_fused = gather, lm
        run.System = Probed
        LC._try_loop, LC._correct_loop, LC._snapshot_gba = try_loop, correct, snapshot
        loop_closing.optimize_sim3 = opt
        loop_closing.optimize_essential_graph = graph
        loop_closing.window_inertial_ba = weld
        return self

    def __exit__(self, *exc):
        from tpuslam_torch import run
        from tpuslam_torch.engine import loop_closing, track_device
        from tpuslam_torch.ops import orb

        sv, LC = self.saved, loop_closing.LoopCloser
        orb.extract_patches_levels, track_device.pose_optimize_fused = sv["gather"], sv["lm"]
        run.System = sv["System"]
        LC._try_loop, LC._correct_loop, LC._snapshot_gba = (sv["try_loop"], sv["correct"],
                                                            sv["snapshot"])
        for n in ("optimize_sim3", "optimize_essential_graph", "window_inertial_ba"):
            setattr(loop_closing, n, sv[n])


def phase_vi_merge(dev, smi, branch, async_mapping=False):
    """Phase 16: two stereo-inertial sessions over one place merged into one
    Atlas map, at full width (f32). branch "a": tests/torch_vi_merge.py's
    heave_sessions (the second session sees the first from its first
    frames, long before its own IMU init) written as two EuRoC trees, a
    vocabulary trained here, `run.main --sensor stereo_imu --path A,B
    --vocab`; "b": its loop_sessions (the second session comes round to
    the first only after its own IMU init and VIBA1, the short schedule)
    through System.track_stereo(..., imu=). Gates: one merge, inside the
    second session and with its IMU initialized ((b): after its VIBA1), the
    map count 2 -> 1, OK at the end, nothing left in the young map, the
    stereo-inertial gates on one alignment of both sessions' rows, 2 patch
    gathers per frame and 4 pose LMs and a pose_inertial_solve per fused VI
    frame; the first fused VI frame after the merge holds both kernels
    against their plain versions. async_mapping (branch "b" only): the mapper
    and the loop closer on the worker thread under tests/test_async_mapping.py's
    bounded back-pressure, then flush(); no worker error. Returns the launch
    counts, the kernel records and the run's figures (the merge frame, the
    correction's ms, the longest frame walls of the second session)."""
    import shutil

    import torch

    from tpuslam_torch import _build, run
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import InertialConfig, LoopConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.imu.preintegration import ImuCalib
    from tpuslam_torch.place import save_orbvoc_text
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_vi_merge as vm

    from torch_async import paced

    torch.set_num_threads(2)
    check(branch == "b" or not async_mapping, "phase 16 runs branch a synchronously only")
    name = f"vi_merge_{branch}" + ("_async" if async_mapping else "")
    t_phase = time.perf_counter()
    n_a, start, n_b = N_VI_MERGE[branch + ("_async" if async_mapping else "")]
    kw = dict(height=H, width=W, fx=FX, fy=FY)
    seq, sessions = (vm.heave_sessions(n_a, start, n_b, **kw) if branch == "a"
                     else vm.loop_sessions(n_a, start, n_b, **kw))
    frames = render(seq, seq.n_frames, "stereo")
    # the vocabulary on the synchronous branch's frames (the async one runs
    # longer), so both branches look for the merge with the same words
    n_voc = sum(N_VI_MERGE[branch][1:])
    voc = vm.vocabulary(seq, N_FEATURES, device=dev,
                        frames=[frames[i][0] for i in range(0, n_voc, n_voc // vm.VOCAB_FRAMES)])
    log(f"[{name}] rendered {seq.n_frames} stereo frames {W}x{H} ({seq.traj.kind} heave, "
        f"{seq.traj.speed} m/s) and trained a vocabulary in {time.perf_counter() - t_phase:.1f} s;"
        f" sessions: frames 0..{n_a - 1}, then {start}..{start + n_b - 1} from "
        f"{vm.T0_SECOND} s")
    root = _build.BUILD_DIR.parent / name
    with vi_merge_probe() as probe:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        if branch == "a":
            script = vm.synth_script()
            shutil.rmtree(root, ignore_errors=True)
            trees = [str(root / s) for s in ("MH01", "MH02")]
            for sess, tree in zip(sessions, trees):
                yaml_path = script.write_euroc(
                    sess, tree, n_features=N_FEATURES,
                    images=[frames[sess.start + i] for i in range(sess.n_frames)])
            save_orbvoc_text(voc, str(root / "voc.txt"))
            argv = ["--dataset", "euroc", "--path", ",".join(trees), "--settings", yaml_path,
                    "--sensor", "stereo_imu", "--vocab", str(root / "voc.txt"), "--output",
                    str(root / "traj.txt"), "--device", str(dev)]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rep = run.main(argv)
            slam = probe.systems[0]
            traj = np.loadtxt(root / "traj.txt", ndmin=2)
            log(f"[{name}] python -m tpuslam_torch.run {' '.join(argv)}: report {json.dumps(rep)}")
        else:
            cfg = vi_config()
            cfg.tracking.min_stereo_init_features = 200
            cfg.inertial = InertialConfig(**vm.SHORT_SCHEDULE)
            cfg.loop = LoopConfig(background_gba=False)
            slam = probe.attach(System(
                Pinhole([FX, FY, seq.cx, seq.cy], W, H), cfg, sensor=Sensor.IMU_STEREO,
                imu_calib=ImuCalib(**VI_NOISE, freq=seq.imu_rate), bf=FX * BASELINE, vocab=voc,
                async_mapping=async_mapping, device=dev))
            for s, sess in enumerate(sessions):
                if s:
                    slam.change_dataset()
                for i, t in enumerate(sess.timestamps()):
                    if async_mapping:
                        paced(slam)
                    slam.track_stereo(*frames[sess.start + i], float(t),
                                      imu=vm.session_imu(sess, i))
            if async_mapping:
                slam.async_mapper.flush(raise_errors=False)
            slam.shutdown()
            traj = np.asarray(slam.trajectory_tum())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts_now()
    shutil.rmtree(root, ignore_errors=True)
    m, tr, rows = slam.map, slam.tracker, probe.rows
    gates = vm.joint_gates(m, traj, sessions)
    fps = seq.fps

    def frame_of(t):
        return int(round(t * fps)) if t < vm.T0_SECOND else n_a + int(round((t - vm.T0_SECOND)
                                                                            * fps))

    events = [(e["event"], frame_of(e["t"])) for e in slam.local_mapper.debug_events]
    tries = [(x["frame"], x["kf"], x["cand"], round(x["s"], 6), x["yaw_removed"])
             for x in probe.tries]
    merge_frames = [x["frame"] for x in probe.merges]
    fused = [r for r in rows if r["fused_vi"] and not r["host"]]
    log(f"[{name}] {len(rows)} frames in {wall:.1f} s; IMU events (event, frame) {events}; "
        f"merges {probe.merges}; merges aborted before the young map's IMU init "
        f"{slam.loop_closer.merges_aborted}; merge tries (frame, KFs, Sim3 scale before the "
        f"gates, rotation removed by the yaw projection in rad) {tries}; the correction's "
        f"parts {probe.parts}; card {smi}")
    log(f"[{name}] joint gates on {gates['rows']} rows: unscaled ATE {gates['ate'] * 100:.3f} cm,"
        f" Horn scale {gates['scale']:.5f}, |R[2,2]| {gates['r22']:.6f}, median KF velocity "
        f"error {gates['vel']:.4f} m/s, finite {gates['finite']}; state "
        f"{slam.get_tracking_state().name}, maps {m.map_ids()}, {len(m.valid_kf_ids())} KFs")
    stage_table(name, GLOBAL_TIMER)
    if merge_frames:
        for what, ms in (("before", probe.wall[n_a:merge_frames[0]]),
                         ("after", probe.wall[merge_frames[0] + 1:])):
            if ms:
                log(f"[{name}] second session's frames {what} the merge: {len(ms)}, median "
                    f"{np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms, max "
                    f"{max(ms):.1f} ms")
    errors = list(slam.async_mapper.errors) if async_mapping else []
    # the second session's frames whose track_stereo call overlapped the
    # correction (the loop closer holds the map lock throughout)
    under_lock = []
    if probe.merges and "span" in probe.merges[0]:
        c0, c1 = probe.merges[0]["span"]
        under_lock = [w for w, (f0, f1) in zip(probe.wall, probe.spans) if f0 < c1 and f1 > c0]
    figures = dict(merge_frame=merge_frames[0] if merge_frames else None,
                   correct_ms=probe.merges[0].get("ms") if probe.merges else None,
                   max_wall_second=max(probe.wall[n_a:]),
                   max_wall_under_lock=max(under_lock) if under_lock else None,
                   aborted=len(slam.loop_closer.merges_aborted))
    if merge_frames:
        # which rows carry the joint ATE: each row's error on the gates'
        # alignment, by where its frame sits against the correction
        t_rows, err = vm.row_errors(traj, sessions)
        f_rows = np.array([frame_of(t) for t in t_rows])
        m0 = merge_frames[0]
        c0, c1 = probe.merges[0].get("span", (0.0, 0.0))
        overlapped = {i for i, (f0, f1) in enumerate(probe.spans) if f0 < c1 and f1 > c0}
        parts = {"A": f_rows < n_a, "B before the merge": (f_rows >= n_a) & (f_rows < m0),
                 "B from the merge on": f_rows >= m0}
        figures["row_rms_cm"] = {k: round(float(np.sqrt(np.mean(err[sel] ** 2))) * 100, 3)
                                 for k, sel in parts.items() if sel.any()}
        figures["worst_rows"] = [(int(f_rows[j]), round(float(err[j]) * 100, 3),
                                  int(f_rows[j]) - m0, int(f_rows[j]) in overlapped)
                                 for j in np.argsort(-err)[:8]]
        log(f"[{name}] the rows' error on the joint alignment, RMS by part (cm) "
            f"{figures['row_rms_cm']}; the 8 largest (frame, cm, frames from the merge's, "
            f"the frame overlapped the correction) {figures['worst_rows']}")
    log(f"[{name}] launches {launches}; fused VI frames {len(fused)}; the correction "
        f"{figures['correct_ms']} ms; frames overlapping it {len(under_lock)}, longest wall "
        f"{figures['max_wall_under_lock']} ms; the second session's longest frame wall "
        f"{figures['max_wall_second']:.1f} ms"
        + (f"; worker errors {errors}" if async_mapping else ""))
    check(not errors, f"{name}: mapper errors {errors}")
    check(branch == "b" or (rep["maps"] == 1 and rep["state"] == "OK"), f"{name}: report")
    check(len(probe.merges) == 1 and merge_frames[0] >= n_a, f"{name}: merges {probe.merges}")
    check(probe.merges[0]["imu"] and (branch == "a" or probe.merges[0]["ba1"]),
          f"{name}: the merge ran before the young map's IMU init (b: VIBA1)")
    check(max(r["maps"] for r in rows) == 2 and rows[-1]["maps"] == 1,
          f"{name}: map counts {sorted(set(r['maps'] for r in rows))}")
    check(slam.get_tracking_state().name == "OK" and m.map_ids() == [0]
          and m.current_map_id == 0, f"{name}: final state or maps")
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    check(all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
          and all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf)),
          f"{name}: something is left in the young map")
    check(gates["ok"], f"{name}: joint gates {gates}")
    redecided = redecided_frames(rows, slam.local_mapper.debug_events, name)
    check(all(r["patch"] == 2 for i, r in enumerate(rows) if i not in redecided),
          f"{name}: patch gathers per frame {sorted(set(r['patch'] for r in rows))} != 2")
    check(len(fused) >= 1 and all(r["pose"] == 4 and r["vi_solves"] == 1 for r in fused),
          f"{name}: a fused VI frame did not make 4 pose-LM launches and one "
          f"pose_inertial_solve")
    check(len(probe.captured) == 1, f"{name}: no fused VI frame after the merge")
    gathers, calls, at = probe.captured[0]
    check(len(gathers) == 2 and len(calls) == 4, f"{name}: {len(gathers)} gathers, "
          f"{len(calls)} pose-LM calls kept on frame {at}")
    shapes = {"patch_gather": {side: patch_compare(*g, f"{name} frame {at} {side}")
                               for side, g in zip(("left", "right"), gathers)},
              "pose_lm": fused_vi_lm_compare(calls, name, smi)}
    shapes["frame"] = at
    log(f"[{name}] phase 16 ({branch}{', async' if async_mapping else ''}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, shapes, figures


def phase_mono_vi_merge(dev, smi):
    """Phase 17: two mono-inertial sessions over one place merged into one
    Atlas map, at full width (f32): tests/torch_mono_vi_merge.py's sessions
    (tests/torch_vi_merge.py's loop_sessions seen by the left camera; the
    second session comes round to the first's arc after its own two-view
    init and IMU init, before its VIBA2) through
    System(sensor=IMU_MONOCULAR).track_monocular(..., imu=) with
    change_dataset() between them and a vocabulary trained here. Gates: one
    merge, inside the second session and after its IMU init, the map count
    2 -> 1, OK at the end, nothing left in the young map, the mono-inertial
    gates on one alignment of both sessions' rows and the sessions' Horn
    scales within 5 %, 1 patch gather per frame and 4 pose LMs and a
    pose_inertial_solve per fused VI frame; the first fused VI frame after
    the merge holds both kernels against their plain versions. Then the
    control, the same frames without a vocabulary: 2 maps at the end, OK.
    Returns the launch counts, the kernel records and the run's figures
    (with the control's)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_mono_vi_merge as mv
    import torch_vi_merge as vm

    torch.set_num_threads(2)
    t_phase = time.perf_counter()
    seq, sessions = mv.sessions(*N_MONO_VI_MERGE, height=H, width=W, fx=FX, fy=FY)
    used = [s.start + i for s in sessions for i in range(s.n_frames)]
    frames = render(seq, seq.n_frames, only=used)
    voc = vm.vocabulary(seq, N_FEATURES, device=dev,
                        frames=[frames[i] for i in used[::len(used) // vm.VOCAB_FRAMES]]
                        [:vm.VOCAB_FRAMES])
    log(f"[mono_vi_merge] rendered {len(used)} frames {W}x{H} ({seq.traj.kind} heave, "
        f"{seq.traj.speed} m/s) and trained a vocabulary in {time.perf_counter() - t_phase:.1f}"
        f" s; sessions: frames 0..{sessions[0].n_frames - 1}, then {sessions[1].start}.."
        f"{sessions[1].start + sessions[1].n_frames - 1} from {sessions[1].t0} s")
    launches, shapes, figures = _mono_vi_merge_run(dev, smi, mv, seq, sessions, frames, voc)
    control = [type(x)(seq, x.start, n, x.t0) for x, n in zip(sessions, N_MONO_VI_CONTROL)]
    t0 = time.perf_counter()
    figures["control"] = _mono_vi_merge_run(dev, smi, mv, seq, control, frames, None)
    log(f"[mono_vi_merge] the control over A's frames 0..{N_MONO_VI_CONTROL[0] - 1} and B's "
        f"first {N_MONO_VI_CONTROL[1]} in {time.perf_counter() - t0:.1f} s")
    log(f"[mono_vi_merge] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes, figures


def _mono_vi_merge_run(dev, smi, mv, seq, sessions, frames, voc):
    """One run of phase 17 on its frames: with the vocabulary, the merge's
    gates and kernels (returns the launch counts, the kernel records and the
    figures); without one, the control (returns its figures)."""
    import torch

    from tpuslam_torch.engine.config import TrackingConfig
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    with_vocab = voc is not None
    name = "mono_vi_merge" + ("" if with_vocab else "_control")
    n_a = sessions[0].n_frames
    cfg = mv.config(N_FEATURES)
    base = TrackingConfig()
    cfg.tracking.motion_model_radius = base.motion_model_radius * W / 376.0
    cfg.tracking.init_window = base.init_window * W / 376.0
    with vi_merge_probe(gathers=1) as probe:
        slam = probe.attach(mv.port_system(seq, voc, device=dev, cfg=cfg))
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        rec = mv.drive(slam, sessions, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts_now()
    m, tr, rows = slam.map, slam.tracker, probe.rows
    traj = np.asarray(slam.trajectory_tum())
    events = {s: [e[:2] for e in rec["events"] if (e[1] >= n_a) == bool(s)] for s in (0, 1)}
    inits = [next((i for i, r in enumerate(rec["rows"]) if r[0] == s and r[4] == "OK"), None)
             for s in (0, 1)]
    log(f"[{name}] {len(rows)} frames in {wall:.1f} s; two-view inits on frames {inits}; IMU "
        f"events (event, frame) of A "
        f"{events[0]}, of B {events[1]}; scale refinements (frame, keyframes, first and last "
        f"stamp) {[(f, len(c), a, b) for f, c, a, b in rec['refinements']]}; card {smi}")
    if not with_vocab:
        check(rec["merges"] == [] and m.map_ids() == [0, 1]
              and slam.get_tracking_state().name == "OK", f"{name}: {m.map_ids()}")
        return dict(maps=m.map_ids(), state=slam.get_tracking_state().name, rows=len(traj),
                    inits=inits, events=[e[:2] for e in rec["events"]])
    gates = mv.mono_gates(m, traj, sessions)
    log(f"[{name}] gates on {gates['rows']} rows: scaled ATE {gates['ate'] * 100:.3f} cm, Horn "
        f"scale {gates['scale']:.5f}, |R[2,2]| {gates['r22']:.6f}, median KF velocity error "
        f"{gates['vel']:.4f} m/s, finite {gates['finite']}, the sessions' Horn scales "
        f"{gates['scales'][0]:.5f} / {gates['scales'][1]:.5f} ({gates['agree'] * 100:.2f} % "
        f"apart); state {slam.get_tracking_state().name}, maps {m.map_ids()}")
    merges = rec["merges"]
    tries = [(x["frame"], x["kf"], x["cand"], round(x["s"], 6), x["yaw_removed"])
             for x in probe.tries]
    log(f"[{name}] merges (frame, kf, cand, Sim3 scale, IMU flags, the mapper's stage, each "
        f"map's Horn scale and keyframes just before the correction) {merges}; merges aborted "
        f"before the young map's IMU init {rec['aborted']}; merge tries (frame, KFs, Sim3 scale "
        f"before the gates, rotation removed by the yaw projection in rad) {tries}; the "
        f"correction's parts {probe.parts}")
    stage_table(name, GLOBAL_TIMER)
    merge_frame = merges[0][0] if merges else len(rows)
    walls = {}
    for what, ms in (("before", probe.wall[n_a:merge_frame]),
                     ("after", probe.wall[merge_frame + 1:])):
        if ms:
            walls[what] = (float(np.median(ms)), float(np.percentile(ms, 90)))
            log(f"[{name}] B's frames {what} the merge: {len(ms)}, median {walls[what][0]:.2f} "
                f"ms, p90 {walls[what][1]:.2f} ms, max {max(ms):.1f} ms")
    fused = [r for r in rows if r["fused_vi"] and not r["host"]]
    log(f"[{name}] launches {launches}; fused VI frames {len(fused)}; patch gathers per frame "
        f"{sorted(set(r['patch'] for r in rows))}")
    check(len(merges) == 1 and merges[0][0] >= n_a and merges[0][4][0],
          f"{name}: merges {merges} (one, inside B, after B's IMU init)")
    check(max(r["maps"] for r in rows) == 2 and rows[-1]["maps"] == 1,
          f"{name}: map counts {sorted(set(r['maps'] for r in rows))}")
    check(slam.get_tracking_state().name == "OK" and m.map_ids() == [0]
          and m.current_map_id == 0 and m.imu_initialized, f"{name}: final state or maps")
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    check(all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
          and all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf)),
          f"{name}: something is left in the young map")
    check(gates["ok"], f"{name}: gates {gates}")
    check(all(r["patch"] == 1 for r in rows),
          f"{name}: patch gathers per frame {sorted(set(r['patch'] for r in rows))} != 1")
    check(len(fused) >= 1 and all(r["pose"] == 4 and r["vi_solves"] == 1 for r in fused),
          f"{name}: a fused VI frame did not make 4 pose-LM launches and one "
          f"pose_inertial_solve")
    check(len(probe.captured) == 1, f"{name}: no fused VI frame after the merge")
    gathers, calls, at = probe.captured[0]
    check(len(gathers) == 1 and len(calls) == 4, f"{name}: {len(gathers)} gathers, "
          f"{len(calls)} pose-LM calls kept on frame {at}")
    shapes = {"patch_gather": patch_compare(*gathers[0], f"{name} frame {at}"),
              "pose_lm": fused_vi_lm_compare(calls, name, smi), "frame": at}
    figures = dict(merge=merges[0][:4], map_scales=merges[0][6], stage=merges[0][5],
                   aborted=rec["aborted"], events=[e[:2] for e in rec["events"]], gates=gates,
                   walls=walls,
                   yaw_removed=[x[4] for x in tries if x[4] is not None])
    return launches, shapes, figures


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

    from tpuslam_torch.engine.config import OrbConfig, SlamConfig, TrackingConfig
    from tpuslam_torch.engine.system import Sensor, System
    from tpuslam_torch.engine.tracking import State
    from tpuslam_torch.eval.ate import ate_rmse
    from tpuslam_torch.io.synthetic import SyntheticSequence
    from tpuslam_torch.ops import orb, patch_cuda
    from tpuslam_torch.solve import pose_opt_dispatch
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_fisheye_rig import kb8_rig

    cam, cam2, Trl = kb8_rig(FISH_WH, FISH_BASELINE)   # the 256 px rig, fx, fy, cx, cy doubled
    seq = SyntheticSequence(seed=0, n_frames=N_FISH, fps=FISH_FPS, speed=0.5, camera=cam,
                            camera2=cam2, Trl=Trl)
    t0 = time.perf_counter()
    frames = render(seq, N_FISH, "stereo")
    log(f"[fisheye] rendered {N_FISH} KB8 stereo pairs {FISH_WH}x{FISH_WH} in "
        f"{time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
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
    can read the run's map after the call, with the host wall ms of each of
    its track_stereo calls (frame_ms), their (start, end) perf_counter spans
    and the tracking state after each."""

    def __enter__(self):
        from tpuslam_torch import run

        self.systems, self.saved = [], run.System
        systems, base = self.systems, run.System

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.frame_ms, self.spans, self.states = [], [], []
                systems.append(self)

            def track_stereo(self, *a, **kw):
                t0 = time.perf_counter()
                out = super().track_stereo(*a, **kw)
                t1 = time.perf_counter()
                self.frame_ms.append((t1 - t0) * 1e3)
                self.spans.append((t0, t1))
                self.states.append(self.get_tracking_state().name)
                return out

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


class loop_probe:
    """Record every Atlas merge a LoopCloser corrects, (frame id of the
    current keyframe, current keyframe, candidate keyframe), with the
    correction's (start, end) perf_counter span, and the host ms of each
    call of the loop closer's solvers (the Sim3 RANSAC and refinement, the
    essential graph, the weld BA), synchronized around each call."""

    PARTS = ("sim3_ransac", "optimize_sim3", "optimize_essential_graph", "window_ba")

    def __enter__(self):
        import torch

        from tpuslam_torch.engine import loop_closing

        self.merges, self.parts, self.spans = [], [], []
        self.saved = {n: getattr(loop_closing, n) for n in self.PARTS}
        self.saved_correct = loop_closing.LoopCloser._correct_loop
        merges, parts, spans, real = self.merges, self.parts, self.spans, self.saved_correct

        def correct(closer, kf, cand, *a, merge=False, **kw):
            t0 = time.perf_counter()
            out = real(closer, kf, cand, *a, merge=merge, **kw)
            if merge:
                merges.append((int(closer.map.kf_frame_id[kf]), int(kf), int(cand)))
                spans.append((t0, time.perf_counter()))
            return out

        def timed(name, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                parts.append((name, round((time.perf_counter() - t0) * 1e3, 1)))
                return out
            return call

        loop_closing.LoopCloser._correct_loop = correct
        for name, fn in self.saved.items():
            setattr(loop_closing, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        from tpuslam_torch.engine import loop_closing

        loop_closing.LoopCloser._correct_loop = self.saved_correct
        for name, fn in self.saved.items():
            setattr(loop_closing, name, fn)


def phase_cli(dev, smi, images, images_b):
    """python -m tpuslam_torch.run on EuRoC trees written to disk; returns
    the launch counts of runs A, B and C. images: phase 4's first N_CLI
    rendered stereo pairs, the frames of this phase's sequence; images_b:
    its frames CLI_B_START .. CLI_B_START + N_CLI - 1, run C's second
    session."""
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

    # run C: two sessions over one place, merged into one Atlas map (EuRoC's
    # MH01 -> MH02). Session A is run A's tree; session B is phase 4's
    # frames 20..59 written as a second tree, its first camera ~0.5 m along
    # A's path, its stamps after A's, its ground truth in the same world.
    t_c = time.perf_counter()
    room = SyntheticSequence(seed=0, n_frames=CLI_B_START + N_CLI, fps=CLI_FPS, speed=0.5,
                             baseline=BASELINE, height=H, width=W, fx=FX, fy=FY)
    check(np.array_equal(u8(room.frame(CLI_B_START + N_CLI - 1, right=True)), images_b[-1][1]),
          "cli C: phase 4's frames are not this sequence's")
    tree_b = root / "euroc_b"
    script.write_euroc(script.SessionView(room, CLI_B_START, N_CLI, CLI_B_T0), str(tree_b),
                       n_features=N_FEATURES, images=images_b)
    gt = np.concatenate([datasets.load_euroc(str(t), stereo=True).gt for t in (tree, tree_b)])
    # run E, the same trees as two monocular sessions, in a process of its own
    cli_e = PhaseInChild("phase_cli_e", dev, smi, [str(tree), str(tree_b)], paths["txt"],
                         yaml_path, str(root))
    out["c"] = str(root / "c_traj.txt")
    argv = ["--dataset", "euroc", "--path", f"{tree},{tree_b}", "--settings", yaml_path,
            "--sensor", "stereo", "--vocab", paths["txt"], "--output", out["c"]]
    with recorded_systems() as systems, loop_probe() as probe:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts["cli_c"] = counts_now()
    slam, merges = systems[0], probe.merges
    log(f"[cli C] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[cli C] report {json.dumps(rep)}; run.main wall {wall:.1f} s; launches "
        f"{counts['cli_c']}; merges (frame id, KF, candidate KF) {merges}; loops closed "
        f"{slam.loop_closer.n_loops_closed}; card {smi}")
    stage_table("cli C", GLOBAL_TIMER)
    log(f"[cli C] loop closer solvers, call by call (host ms, synchronized): {probe.parts}")
    for name, ms in (("A", slam.frame_ms[:N_CLI]), ("B", slam.frame_ms[N_CLI:])):
        log(f"[cli C] session {name}: {len(ms)} frames, median {np.median(ms):.2f} ms, p90 "
            f"{np.percentile(ms, 90):.2f} ms, max {max(ms):.1f} ms (host wall of track_stereo)")
    traj = np.loadtxt(out["c"], ndmin=2)          # t x y z qx qy qz qw
    i_e, i_g = associate(traj[:, 0], gt[:, 0])
    rmse, _ = ate_rmse(traj[i_e, 1:4], gt[i_g, 1:4], with_scale=False)
    log(f"[cli C] trajectory file: {len(traj)} rows ({len(i_e)} matched to both trees' ground "
        f"truth), joint unscaled ATE {rmse * 100:.3f} cm; merge on frame "
        f"{merges[0][0] if merges else None} (session B's frame "
        f"{merges[0][0] - N_CLI if merges else None})")
    check(rep["state"] == "OK" and rep["maps"] == 1 and rep["frames"] == 2 * N_CLI,
          f"cli C: report {rep}")
    check(len(merges) == 1 and merges[0][0] >= N_CLI and slam.loop_closer.n_loops_closed == 1,
          f"cli C: merges {merges}, loops closed {slam.loop_closer.n_loops_closed}")
    check(len(traj) == 2 * N_CLI and len(i_e) == len(traj) and rmse < 0.05,
          f"cli C: {len(traj)} rows, {len(i_e)} matched, joint ATE {rmse}")
    check(counts["cli_c"]["patch_gather"] == 2 * 2 * N_CLI,
          f"cli C: {counts['cli_c']['patch_gather']} patch-gather launches, not 2 per frame")
    check(counts["cli_c"]["pose_lm"] > 0, "cli C: no pose-LM launch")
    log(f"[cli C] run C in {time.perf_counter() - t_c:.1f} s")
    try:
        counts["cli_d"] = phase_cli_d(argv, out, gt, merges[0][0], smi)
    finally:
        counts["cli_e"], cli_e_shapes, figures = cli_e.result()
    log(f"[cli E] against run C (stereo, the same trees): merge on frame "
        f"{figures['merge_frame']} (run C: the keyframe of frame {merges[0][0]}), {figures}")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[cli] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return counts, cli_e_shapes


def phase_cli_d(argv_c, out, gt, merge_c, smi):
    """Phase 9 run D: run C's command (argv_c, its trees and vocabulary) with
    the mapper on its own thread and pipelined tracking (bench.py's
    configuration) across the session boundary: run C's gates and no worker
    error. Prints the merge's frame against run C's (merge_c, the frame id of
    its keyframe), the frames tracked, lost and relocalized after the
    correction, session B's median and p90 frame ms and the longest frame
    wall. Returns the launch counts."""
    import torch

    from tpuslam_torch import run
    from tpuslam_torch.eval.ate import associate, ate_rmse
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    t_d = time.perf_counter()
    out["d"] = out["c"].replace("c_traj", "d_traj")
    argv = argv_c[:argv_c.index("--output")] + ["--output", out["d"], "--async-mapping",
                                                 "--pipelined"]
    with recorded_systems() as systems, loop_probe() as probe:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
    slam, merges = systems[0], probe.merges
    errors = list(slam.async_mapper.errors)
    log(f"[cli D] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[cli D] report {json.dumps(rep)}; run.main wall {wall:.1f} s; launches {counts}; "
        f"merges (frame id, KF, candidate KF) {merges} (run C: keyframe of frame {merge_c}); "
        f"loops closed {slam.loop_closer.n_loops_closed}; worker errors {errors}; card {smi}")
    stage_table("cli D", GLOBAL_TIMER)
    if probe.spans:
        c0, c1 = probe.spans[0]
        spans = slam.spans
        at = next((i for i, (f0, f1) in enumerate(spans) if f1 > c0), len(spans))
        after = [i for i, (f0, _) in enumerate(spans) if f0 >= c1]
        states = [slam.states[i] for i in after]
        reloc = sum(1 for a, b in zip(slam.states[at:], slam.states[at + 1:])
                    if a != "OK" and b == "OK")
        under = [slam.frame_ms[i] for i, (f0, f1) in enumerate(spans) if f0 < c1 and f1 > c0]
        log(f"[cli D] the correction ({(c1 - c0) * 1e3:.1f} ms, on the mapping thread) began "
            f"in frame {at} (session B's frame {at - N_CLI}); after it {len(after)} frames: "
            f"{states.count('OK')} OK, {len(states) - states.count('OK')} not OK, {reloc} "
            f"relocalized; frames overlapping it {len(under)}, longest wall "
            f"{max(under) if under else None} ms")
    for name, ms in (("A", slam.frame_ms[:N_CLI]), ("B", slam.frame_ms[N_CLI:])):
        log(f"[cli D] session {name}: {len(ms)} frames, median {np.median(ms):.2f} ms, p90 "
            f"{np.percentile(ms, 90):.2f} ms, max {max(ms):.1f} ms (host wall of track_stereo)")
    traj = np.loadtxt(out["d"], ndmin=2)
    i_e, i_g = associate(traj[:, 0], gt[:, 0])
    rmse, _ = ate_rmse(traj[i_e, 1:4], gt[i_g, 1:4], with_scale=False)
    log(f"[cli D] trajectory file: {len(traj)} rows ({len(i_e)} matched), joint unscaled ATE "
        f"{rmse * 100:.3f} cm")
    check(rep["state"] == "OK" and rep["maps"] == 1 and rep["frames"] == 2 * N_CLI,
          f"cli D: report {rep}")
    check(not errors, f"cli D: mapper errors {errors}")
    check(len(merges) == 1 and merges[0][0] >= N_CLI and slam.loop_closer.n_loops_closed == 1,
          f"cli D: merges {merges}, loops closed {slam.loop_closer.n_loops_closed}")
    check(len(traj) == 2 * N_CLI and len(i_e) == len(traj) and rmse < 0.05,
          f"cli D: {len(traj)} rows, {len(i_e)} matched, joint ATE {rmse}")
    check(counts["patch_gather"] == 2 * 2 * N_CLI,
          f"cli D: {counts['patch_gather']} patch-gather launches, not 2 per frame")
    check(counts["pose_lm"] > 0, "cli D: no pose-LM launch")
    log(f"[cli D] run D in {time.perf_counter() - t_d:.1f} s")
    return counts


class mono_merge_probe:
    """Run E's instruments: per-frame rows of run.main's System (state, map
    count, patch-gather and pose-LM launches, whether the frame took the
    fused step, host wall ms), the merges its loop closer corrects (frame,
    keyframe pair, Sim3 scale, the correction's ms) and the kernel inputs of
    the first fused frame after the merge (its patch gather and its 4
    pose-LM calls)."""

    def __enter__(self):
        import torch

        from tpuslam_torch import run
        from tpuslam_torch.engine import loop_closing, track_device
        from tpuslam_torch.ops import orb
        from tpuslam_torch.utils.timing import GLOBAL_TIMER

        self.rows, self.merges, self.captured, self.systems = [], [], [], []
        probe, frame_gathers, frame_lm = self, [], []
        LC = loop_closing.LoopCloser
        self.saved = dict(gather=orb.extract_patches_levels, lm=track_device.pose_optimize_fused,
                          System=run.System, correct=LC._correct_loop)
        sv = self.saved

        def pending():
            return len(probe.captured) < len(probe.merges)

        def gather(levels, yx, budgets, size):
            if pending():
                frame_gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets),
                                      size))
            return sv["gather"](levels, yx, budgets, size)

        def lm(*a, **kw):
            if pending():
                frame_lm.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw)))
            return sv["lm"](*a, **kw)

        def stages():
            return [len(GLOBAL_TIMER.samples.get(n, [])) for n in ("track_fused", "track")]

        class Probed(sv["System"]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.systems.append(self)

            def track_monocular(self, *a, **kw):
                before, st = counts_now(), stages()
                frame_gathers.clear()
                frame_lm.clear()
                t0 = time.perf_counter()
                out = super().track_monocular(*a, **kw)
                wall = (time.perf_counter() - t0) * 1e3
                after, st2 = counts_now(), stages()
                row = dict(state=self.get_tracking_state().name, maps=len(self.map.map_ids()),
                           patch=after["patch_gather"] - before["patch_gather"],
                           pose=after["pose_lm"] - before["pose_lm"],
                           fused=st2[0] > st[0], host=st2[1] > st[1], ms=wall)
                probe.rows.append(row)
                if (pending() and row["fused"] and not row["host"] and len(frame_lm) == 4
                        and len(frame_gathers) == 1):
                    probe.captured.append((list(frame_gathers), list(frame_lm),
                                           len(probe.rows) - 1))
                return out

        def correct(closer, kf, cand, s, *a, merge=False, **kw):
            t0 = time.perf_counter()
            out = sv["correct"](closer, kf, cand, s, *a, merge=merge, **kw)
            if merge:
                probe.merges.append(dict(frame=len(probe.rows), kf=int(kf), cand=int(cand),
                                         s=float(s), ms=(time.perf_counter() - t0) * 1e3))
            return out

        orb.extract_patches_levels, track_device.pose_optimize_fused = gather, lm
        run.System = Probed
        LC._correct_loop = correct
        return self

    def __exit__(self, *exc):
        from tpuslam_torch import run
        from tpuslam_torch.engine import loop_closing, track_device
        from tpuslam_torch.ops import orb

        sv = self.saved
        orb.extract_patches_levels, track_device.pose_optimize_fused = sv["gather"], sv["lm"]
        run.System = sv["System"]
        loop_closing.LoopCloser._correct_loop = sv["correct"]


def mono_session_gates(traj, gt, t0_b):
    """One Sim3 alignment of both sessions' rows to both trees' ground truth
    (the joint scaled ATE) and each session's Horn scale aligned alone."""
    from tpuslam_torch.eval.ate import associate, horn_align

    i_e, i_g = associate(traj[:, 0], gt[:, 0])
    est, ref = traj[i_e, 1:4], gt[i_g, 1:4]
    res = horn_align(est, ref, with_scale=True)[3]
    second = traj[i_e, 0] >= t0_b
    return dict(rows=len(traj), matched=len(i_e), ate=float(np.sqrt((res ** 2).mean())),
                scales=[float(horn_align(est[sel], ref[sel], with_scale=True)[2])
                        for sel in (~second, second)],
                per_session=[int((~second).sum()), int(second.sum())])


def phase_cli_e(dev, smi, trees, voc, yaml_path, root):
    """Phase 9 run E: two monocular sessions over one place merged into one
    Atlas map (EuRoC's multi-session MH01 -> MH02 run with --sensor mono,
    as scripts/euroc_examples_torch.sh runs MH01 -> MH05): run C's two trees
    through `run.main --sensor mono --path A,B --vocab <.txt>`, each mono
    map at the scale of its own two-view init, the merge a Sim3 with a free
    scale. Gates: one merge, inside the second session (maps 2 -> 1), OK at
    the end, every frame from the merge on OK (none lost or relocalized), a
    joint scaled ATE of both sessions' rows under tests/test_e2e_mono.py's
    0.10, and the two sessions' Horn scales, each aligned alone, within 5 %
    of each other; 1 patch gather per frame, 4 pose LMs per fused frame.
    On the first fused frame after the merge both kernels are held against
    their plain versions (the gather bitwise, the 4 pose-LM calls with
    phase 2's tolerances) and timed. The control: the same command without
    a vocabulary ends with 2 maps, its sessions' Horn scales further apart
    than the 5 %. Runs in a process of its own beside runs C-D and phase 10.
    Returns the launch counts, the kernel records and the run's figures."""
    import torch

    from tpuslam_torch import run
    from tpuslam_torch.io import datasets
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    torch.set_num_threads(2)
    t_e = time.perf_counter()
    gt = np.concatenate([datasets.load_euroc(t, stereo=False).gt for t in trees])
    out = {k: os.path.join(root, f"e_{k}.txt") for k in ("traj", "control")}
    argv = ["--dataset", "euroc", "--path", ",".join(trees), "--settings", yaml_path,
            "--sensor", "mono", "--vocab", voc, "--output", out["traj"], "--device", str(dev)]
    with mono_merge_probe() as probe:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_now()
    slam, rows, merges = probe.systems[0], probe.rows, probe.merges
    m, tr = slam.map, slam.tracker
    traj = np.loadtxt(out["traj"], ndmin=2)
    gates = mono_session_gates(traj, gt, CLI_B_T0)
    log(f"[cli E] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[cli E] report {json.dumps(rep)}; run.main wall {wall:.1f} s; launches {counts}; "
        f"card {smi}")
    log(f"[cli E] merges (frame over both sessions, current KF, candidate KF, Sim3 scale = the "
        f"second map's units per first map unit, loop.correct ms): "
        f"{[(x['frame'], x['kf'], x['cand'], round(x['s'], 6), round(x['ms'], 1)) for x in merges]}"
        f"; the merge on session B's frame "
        f"{merges[0]['frame'] - N_CLI if merges else None}")
    stage_table("cli E", GLOBAL_TIMER)
    n = merges[0]["frame"] if merges else len(rows)
    after = [r["state"] for r in rows[n:]]
    lost = sum(1 for st in after if st != "OK")
    reloc = sum(1 for a, b in zip(after, after[1:]) if a != "OK" and b == "OK")
    log(f"[cli E] frames from the merge on: {len(after)}, {after.count('OK')} OK, {lost} not OK, "
        f"{reloc} relocalized; joint gates {gates}")
    for name, ms in (("A", [r["ms"] for r in rows[:N_CLI]]), ("B", [r["ms"] for r in rows[N_CLI:]])):
        log(f"[cli E] session {name}: {len(ms)} frames, median {np.median(ms):.2f} ms, p90 "
            f"{np.percentile(ms, 90):.2f} ms, max {max(ms):.1f} ms (host wall of "
            f"track_monocular)")
    check(rep["state"] == "OK" and rep["maps"] == 1 and rep["frames"] == 2 * N_CLI,
          f"cli E: report {rep}")
    check(len(merges) == 1 and merges[0]["frame"] >= N_CLI and slam.loop_closer.n_loops_closed == 1,
          f"cli E: merges {merges}, loops closed {slam.loop_closer.n_loops_closed}")
    check(max(r["maps"] for r in rows) == 2 and rows[-1]["maps"] == 1,
          f"cli E: map counts {sorted(set(r['maps'] for r in rows))}")
    check(lost == 0, f"cli E: {lost} frames after the merge not OK")
    pts = np.nonzero(m.mp_valid[: m.n_mp])[0]
    check(m.map_ids() == [0] and m.current_map_id == 0
          and all(m.kf_map_id[k] == 0 for p in pts for k in m.mp_obs[int(p)])
          and all(m.kf_valid[k] and m.kf_map_id[k] == 0 for k in (tr.ref_kf, tr.last_kf)),
          "cli E: something is left in the young map")
    check(gates["matched"] == gates["rows"] and min(gates["per_session"]) >= 10
          and gates["ate"] < MONO_ATE_GATE
          and abs(gates["scales"][1] / gates["scales"][0] - 1.0) < MONO_SCALE_AGREE,
          f"cli E: joint gates {gates}")
    check(all(r["patch"] == 1 for r in rows), f"cli E: patch gathers per frame "
          f"{sorted(set(r['patch'] for r in rows))} != 1")
    fused = [r for r in rows if r["fused"] and not r["host"]]
    check(fused and all(r["pose"] == 4 for r in fused),
          "cli E: a fused frame did not make 4 pose-LM launches")
    check(len(probe.captured) == 1, "cli E: no fused frame after the merge")
    gathers, calls, at = probe.captured[0]
    shapes = {"patch_gather": patch_compare(*gathers[0], f"cli E frame {at}"),
              "pose_lm": fused_vi_lm_compare(calls, "cli E", smi, "fused frame after the merge"),
              "frame": at}
    figures = dict(merge_frame=merges[0]["frame"], kfs=(merges[0]["kf"], merges[0]["cand"]),
                   sim3_scale=merges[0]["s"], correct_ms=merges[0]["ms"], after_ok=after.count("OK"),
                   after=len(after), ate=gates["ate"], scales=gates["scales"], wall=wall)
    # the control: no vocabulary, no merge, each map at its own scale
    argv = [a for a in argv if a != voc and a != "--vocab"]
    argv[argv.index("--output") + 1] = out["control"]
    with contextlib.redirect_stdout(io.StringIO()):
        rep_c = run.main(argv)
    gates_c = mono_session_gates(np.loadtxt(out["control"], ndmin=2), gt, CLI_B_T0)
    log(f"[cli E] control without a vocabulary: report {json.dumps(rep_c)}; joint gates {gates_c}")
    check(rep_c["maps"] == 2 and rep_c["state"] == "OK", f"cli E control: report {rep_c}")
    check(abs(gates_c["scales"][1] / gates_c["scales"][0] - 1.0) > MONO_SCALE_AGREE,
          f"cli E control: the sessions' scales {gates_c['scales']} agree without a merge")
    figures["control_scales"] = gates_c["scales"]
    log(f"[cli E] run E in {time.perf_counter() - t_e:.1f} s")
    return counts, shapes, figures


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


class dataset_probe:
    """Phase 18's instruments: per-frame rows of run.main's System (state,
    patch-gather and pose-LM launches, whether the frame took the fused step
    or the host path, host wall ms) and the kernel inputs of the first frame
    of the kind asked for: "fused" (its patch gathers and its 4 pose-LM
    calls) or "host" (its patch gather and the host tracker's pose solves);
    None keeps none."""

    def __init__(self, want, gathers=1):
        self.want, self.gathers = want, gathers

    def __enter__(self):
        import torch

        from tpuslam_torch import run
        from tpuslam_torch.engine import track_device, tracking
        from tpuslam_torch.ops import orb
        from tpuslam_torch.utils.timing import GLOBAL_TIMER

        self.rows, self.captured, self.systems = [], [], []
        probe, frame_gathers, frame_lm = self, [], []
        self.saved = dict(gather=orb.extract_patches_levels, fused=track_device.pose_optimize_fused,
                          host=tracking.pose_optimize, System=run.System)
        sv = self.saved

        def clone(a):
            return [x.clone() if torch.is_tensor(x) else x for x in a]

        def gather(levels, yx, budgets, size):
            if not probe.captured and probe.want is not None:
                frame_gathers.append(([lv.clone() for lv in levels], yx.clone(), list(budgets),
                                      size))
            return sv["gather"](levels, yx, budgets, size)

        def fused(*a, **kw):
            if not probe.captured and probe.want == "fused":
                frame_lm.append((clone(a), dict(kw)))
            return sv["fused"](*a, **kw)

        def host(*a, **kw):
            if not probe.captured and probe.want == "host":
                frame_lm.append((clone(a), dict(kw)))
            return sv["host"](*a, **kw)

        def stages():
            return [len(GLOBAL_TIMER.samples.get(n, [])) for n in ("track_fused", "track")]

        class Probed(sv["System"]):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.systems.append(self)
                real = self.tracker.track

                def track(*a, **kw):
                    before, st = counts_now(), stages()
                    frame_gathers.clear()
                    frame_lm.clear()
                    t0 = time.perf_counter()
                    out = real(*a, **kw)
                    wall = (time.perf_counter() - t0) * 1e3
                    after, st2 = counts_now(), stages()
                    row = dict(state=self.get_tracking_state().name,
                               patch=after["patch_gather"] - before["patch_gather"],
                               pose=after["pose_lm"] - before["pose_lm"],
                               fused=st2[0] > st[0], host=st2[1] > st[1], ms=wall)
                    probe.rows.append(row)
                    kind_ok = {"fused": row["fused"] and not row["host"] and len(frame_lm) == 4,
                               "host": row["host"] and bool(frame_lm)}.get(probe.want, False)
                    if (not probe.captured and kind_ok
                            and len(frame_gathers) == probe.gathers):
                        probe.captured.append((list(frame_gathers), list(frame_lm),
                                               len(probe.rows) - 1))
                    return out

                self.tracker.track = track

        orb.extract_patches_levels = gather
        track_device.pose_optimize_fused, tracking.pose_optimize = fused, host
        run.System = Probed
        return self

    def __exit__(self, *exc):
        from tpuslam_torch import run
        from tpuslam_torch.engine import track_device, tracking
        from tpuslam_torch.ops import orb

        sv = self.saved
        orb.extract_patches_levels = sv["gather"]
        track_device.pose_optimize_fused, tracking.pose_optimize = sv["fused"], sv["host"]
        run.System = sv["System"]


def _dataset_route(name, argv, probe, smi):
    """run.main(argv) under `probe`: (report, the probe, wall s, launches);
    prints the report, the wall, the frame times and the launches."""
    import torch

    from tpuslam_torch import run
    from tpuslam_torch.utils.timing import GLOBAL_TIMER

    with probe:
        GLOBAL_TIMER.samples.clear()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts_now()
    ms = [r["ms"] for r in probe.rows[WARMUP:]]
    log(f"[datasets {name}] python -m tpuslam_torch.run {' '.join(argv)}")
    log(f"[datasets {name}] report {json.dumps(rep)}; run.main wall {wall:.1f} s; frames "
        f"{WARMUP}.. median {np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms, max "
        f"{max(ms):.1f} ms (host wall of the tracker, the PNG decode outside it); launches "
        f"{launches}; fused frames {sum(r['fused'] and not r['host'] for r in probe.rows)}, host "
        f"frames {sum(r['host'] for r in probe.rows)}; card {smi}")
    stage_table(f"datasets {name}", GLOBAL_TIMER)
    return rep, wall, launches


def _mono_route_gates(name, rep, rows, stamps, gt_of):
    """tests/test_e2e_mono.py's gates on a monocular route's TUM rows; the
    first row is the two-view init's frame. Returns the figures."""
    from tpuslam_torch.eval.ate import ate_rmse

    first = int(np.argmin(np.abs(stamps - rows[0, 0])))
    gt = np.array([gt_of(t) for t in rows[:, 0]])
    ate, scale = ate_rmse(rows[:, 1:4], gt, with_scale=True)
    log(f"[datasets {name}] two-view init on frame {first}; {len(rows)} rows; scaled ATE "
        f"{ate * 100:.3f} cm (Horn scale {scale:.5f}) over a {np.linalg.norm(gt[-1] - gt[0]):.2f} "
        f"m path")
    check(rep["state"] == "OK" and rep["keyframes"] >= 3 and rep["map_points"] > 100
          and len(rows) >= 8 and ate < MONO_ATE_GATE,
          f"datasets {name}: report {rep}, rows {len(rows)}, scaled ATE {ate}")
    return dict(init_frame=first, rows=len(rows), ate=float(ate))


def phase_datasets(dev, smi, csv_images):
    """Phase 18: the dataset CLI's KITTI, TUM RGB-D and CSV routes at their
    published sizes: trees rendered here and written by
    scripts/make_synth_euroc_torch.py under a temporary directory, each run
    through run.main on the card. (a) KITTI00-02 stereo, (b) its image_0
    monocular, (c) TUM3 RGB-D, (d) phase 9's left frames as the fork's CSV.
    Both kernels are held against their plain versions on (a)'s first fused
    frame and (c)'s first host frame, and timed. Runs in a process of its
    own. Returns the launch counts by route, the kernel records and the
    figures."""
    import shutil
    import tempfile

    import torch

    import torch_datasets as TD
    from tpuslam_torch import _build
    from tpuslam_torch.io import datasets
    from tpuslam_torch.io.synthetic import SyntheticSequence

    torch.set_num_threads(2)
    t_phase = time.perf_counter()
    script = TD.script()
    root = tempfile.mkdtemp(prefix="datasets_", dir=_build.BUILD_DIR.parent)
    counts, shapes, figures = {}, {}, {}
    try:
        kitti = TD.kitti_sequence(N_KITTI, speed=KITTI_SPEED)
        tum = TD.tum_sequence(N_TUM)
        t0 = time.perf_counter()
        kitti_frames = render(kitti, N_KITTI, "stereo")
        tum_frames = render(tum, N_TUM, "rgbd")
        log(f"[datasets] rendered {N_KITTI} stereo pairs {kitti.width}x{kitti.height} (KITTI00-02, "
            f"{KITTI_SPEED} m/s) and {N_TUM} RGB-D frames {tum.width}x{tum.height} (TUM3) in "
            f"{time.perf_counter() - t0:.1f} s (host, {RENDER_WORKERS} processes)")
        t0 = time.perf_counter()
        k_dir, t_dir, c_dir = (os.path.join(root, d) for d in ("kitti", "tum", "csv"))
        k_yaml, k_mono_yaml = script.write_kitti(kitti, k_dir, images=kitti_frames)
        t_yaml = script.write_tum_rgbd(tum, t_dir, frames=tum_frames)
        csv_seq = SyntheticSequence(seed=0, n_frames=N_CLI, fps=CLI_FPS, speed=0.5,
                                    baseline=BASELINE, height=H, width=W, fx=FX, fy=FY)
        c_csv, c_yaml = script.write_csv(csv_seq, c_dir, n_features=N_FEATURES,
                                         images=csv_images)
        log(f"[datasets] wrote the KITTI sequence, the TUM recording and the CSV sequence in "
            f"{time.perf_counter() - t0:.1f} s (host)")
        del kitti_frames, tum_frames

        # (a) KITTI00-02 stereo: the fused step at 1241x376 / 2000 features / bf 386
        out = os.path.join(root, "kitti_stereo.txt")
        argv = ["--dataset", "kitti", "--path", k_dir, "--settings", k_yaml, "--sensor", "stereo",
                "--format", "kitti", "--kf-output", out + ".kf", "--output", out,
                "--device", str(dev)]
        probe = dataset_probe("fused", 2)
        rep, wall, counts["kitti_stereo"] = _dataset_route("a kitti stereo", argv, probe, smi)
        rows = np.loadtxt(out, ndmin=2)
        g = TD.kitti_rows_gates(rows, kitti)
        log(f"[datasets a kitti stereo] {g['rows']} KITTI rows of 12: unscaled ATE "
            f"{g['ate'] * 100:.3f} cm, Horn scale {g['scale']:.5f}; {rep['keyframes']} keyframes "
            f"({len(np.loadtxt(out + '.kf', ndmin=2))} keyframe rows)")
        check(rep["state"] == "OK" and rep["maps"] == 1 and rep["frames"] == N_KITTI
              and rows.shape == (N_KITTI, 12) and np.isfinite(rows).all(),
              f"datasets a: report {rep}, rows {rows.shape}")
        check(g["ate"] < TD.STEREO_ATE and abs(g["scale"] - 1.0) < TD.STEREO_SCALE,
              f"datasets a: gates {g}")
        check(all(r["patch"] == 2 for r in probe.rows), "datasets a: patch gathers per frame "
              f"{sorted(set(r['patch'] for r in probe.rows))} != 2")
        fused = [r for r in probe.rows if r["fused"] and not r["host"]]
        check(fused and all(r["pose"] == 4 for r in fused),
              "datasets a: a fused frame did not make 4 pose-LM launches")
        check(len(probe.captured) == 1, "datasets a: no fused frame")
        gathers, calls, at = probe.captured[0]
        check(calls[0][0][2].shape[0] == script.KITTI00_02["n_features"],
              f"datasets a: pose LM rows {calls[0][0][2].shape[0]}")
        shapes["kitti"] = {
            "patch_gather": {side: patch_compare(*gathers[j], f"KITTI frame {at} {side}")
                             for j, side in enumerate(("left", "right"))},
            "pose_lm": fused_vi_lm_compare(calls, "datasets a kitti stereo", smi, "fused frame"),
            "frame": at}
        figures["kitti_stereo"] = dict(g, wall=wall, keyframes=rep["keyframes"],
                                       median_ms=rep["median_ms"])

        # (b) KITTI00-02 monocular on the same sequence's image_0
        out = os.path.join(root, "kitti_mono.txt")
        argv = ["--dataset", "kitti", "--path", k_dir, "--settings", k_mono_yaml, "--sensor",
                "mono", "--max-frames", str(N_KITTI_MONO), "--output", out, "--device", str(dev)]
        probe = dataset_probe(None)
        rep, wall, counts["kitti_mono"] = _dataset_route("b kitti mono", argv, probe, smi)
        figures["kitti_mono"] = dict(_mono_route_gates(
            "b kitti mono", rep, np.loadtxt(out, ndmin=2), kitti.timestamps(),
            lambda t: TD.gt_center(kitti, t)), wall=wall)
        check(all(r["patch"] == 1 for r in probe.rows), "datasets b: patch gathers per frame")
        fused = [r for r in probe.rows if r["fused"] and not r["host"]]
        check(fused and all(r["pose"] == 4 for r in fused),
              "datasets b: a fused frame did not make 4 pose-LM launches")

        # (c) TUM3 RGB-D: the host path at 640x480, DepthMapFactor 5000 applied once
        out = os.path.join(root, "tum.txt")
        argv = ["--dataset", "tum_rgbd", "--path", t_dir, "--settings", t_yaml, "--sensor",
                "rgbd", "--eval", "--output", out, "--device", str(dev)]
        probe = dataset_probe("host")
        rep, wall, counts["tum_rgbd"] = _dataset_route("c tum rgbd", argv, probe, smi)
        rows = np.loadtxt(out, ndmin=2)
        g = TD.tum_rows_gates(rows, tum, t0=script.TUM_T0)
        per_frame = [r["pose"] for r in probe.rows]
        log(f"[datasets c tum rgbd] report ate_rmse {rep.get('ate_rmse')} m; the rows' unscaled "
            f"ATE {g['ate'] * 100:.3f} cm, Horn scale {g['scale']:.5f}; pose-LM launches per "
            f"frame after the first: min {min(per_frame[1:])}, median "
            f"{int(np.median(per_frame[1:]))}")
        check(rep["state"] == "OK" and rep["frames"] == N_TUM and rows.shape == (N_TUM, 8)
              and rep.get("ate_rmse", 1.0) < TD.STEREO_ATE
              and abs(g["scale"] - 1.0) < TD.STEREO_SCALE, f"datasets c: report {rep}, {g}")
        check(min(per_frame[1:]) > 0, "datasets c: a frame without a pose-LM launch")
        check(all(r["patch"] == 1 for r in probe.rows), "datasets c: patch gathers per frame")
        check(len(probe.captured) == 1, "datasets c: no host frame")
        gathers, solves, at = probe.captured[0]
        shapes["tum"] = {"patch_gather": patch_compare(*gathers[0], f"TUM frame {at}"),
                         "pose_lm": fused_vi_lm_compare(solves, "datasets c tum rgbd", smi,
                                                        "host frame", host=True),
                         "frame": at}
        figures["tum_rgbd"] = dict(g, report_ate=rep["ate_rmse"], wall=wall,
                                   median_ms=rep["median_ms"])
        check(all(r["agreement"] == 1.0 for k in ("kitti", "tum")
                  for name, r in shapes[k]["pose_lm"].items() if name.startswith("call_")),
              "datasets: a pose-LM call's inlier flags differ from the plain version's")

        # (d) the fork's CSV: phase 9's left frames, ns stamps
        out = os.path.join(root, "csv.txt")
        argv = ["--dataset", "csv", "--path", c_csv, "--settings", c_yaml, "--sensor", "mono",
                "--output", out, "--device", str(dev)]
        probe = dataset_probe(None)
        rep, wall, counts["csv_mono"] = _dataset_route("d csv mono", argv, probe, smi)
        rows = np.loadtxt(out, ndmin=2)
        stamps = datasets.load_csv_sequence(c_csv, c_dir).times
        t0_csv = script.CSV_T0_NS * 1e-9
        figures["csv_mono"] = dict(_mono_route_gates(
            "d csv mono", rep, rows, stamps, lambda t: TD.gt_center(csv_seq, t - t0_csv)),
            wall=wall)
        first = figures["csv_mono"]["init_frame"]
        check(np.array_equal(rows[:, 0], stamps[first:first + len(rows)]),
              "datasets d: the rows' stamps are not the CSV's")
        check(all(r["patch"] == 1 for r in probe.rows), "datasets d: patch gathers per frame")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[datasets] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return counts, shapes, figures


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

    # the repo and tests/ (the sequence helpers whose objects the render
    # workers unpickle); spawned processes take sys.path as it is when they
    # start
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
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
    frames = render(seq, N_SYSTEM, "stereo")
    log(f"[render] {N_SYSTEM} stereo frames {W}x{H} in {time.perf_counter() - t0:.1f} s (host, "
        f"{RENDER_WORKERS} processes)")
    records = phase_kernels(dev, seq)
    # the phases in processes of their own start where the host has cores to
    # spare, after phase 2's timings: 7, 7 (b), 15, 16 (b) async, 17 and 18
    # beside phases 3-8 (16 b async, the most sensitive to the host's load,
    # away from the heavier second group), 12 (b), 13, 14 and 16 (a, b) beside
    # 9-12; their results are taken at the end
    children = {"mono_vi": PhaseInChild("phase_mono_vi_alone", dev, smi, False),
                "mono_vi_async": PhaseInChild("phase_mono_vi_alone", dev, smi, True),
                "vi_schedule": PhaseInChild("phase_vi_schedule", dev, smi),
                "mono_vi_merge": PhaseInChild("phase_mono_vi_merge", dev, smi),
                "datasets": PhaseInChild("phase_datasets", dev, smi,
                                         [pair[0] for pair in frames[:N_CLI]]),
                "vi_merge_b_async": PhaseInChild("phase_vi_merge", dev, smi, "b", True)}
    by_path = {"fused_step": phase_slice(dev, seq, frames)}
    by_path.update(phase_system(dev, seq, frames, smi))
    cli_images, cli_b_images = frames[:N_CLI], frames[CLI_B_START:CLI_B_START + N_CLI]
    del frames
    loop_frames = render_loop()
    by_path["mono_loop"] = phase_mono_loop(dev, smi, loop_frames)
    by_path["rgbd"] = phase_rgbd(dev, smi)
    by_path["fisheye_stereo"], fish_shapes = phase_fisheye(dev, smi)
    # phase 16's branches a and b, 12 (b), 13 and 14
    children.update({f"vi_merge_{b}": PhaseInChild("phase_vi_merge", dev, smi, b[0], b != b[0])
                     for b in N_VI_MERGE if b != "b_async"})
    children.update(stereo_vi_async=PhaseInChild("phase_stereo_vi", dev, smi, True),
                    fisheye_stereo_vi=PhaseInChild("phase_fisheye_vi", dev, smi, True),
                    fisheye_mono_vi=PhaseInChild("phase_fisheye_vi", dev, smi, False))
    try:
        cli_counts, cli_e_shapes = phase_cli(dev, smi, cli_images, cli_b_images)
        by_path.update(cli_counts)
        by_path["mono_loop_dist"] = phase_dist(dev, smi, loop_frames)
        tools, rgbd_shapes = phase_tools(dev, smi, seq, cli_images)
        by_path.update(tools)
        by_path["stereo_vi"], stereo_vi_shapes, stereo_vi_figures = phase_stereo_vi(dev, smi)
    finally:
        # every child is waited for before a failure is raised
        got, failed = {}, []
        for name, child in children.items():
            try:
                got[name] = child.result()
            except AssertionError as exc:
                failed.append(exc)
        if failed:
            raise failed[0]
    by_path["mono_vi"], by_path["mono_vi_async"] = got["mono_vi"], got["mono_vi_async"]
    dataset_counts, dataset_shapes, dataset_figures = got["datasets"]
    by_path.update(dataset_counts)
    log(f"[datasets] {json.dumps(dataset_figures)}")
    by_path["vi_schedule"], vi_schedule_shapes = got["vi_schedule"]
    by_path["mono_vi_merge"], mono_vi_shapes, mono_vi_figures = got["mono_vi_merge"]
    control = mono_vi_figures.pop("control")
    log(f"[mono_vi_merge] {mono_vi_figures}; the control without a vocabulary: maps "
        f"{control['maps']}, {control['state']}, {control['rows']} rows, two-view inits on "
        f"frames {control['inits']}")
    for name in ("fisheye_stereo_vi", "fisheye_mono_vi"):
        by_path[name], shapes = got[name]
        fish_shapes.update(shapes)
    by_path["stereo_vi_async"], stereo_vi_async_shapes, figures = got["stereo_vi_async"]
    log(f"[stereo_vi_async] against phase 12's synchronous run: IMU init after frame "
        f"{figures['init_frame']} (sync {stereo_vi_figures['init_frame']}); pose_inertial "
        f"median {figures['pose_inertial_ms']} ms (sync "
        f"{stereo_vi_figures['pose_inertial_ms']} ms); longest frame wall "
        f"{figures['max_frame_ms']:.1f} ms (sync {stereo_vi_figures['max_frame_ms']:.1f} ms)")
    vi_merge_shapes, vi_merge_figures = {}, {}
    for b in N_VI_MERGE:
        by_path[f"vi_merge_{b}"], vi_merge_shapes[b], vi_merge_figures[b] = got[f"vi_merge_{b}"]
    log(f"[vi_merge_b_async] against branch b's synchronous run: {vi_merge_figures}")
    patch, lm = records
    patch["fisheye_shapes"] = fish_shapes
    patch["sensors_rgbd_shapes"] = rgbd_shapes.pop("patch_gather")
    patch["vi_schedule_shapes"] = vi_schedule_shapes["patch_gather"]
    patch["vi_merge_shapes"] = {f"{b}_{side}": dict(r, frame=v["frame"])
                                for b, v in vi_merge_shapes.items()
                                for side, r in v["patch_gather"].items()}
    patch["stereo_vi_async_shapes"] = {
        side: dict(r, frame=stereo_vi_async_shapes["frame"])
        for side, r in stereo_vi_async_shapes["patch_gather"].items()}
    patch["cli_e_shapes"] = dict(cli_e_shapes["patch_gather"], frame=cli_e_shapes["frame"])
    patch["mono_vi_merge_shapes"] = dict(mono_vi_shapes["patch_gather"],
                                         frame=mono_vi_shapes["frame"])
    patch["datasets_shapes"] = {
        **{f"kitti_{side}": dict(r, frame=dataset_shapes["kitti"]["frame"])
           for side, r in dataset_shapes["kitti"]["patch_gather"].items()},
        "tum": dict(dataset_shapes["tum"]["patch_gather"], frame=dataset_shapes["tum"]["frame"])}
    patch["max_abs_err"] = max([patch["max_abs_err"], patch["sensors_rgbd_shapes"]["max_abs_err"],
                                patch["vi_schedule_shapes"]["max_abs_err"]]
                               + [r["max_abs_err"] for r in fish_shapes.values()]
                               + [r["max_abs_err"] for r in patch["vi_merge_shapes"].values()]
                               + [r["max_abs_err"]
                                  for r in patch["stereo_vi_async_shapes"].values()]
                               + [patch["cli_e_shapes"]["max_abs_err"],
                                  patch["mono_vi_merge_shapes"]["max_abs_err"]]
                               + [r["max_abs_err"] for r in patch["datasets_shapes"].values()])
    lm["sensors_rgbd_shapes"] = rgbd_shapes
    lm["stereo_vi_shapes"] = stereo_vi_shapes
    lm["stereo_vi_async_shapes"] = dict(stereo_vi_async_shapes["pose_lm"],
                                        frame=stereo_vi_async_shapes["frame"])
    lm["vi_schedule_shapes"] = vi_schedule_shapes["pose_lm"]
    lm["vi_merge_shapes"] = {b: dict(v["pose_lm"], frame=v["frame"])
                             for b, v in vi_merge_shapes.items()}
    lm["cli_e_shapes"] = dict(cli_e_shapes["pose_lm"], frame=cli_e_shapes["frame"])
    lm["mono_vi_merge_shapes"] = dict(mono_vi_shapes["pose_lm"], frame=mono_vi_shapes["frame"])
    lm["datasets_shapes"] = {k: dict(dataset_shapes[k]["pose_lm"], frame=dataset_shapes[k]["frame"])
                             for k in ("kitti", "tum")}
    lm["max_abs_err"] = max([lm["max_abs_err"], stereo_vi_shapes.pop("max_abs_err"),
                             lm["vi_schedule_shapes"].pop("max_abs_err"),
                             lm["stereo_vi_async_shapes"].pop("max_abs_err"),
                             lm["cli_e_shapes"].pop("max_abs_err"),
                             lm["mono_vi_merge_shapes"].pop("max_abs_err")]
                            + [v.pop("max_abs_err") for v in lm["datasets_shapes"].values()]
                            + [v.pop("max_abs_err") for v in lm["vi_merge_shapes"].values()]
                            + [max(r["dR"], r["dt"]) for r in rgbd_shapes.values()])
    frames_by_path = {"fused_step": N_FRAMES - 1, "a_sync": N_SYSTEM,
                      "b_async_pipelined": N_SYSTEM, "mono_loop": N_LOOP,
                      "mono_loop_dist": N_LOOP, "rgbd": N_RGBD,
                      "mono_vi": N_VI, "mono_vi_async": N_VI, "stereo_vi": N_STEREO_VI,
                      "stereo_vi_async": N_STEREO_VI_ASYNC, "cli_d": 2 * N_CLI,
                      "fisheye_stereo": N_FISH, "fisheye_stereo_vi": N_FISH_STEREO_VI,
                      "fisheye_mono_vi": N_FISH_MONO_VI, "vi_schedule": N_VI_SCHEDULE,
                      "cli": N_CLI,
                      "cli_b": 2 * N_CLI, "cli_c": 2 * N_CLI, "cli_e": 2 * N_CLI,
                      "level0_step": N_FRAMES - 1,
                      "frontend_chain": N_CHAIN, "graft_entry": 1, "bench_system": 2 * N_BENCH,
                      "sensors_rgbd": 2 * N_SENSORS,
                      "mono_vi_merge": N_MONO_VI_MERGE[0] + N_MONO_VI_MERGE[2],
                      "kitti_stereo": N_KITTI, "kitti_mono": N_KITTI_MONO, "tum_rgbd": N_TUM,
                      "csv_mono": N_CLI,
                      **{f"vi_merge_{b}": n[0] + n[2] for b, n in N_VI_MERGE.items()}}
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
    try:
        code = main()
    finally:
        stop_render_pool()
    sys.exit(code)
