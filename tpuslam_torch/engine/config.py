"""Configuration dataclasses of the port.

Field names and defaults are those of tpuslam's `OrbConfig`
(tpuslam/ops/orb.py) and of `TrackingConfig`, `MappingConfig`,
`InertialConfig`, `LoopConfig` and `SlamConfig` (tpuslam/engine/config.py);
a test holds them equal. They live here because the JAX package's
config module imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class OrbConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 16          # selection cell (px)
    th_cell: int = 32       # ini/min threshold cell (ref uses 30px windows)

    def level_budgets(self):
        f = 1.0 / self.scale
        w = np.array([f ** l for l in range(self.n_levels)])
        n = np.floor(self.n_features * w / w.sum()).astype(int)
        n[-1] += self.n_features - n.sum()
        return [int(v) for v in n]

    def level_scales(self):
        return [self.scale ** l for l in range(self.n_levels)]


@dataclass
class TrackingConfig:
    # matching radii (px, scaled by pyramid level)
    init_window: float = 100.0           # SearchForInitialization window
    motion_model_radius: float = 15.0    # mono th (Tracking.cc:1914 th=15)
    local_map_radius: float = 4.0        # RadiusByViewingCos default
    local_map_radius_tight: float = 2.5  # cos > 0.998
    reloc_radius: float = 10.0
    # inlier thresholds
    min_matches_init: int = 100          # Tracking.cc:1508 (mono init)
    min_stereo_init_features: int = 500  # Tracking.cc:1354 stereo init
    min_inliers_motion: int = 10
    min_matches_motion: int = 20
    min_inliers_local: int = 30          # TrackLocalMap gate (Tracking.cc:2060)
    # keyframe policy
    max_frames_between_kf: int = 10      # ~fps; ref mMaxFrames = fps
    min_frames_between_kf: int = 0
    kf_ref_ratio: float = 0.9            # mono thRefRatio (Tracking.cc:2180)
    min_kf_inliers: int = 15
    time_recently_lost: float = 5.0      # ref Tracking.cc time_recently_lost
    # matcher ratios (ORBmatcher ctor args across call sites)
    nn_ratio_init: float = 0.9
    nn_ratio_ref_kf: float = 0.7
    nn_ratio_local: float = 0.8
    nn_ratio_triangulate: float = 0.6
    # fused step: local-map re-association passes and the stereo SAD mode
    # ("pyramid" = per-octave reference semantics, "level0" = single-level
    # gathers, cheaper)
    fused_passes: int = 3
    fused_sad: str = "pyramid"
    # pipelined fused tracking (frame t dispatched before t-1 is fetched)
    pipelined: bool = False


@dataclass
class MappingConfig:
    n_triangulate_neighbors: int = 20    # mono (LocalMapping.cc:387 nn=20)
    min_baseline_depth_ratio: float = 0.01  # LocalMapping.cc:440
    fuse_radius: float = 3.0
    culling_redundancy: float = 0.9      # KeyFrameCulling 90% rule
    local_ba_iters: int = 10   # ACCEPTED steps in phase 2 (the reference's
                                 # 5+10 schedule, Optimizer.cc:2048,2121;
                                 # g2o semantics — ba_solve retries rejected
                                 # trials and exits on stall)
    recent_cull_found_ratio: float = 0.25


@dataclass
class InertialConfig:
    """IMU init schedule + inertial BA windows (ref: LocalMapping.cc:162-221
    init/VIBA1/VIBA2 state machine, Optimizer.cc:4574 LocalInertialBA)."""

    init_min_kfs: int = 10               # ref nMinKF=10 (LocalMapping.cc)
    init_min_span: float = 2.0           # s of KF history before first init
                                         # (ref mono minTime=2.0 — a younger
                                         # window passes the observability
                                         # gates by luck and locks in a bad
                                         # scale)
    viba1_time: float = 5.0              # ref LocalMapping.cc:180 mTinit>5
    viba2_time: float = 15.0             # ref :195
    local_window: int = 10               # temporal window Nd (ref maxOpt=10)
    prior_g1: float = 1e2                # init priors (ref :1244 1e2/1e10)
    prior_a1: float = 1e10
    prior_g2: float = 1.0                # VIBA1 priors (ref :186 1,1e5)
    prior_a2: float = 1e5
    reintegrate_bias_th: float = 0.01    # re-preintegrate when bias moved
    scale_refine_until: float = 75.0     # mono ScaleRefinement window (ref
                                         # LocalMapping.cc:208 25..75s)
    scale_refine_period: float = 1.5     # min seconds between refinements
    # Visual-pose noise model for the POSES-FIXED init solves (round 5).
    # The reference inverts the raw preintegration covariance and treats
    # the visual poses as exact (Optimizer.cc:5303); with an accurate
    # (synthetic/global-shutter) IMU the resulting information is stiff
    # enough that mm-level visual pose jitter dominates every edge and
    # the scale estimate collapses toward the degenerate s->0 basin
    # (measured on the engine's own init problems). Inflating the edge
    # covariance with the visual pose noise makes the init an honest
    # maximum-likelihood problem; full VI BA (poses free) keeps the
    # exact C^-1.
    init_vis_rot_sigma: float = 2e-3     # rad, per visual KF rotation
    init_vis_pos_sigma: float = 5e-3     # m (metric), per visual KF pos
    # mono init observability gate: defer IMU init while the solve's own
    # log-scale std is above this (weak excitation makes scale
    # unidentifiable; ref refuses low-excitation stereo init,
    # Tracking.cc:1363-1368 — this is the mono analogue)
    init_max_logs_sigma: float = 0.25


@dataclass
class LoopConfig:
    """Loop-closing thresholds (ref: LoopClosing.cc:560-570 nBoWMatches=20,
    nBoWInliers=15, nSim3Inliers=20, nProjMatches=50; map maturity >=12 KFs
    :276-295; essential-graph covis weight >=100 Optimizer.cc:2376)."""

    min_kfs: int = 12
    n_candidates: int = 5
    min_bow_matches: int = 20
    min_ransac_inliers: int = 15
    min_sim3_inliers: int = 20
    min_proj_matches: int = 50
    nn_ratio: float = 0.75
    proj_radius: float = 8.0
    ransac_hypotheses: int = 1024  # batched on device; more = cheaper than failing
    essential_min_weight: int = 100
    run_gba: bool = True
    # GBA runs on a transient background thread with staged corrections
    # (ref: LoopClosing.cc:1237-1244 + RunGlobalBundleAdjustment :2430);
    # False = synchronous (deterministic tests). There is NO size gate any
    # more — large maps switch to the matrix-free Schur CG automatically.
    background_gba: bool = True
    # route GBA through the obs-sharded distributed solver
    # (parallel/dist_ba.py) when more than one device is visible AND the
    # problem has at least this many observations (below it the sharding
    # overhead dominates; tests force 0 to exercise the path)
    dist_gba_min_obs: int = 20_000
    # temporal consistency: a common region must be re-confirmed on this
    # many consecutive KFs before correction (ref: LoopClosing.cc:263-500
    # mnLoopNumCoincidences >= 3; DetectAndReffineSim3FromLastKF :502).
    # The reference's main false-loop defense.
    consecutive_kfs: int = 3
    # pending candidate dropped after this many consecutive refine misses
    # (ref: mnLoopNumNotFound/mnMergeNumNotFound tolerance of 2)
    max_not_found: int = 2
    # refinement success needs this many guided-projection matches
    # (ref: DetectAndReffineSim3FromLastKF nProjMatches=30)
    min_refine_matches: int = 30


@dataclass
class SlamConfig:
    orb: OrbConfig = field(default_factory=OrbConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    inertial: InertialConfig = field(default_factory=InertialConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    # stereo / rgbd
    th_depth: float = 35.0               # close/far stereo point gate (b x 35)
    # metres per unit of the depth image track_rgbd is given (the settings
    # file's 1 / DepthMapFactor; 1 for depth in metres)
    depth_map_factor: float = 1.0
