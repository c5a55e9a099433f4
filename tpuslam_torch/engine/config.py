"""Configuration dataclasses of the port.

Field names and defaults are those of tpuslam's `OrbConfig`
(tpuslam/ops/orb.py) and `TrackingConfig` (tpuslam/engine/config.py);
a test holds them equal. They live here because the JAX package's
config module imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    # ("pyramid" = per-octave reference semantics; "level0" is not ported)
    fused_passes: int = 3
    fused_sad: str = "pyramid"
    # pipelined fused tracking (frame t dispatched before t-1 is fetched)
    pipelined: bool = False
