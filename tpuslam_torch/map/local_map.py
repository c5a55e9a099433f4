"""Local-map tensors of the fused step from one stereo keyframe (numpy).

This is how tpuslam initialises a stereo map and packs it for the fused
step, with the keyframe at the identity pose:
  - the point spawn of Tracking._initialize_stereo / _spawn_stereo_points
    (tpuslam/engine/tracking.py): every valid feature with depth > 0
    becomes a point, in order of increasing depth;
  - the per-point statistics of SlamMap.update_point_stats
    (tpuslam/map/store.py) for a single observation: normal = X/|X|,
    max_dist = |X| * sf[octave], min_dist = max_dist / sf[-1];
  - the packing of FusedTracker._rebuild (tpuslam/engine/track_device.py),
    padded to the P bucket with tpuslam.utils.pad.
"""

from __future__ import annotations

import numpy as np

from tpuslam.utils.pad import bucket, pad_to


def stereo_local_map(feats_np, fx, fy, cx, cy, scale_factors, p_base: int = 2048):
    """feats_np: dict of numpy arrays of one extracted stereo frame (at
    least und_xy, octave, angle, bits, valid, depth).

    Returns (mapGeo [Pb,8] f32, mapBits [Pb,256] u8, mapValid [Pb] bool,
    refBits [N,256] u8, refMeta [N,2] f32 = angle | map row or -1)."""
    und = np.asarray(feats_np["und_xy"], np.float64)
    depth = np.asarray(feats_np["depth"], np.float64)
    valid = np.asarray(feats_np["valid"], bool)
    octave = np.asarray(feats_np["octave"], np.int64)
    bits = np.asarray(feats_np["bits"], np.uint8)
    angle = np.asarray(feats_np["angle"], np.float64)
    sf = np.asarray(scale_factors, np.float64)

    free = valid & (depth > 0)
    order = np.argsort(np.where(free, depth, np.inf))
    slots = order[: int(free.sum())]          # spawn order = point id order
    if len(slots) < 30:
        raise ValueError(f"only {len(slots)} stereo points; need >= 30")
    z = depth[slots]
    norm = np.stack([(und[slots, 0] - cx) / fx, (und[slots, 1] - cy) / fy], 1)
    X = np.stack([norm[:, 0] * z, norm[:, 1] * z, z], 1)   # camera = world
    dist = np.linalg.norm(X, axis=1)
    normal = X / dist[:, None]                 # mean of one unit direction,
    normal = normal / np.linalg.norm(normal, axis=1, keepdims=True)  # renormalized
    max_dist = dist * sf[octave[slots]]
    min_dist = max_dist / sf[-1]

    P = len(slots)
    Pb = bucket(P, p_base)
    geo = np.concatenate([X, normal, min_dist[:, None], max_dist[:, None]], 1)
    mapGeo = pad_to(geo.astype(np.float32), Pb)
    mapBits = pad_to(bits[slots], Pb)
    mapValid = np.zeros(Pb, bool)
    mapValid[:P] = True
    ref_row = np.full(len(bits), -1, np.int64)
    ref_row[slots] = np.arange(P)
    refMeta = np.stack([angle, ref_row.astype(np.float64)], 1).astype(np.float32)
    return mapGeo, mapBits, mapValid, bits.copy(), refMeta
