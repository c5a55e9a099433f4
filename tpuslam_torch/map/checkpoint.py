"""Map snapshot checkpointing (port of tpuslam/map/checkpoint.py: the
same npz keys, dtypes and pickled structures).

The reference designed but DISABLED Atlas save/load (boost serialization,
System.cc:952-1099 commented out). Here the map is a struct-of-arrays, so
a checkpoint is one npz of the arrays + a pickled blob for the dynamic
host structures (observations, covisibility, feature records) — enabled
from day one (SURVEY.md §5 checkpoint/resume). The map is host state in
the port too; the blob refuses a torch tensor, so a checkpoint written by
a System on the card loads into one on the CPU.
"""

from __future__ import annotations

import io
import pickle

import numpy as np
import torch

_ARRAY_FIELDS = (
    "kf_R", "kf_t", "kf_time", "kf_valid", "kf_frame_id", "kf_mp",
    "kf_vel", "kf_bg", "kf_ba", "kf_bg0", "kf_ba0", "kf_prev", "kf_parent",
    "kf_map_id", "kf_octave_tab",
    "mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_bits",
    "mp_valid", "mp_first_kf", "mp_visible", "mp_found", "mp_replaced_by",
)
_SCALARS = ("n_kf", "n_mp", "imu_initialized", "inertial_ba1",
            "inertial_ba2", "map_version", "current_map_id",
            "n_maps_created", "n_feat", "n_levels")
_PICKLED = ("kf_feats", "kf_preint", "kf_imu", "kf_tcp", "mp_obs", "covis")


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError("a map checkpoint holds host arrays only, not a torch tensor "
                            f"({tuple(obj.shape)} on {obj.device})")
        return NotImplemented


def save_map(m, path: str):
    arrays = {name: getattr(m, name) for name in _ARRAY_FIELDS}
    arrays["scale_factors"] = m.scale_factors
    arrays["_scalars"] = np.array([int(getattr(m, s)) for s in _SCALARS])
    buf = io.BytesIO()
    _HostPickler(buf).dump({name: getattr(m, name) for name in _PICKLED})
    blob = buf.getvalue()
    arrays["_blob"] = np.frombuffer(blob, np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(m, path: str):
    data = np.load(path, allow_pickle=False)
    for name in _ARRAY_FIELDS:
        setattr(m, name, data[name].copy())
    m.scale_factors = data["scale_factors"].copy()
    scalars = data["_scalars"]
    for s, v in zip(_SCALARS, scalars):
        cur = getattr(m, s)
        setattr(m, s, bool(v) if isinstance(cur, bool) else int(v))
    blob = pickle.loads(data["_blob"].tobytes())
    for name in _PICKLED:
        setattr(m, name, blob[name])
    m.rebuild_native()
    return m
