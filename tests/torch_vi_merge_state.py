"""A SlamMap's state (`tpuslam_torch.map.store.map_state`) as flat numpy
arrays, for an .npz file, and back.

`pack(states)` flattens what `map_state` returns, from tpuslam's map or the
port's, for several states of one run under their prefixes: the
struct-of-arrays fields as they are (0/1 descriptor bits packed), the
observation and covisibility dicts as (owner, key, value) rows in their
insertion order (the engine reads the first observer of a point and breaks
covisibility ties by that order), the per-keyframe camera-from-previous
poses, preintegrations and raw IMU windows as stacked rows with an owner
index, and the scalars as 0-d arrays. A keyframe's features never change,
so the states share one table of them, and each state keeps the list of
keyframes it held features for. `unpack(data, prefix)` gives
`map_from_numpy`'s input back. It imports only the port and numpy, so the
files it writes load without jax.
"""

import numpy as np

from tpuslam_torch.map.store import ARRAY_FIELDS, FEATURE_FIELDS, SCALAR_FIELDS

BITS = ("mp_bits", "feats.bits")     # 0/1 bytes, stored packed
IMU_PARTS = ("w", "a", "dt")


def _put_bits(out, name, v):
    out[name + ".shape"] = np.array(v.shape)
    out[name + ".dtype"] = np.array(str(v.dtype))
    out[name] = np.packbits(v.astype(bool), axis=-1)


def _get_bits(data, name):
    shape = tuple(int(x) for x in data[name + ".shape"])
    return np.unpackbits(data[name], axis=-1, count=shape[-1]).reshape(shape).astype(
        str(data[name + ".dtype"]))


def _dict_rows(dicts):
    rows = [(i, k, v) for i, d in enumerate(dicts) for k, v in d.items()]
    return np.array(rows, np.int64).reshape(-1, 3)


def _from_rows(rows, n):
    out = [{} for _ in range(n)]
    for i, k, v in rows:
        out[int(i)][int(k)] = int(v)
    return out


def _pack_map(arrays, prefix):
    out = {}
    for k in ARRAY_FIELDS:
        if k in BITS:
            _put_bits(out, prefix + k, np.asarray(arrays[k]))
        else:
            out[prefix + k] = np.asarray(arrays[k])
    for k in ("mp_obs", "covis"):
        out[prefix + k] = _dict_rows(arrays[k])
        out[f"{prefix}{k}_n"] = np.array(len(arrays[k]))
    tcp = arrays["kf_tcp"]
    have = [i for i, x in enumerate(tcp) if x is not None]
    out[prefix + "kf_tcp_at"] = np.array(have, np.int64)
    out[prefix + "kf_tcp_R"] = np.array([tcp[i][0] for i in have]).reshape(-1, 3, 3)
    out[prefix + "kf_tcp_t"] = np.array([tcp[i][1] for i in have]).reshape(-1, 3)
    out[prefix + "kf_tcp_n"] = np.array(len(tcp))
    pre = arrays["kf_preint"]
    have = [i for i, x in enumerate(pre) if x is not None]
    keys = sorted(pre[have[0]]) if have else []
    out[prefix + "kf_preint_at"] = np.array(have, np.int64)
    out[prefix + "kf_preint_n"] = np.array(len(pre))
    out[prefix + "kf_preint_keys"] = np.array(keys)
    for key in keys:
        out[f"{prefix}kf_preint.{key}"] = np.stack([np.asarray(pre[i][key]) for i in have])
    raw = arrays["kf_imu"]
    have = [i for i, x in enumerate(raw) if x is not None]
    out[prefix + "kf_imu_at"] = np.array(have, np.int64)
    out[prefix + "kf_imu_n"] = np.array(len(raw))
    out[prefix + "kf_imu_len"] = np.array([len(raw[i][2]) for i in have], np.int64)
    for j, name in enumerate(IMU_PARTS):
        parts = [np.asarray(raw[i][j]) for i in have]
        out[f"{prefix}kf_imu.{name}"] = (np.concatenate(parts) if parts
                                         else np.zeros((0, 3) if j < 2 else 0))
    for k in SCALAR_FIELDS:
        out[prefix + k] = np.array(arrays[k])
    return out


def pack(states):
    """states: {prefix: (arrays, feats)} as map_state returns them. Returns
    the flat arrays for np.savez_compressed."""
    out, table = {}, {}
    for prefix, (arrays, feats) in states.items():
        out.update(_pack_map(arrays, prefix))
        have = [i for i, f in enumerate(feats) if f is not None]
        out[prefix + "feats_at"] = np.array(have, np.int64)
        out[prefix + "feats_n"] = np.array(len(feats))
        for i in have:
            table.setdefault(i, feats[i])
    kfs = sorted(table)
    out["feats_kf"] = np.array(kfs, np.int64)
    for k in FEATURE_FIELDS:
        vals = [table[i][k] for i in kfs]
        if not vals or any(v is None for v in vals):
            continue
        if f"feats.{k}" in BITS:
            _put_bits(out, f"feats.{k}", np.stack(vals))
        else:
            out[f"feats.{k}"] = np.stack(vals)
    return out


def unpack(data, prefix):
    """(arrays, feats) of the state stored under `prefix`."""
    arrays = {k: (_get_bits(data, prefix + k) if k in BITS else np.array(data[prefix + k]))
              for k in ARRAY_FIELDS}
    for k in ("mp_obs", "covis"):
        arrays[k] = _from_rows(data[prefix + k], int(data[f"{prefix}{k}_n"]))
    tcp = [None] * int(data[prefix + "kf_tcp_n"])
    for i, R, t in zip(data[prefix + "kf_tcp_at"], data[prefix + "kf_tcp_R"],
                       data[prefix + "kf_tcp_t"]):
        tcp[int(i)] = (np.array(R), np.array(t))
    arrays["kf_tcp"] = tcp
    pre = [None] * int(data[prefix + "kf_preint_n"])
    keys = [str(k) for k in data[prefix + "kf_preint_keys"]]
    for r, i in enumerate(data[prefix + "kf_preint_at"]):
        pre[int(i)] = {k: np.array(data[f"{prefix}kf_preint.{k}"][r]) for k in keys}
    arrays["kf_preint"] = pre
    raw = [None] * int(data[prefix + "kf_imu_n"])
    ends = np.cumsum(data[prefix + "kf_imu_len"])
    for i, e, n in zip(data[prefix + "kf_imu_at"], ends, data[prefix + "kf_imu_len"]):
        raw[int(i)] = tuple(np.array(data[f"{prefix}kf_imu.{name}"][e - n:e])
                            for name in IMU_PARTS)
    arrays["kf_imu"] = raw
    for k in SCALAR_FIELDS:
        arrays[k] = data[prefix + k].item()
    row = {int(k): r for r, k in enumerate(data["feats_kf"])}
    cols = {k: (_get_bits(data, f"feats.{k}") if f"feats.{k}" in BITS
                else np.array(data[f"feats.{k}"]))
            for k in FEATURE_FIELDS if f"feats.{k}" in data}
    feats = [None] * int(data[prefix + "feats_n"])
    for i in data[prefix + "feats_at"]:
        feats[int(i)] = {k: (cols[k][row[int(i)]] if k in cols else None)
                         for k in FEATURE_FIELDS}
    return arrays, feats
