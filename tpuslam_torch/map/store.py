"""Array-resident SLAM map: keyframes, map points, covisibility
(port of tpuslam/map/store.py).

The reference's pointer-graph map model (ref: src/KeyFrame.cc,
MapPoint.cc, Map.cc) as struct-of-arrays with growable capacity and
validity masks. The map is host state: numpy holds the dynamic graph
(covisibility weights, spanning tree, observations) exactly as in
tpuslam, and the device work reads snapshots of it (the fused tracker's
local map, the mapping kernels' keyframe cache). One coarse lock guards
it, the reference's Map::mMutexMapUpdate.

Observation structure: kf_mp[kf, slot] = mp id (or -1) is the canonical
store (the reference's KeyFrame::mvpMapPoints); mp_obs (mp -> [(kf, slot)])
is the inverse index (the reference's MapPoint::mObservations).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native import NativeObsIndex



def _grow(arr, new_cap):
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out


@dataclass
class FrameFeatures:
    """Per-frame extracted features (host copies of extractor output)."""

    xy: np.ndarray        # [N,2] raw pixel coords (level 0 frame)
    und_xy: np.ndarray    # [N,2] undistorted pixel coords
    norm_xy: np.ndarray   # [N,2] normalized camera-plane coords
    octave: np.ndarray    # [N] int32
    angle: np.ndarray     # [N] rad
    response: np.ndarray  # [N]
    bits: np.ndarray      # [N,256] u8
    packed: np.ndarray    # [N,8] u32
    valid: np.ndarray     # [N] bool
    depth: np.ndarray | None = None   # [N] stereo/RGBD depth (<=0: none)
    u_right: np.ndarray | None = None # [N] stereo right u (<0: none)

    @property
    def n(self):
        return len(self.xy)


class SlamMap:
    """One SLAM session's map (an Atlas holds several)."""

    def __init__(self, n_feat: int, scale: float = 1.2, n_levels: int = 8,
                 map_id: int = 0):
        import threading

        self.map_id = map_id
        self.n_feat = n_feat
        # one coarse lock = the reference's Map::mMutexMapUpdate discipline
        # (held by the tracker's state machine and by async mapping stages)
        self.lock = threading.RLock()
        self.scale_factors = scale ** np.arange(n_levels)
        self.n_levels = n_levels
        # --- keyframes (SoA, capacity-doubling)
        cap = 64
        self.n_kf = 0
        self.kf_R = np.zeros((cap, 3, 3))
        self.kf_t = np.zeros((cap, 3))
        self.kf_time = np.zeros(cap)
        self.kf_valid = np.zeros(cap, bool)
        self.kf_frame_id = np.zeros(cap, np.int64)
        self.kf_mp = np.full((cap, n_feat), -1, np.int32)
        self.kf_feats: list[FrameFeatures | None] = [None] * cap
        # inertial state per KF
        self.kf_vel = np.zeros((cap, 3))
        self.kf_bg = np.zeros((cap, 3))
        self.kf_ba = np.zeros((cap, 3))
        self.kf_bg0 = np.zeros((cap, 3))  # bias the preint was integrated at
        self.kf_ba0 = np.zeros((cap, 3))
        self.kf_preint: list = [None] * cap  # Preintegrated from prev KF
        self.kf_imu: list = [None] * cap     # raw (w, a, dt) since prev KF
        self.kf_prev = np.full(cap, -1, np.int32)  # temporal chain
        self.kf_parent = np.full(cap, -1, np.int32)  # spanning tree
        self.kf_tcp: list = [None] * cap  # (Rcp, tcp) rel pose at cull time
        self.kf_map_id = np.zeros(cap, np.int32)   # Atlas: owning map label
        # --- map points
        mcap = 1024
        self.n_mp = 0
        self.mp_pos = np.zeros((mcap, 3))
        self.mp_normal = np.zeros((mcap, 3))
        self.mp_min_dist = np.zeros(mcap)
        self.mp_max_dist = np.zeros(mcap)
        self.mp_bits = np.zeros((mcap, 256), np.uint8)
        self.mp_valid = np.zeros(mcap, bool)
        self.mp_first_kf = np.full(mcap, -1, np.int32)
        self.mp_visible = np.zeros(mcap, np.int32)
        self.mp_found = np.zeros(mcap, np.int32)
        self.mp_obs: list[dict[int, int]] = []  # mp -> {kf: slot}
        self.mp_replaced_by = np.full(mcap, -1, np.int32)
        # native C++ mirror of the inverse index: serves the hot queries
        # (covisibility counting, culling redundancy); Python dicts stay
        # authoritative and the mirror tracks every mutation
        try:
            self._native = NativeObsIndex()
        except (OSError, RuntimeError):
            self._native = None
        self.kf_octave_tab = np.zeros((cap, n_feat), np.int8)
        # --- covisibility: kf -> {kf: weight}
        self.covis: list[dict[int, int]] = []
        # bookkeeping: the current map's IMU flags and the inertial mapper's
        # schedule on it (engine/local_mapping.py: the time of the IMU init,
        # the VIBA stage, the last scale refinement); each Atlas map keeps
        # its own, as the reference keeps them on Map (Map::mbImuInitialized,
        # mbIMU_BA1 / mbIMU_BA2)
        self.imu_initialized = False
        self.inertial_ba1 = False
        self.inertial_ba2 = False
        self.imu_init_time: float | None = None
        self.viba_stage = 0  # 0: before init, 1: init done, 2: VIBA1, 3: VIBA2
        self.last_refine = -1e9
        # whether the current map took in another map's keyframes (a merge):
        # a scale refinement would then rescale both sessions as one
        self.merged = False
        # the IMU state of every map that is not the current one, by map id
        self.map_imu: dict[int, dict] = {}
        # IMU sanity flag (ref: LocalMapping::mbBadImu LocalMapping.cc:138
        # -145): set by a degenerate IMU init, consumed by the tracker as
        # an active-map reset request
        self.bad_imu = False
        self.map_version = 0  # bumped on frame-changing ops (gravity align)
        # Atlas (multi-map): maps are LABELS over one SoA store — a new map
        # on tracking loss is a label bump; a merge is a Sim3 correction +
        # relabel (ref: Atlas.cc:58 CreateNewMap, LoopClosing::MergeLocal)
        self.current_map_id = 0
        self.n_maps_created = 1

    # ------------------------------------------------------------------ atlas
    def create_new_map(self):
        """ref: Atlas::CreateNewMap (Atlas.cc:58). The old map keeps its
        IMU state; the new one starts with none."""
        self.map_imu[self.current_map_id] = {k: getattr(self, k) for k in IMU_STATE}
        self.current_map_id = self.n_maps_created
        self.n_maps_created += 1
        for k, v in IMU_STATE_NEW.items():
            setattr(self, k, v)
        self.bad_imu = False
        self.map_version += 1
        return self.current_map_id

    def map_ids(self):
        ids = np.unique(self.kf_map_id[: self.n_kf][self.kf_valid[: self.n_kf]])
        return sorted(int(i) for i in ids)

    def imu_state_of(self, map_id: int) -> dict:
        """The IMU state (IMU_STATE) of an Atlas map: the current one's, or
        what the map kept when the tracker left it (the current one's where
        the map kept none)."""
        if map_id != self.current_map_id and map_id in self.map_imu:
            return dict(self.map_imu[map_id])
        return {k: getattr(self, k) for k in IMU_STATE}

    def relabel_map(self, src: int, dst: int):
        """Merge bookkeeping: every KF of map `src` joins map `dst`. Where
        `src` was the current map, the merged map goes on with the IMU
        schedule of the map that is further behind in it, where both are
        initialized (its stage and flags: the VIBAs that either map has not
        run then run over both),
        and is marked merged (no scale refinement: one scale for both
        sessions would rescale the one whose scale is converged). Times
        taken from `dst` are carried onto the clock of `src`, so that its
        schedule goes on from where `dst` left it: a session's stamps say
        nothing of another's."""
        n = self.n_kf
        valid = self.kf_valid[:n]
        sel = self.kf_map_id[:n] == src
        kept = self.map_imu.pop(dst, None) if self.current_map_id == src else None
        self.map_imu.pop(src, None)
        if kept is not None and kept["imu_initialized"] and kept["viba_stage"] < self.viba_stage:
            in_dst = valid & (self.kf_map_id[:n] == dst)
            t_src, t_dst = self.kf_time[:n][sel & valid], self.kf_time[:n][in_dst]
            shift = float(t_src.max() - t_dst.max()) if len(t_src) and len(t_dst) else 0.0
            for k in IMU_STATE:
                setattr(self, k, kept[k])
            if self.imu_init_time is not None:
                self.imu_init_time += shift
            if self.last_refine > -1e8:
                self.last_refine += shift
        self.kf_map_id[:n][sel] = dst
        if self.current_map_id == src:
            self.current_map_id = dst
            self.merged = True

    # ------------------------------------------------------------- keyframes
    def _ensure_kf_cap(self):
        if self.n_kf < len(self.kf_R):
            return
        cap = len(self.kf_R) * 2
        for name in ("kf_R", "kf_t", "kf_time", "kf_valid", "kf_frame_id",
                     "kf_mp", "kf_vel", "kf_bg", "kf_ba", "kf_bg0", "kf_ba0",
                     "kf_prev", "kf_parent", "kf_map_id"):
            setattr(self, name, _grow(getattr(self, name), cap))
        self.kf_feats.extend([None] * (cap - len(self.kf_feats)))
        self.kf_preint.extend([None] * (cap - len(self.kf_preint)))
        self.kf_imu.extend([None] * (cap - len(self.kf_imu)))
        self.kf_tcp.extend([None] * (cap - len(self.kf_tcp)))
        self.kf_octave_tab = _grow(self.kf_octave_tab, cap)
        self.kf_mp[self.n_kf:] = -1
        self.kf_prev[self.n_kf:] = -1
        self.kf_parent[self.n_kf:] = -1

    def add_keyframe(self, R, t, feats: FrameFeatures, time: float,
                     frame_id: int = -1, mp_assign=None) -> int:
        """mp_assign [N] int32: map point id per feature slot (-1 = none)."""
        self._ensure_kf_cap()
        k = self.n_kf
        self.n_kf += 1
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_time[k] = time
        self.kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_feats[k] = feats
        self.kf_map_id[k] = self.current_map_id
        self.kf_octave_tab[k, : len(feats.octave)] = feats.octave
        self.covis.append({})
        if mp_assign is not None:
            for slot in np.nonzero(mp_assign >= 0)[0]:
                self.add_observation(int(mp_assign[slot]), k, int(slot))
        return k

    # ------------------------------------------------------------ map points
    def _ensure_mp_cap(self):
        if self.n_mp < len(self.mp_pos):
            return
        cap = len(self.mp_pos) * 2
        for name in ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist",
                     "mp_bits", "mp_valid", "mp_first_kf", "mp_visible",
                     "mp_found", "mp_replaced_by"):
            setattr(self, name, _grow(getattr(self, name), cap))
        self.mp_replaced_by[self.n_mp:] = -1
        self.mp_first_kf[self.n_mp:] = -1

    def add_point(self, pos, ref_kf: int, slot: int) -> int:
        self._ensure_mp_cap()
        j = self.n_mp
        self.n_mp += 1
        self.mp_pos[j] = pos
        self.mp_valid[j] = True
        self.mp_first_kf[j] = ref_kf
        self.mp_obs.append({})
        self.mp_visible[j] = 1
        self.mp_found[j] = 1
        self.add_observation(j, ref_kf, slot)
        self.update_point_stats(j)
        return j

    def add_observation(self, mp: int, kf: int, slot: int):
        if not self.mp_valid[mp]:
            return
        prev = self.kf_mp[kf, slot]
        if prev == mp:
            return
        if prev >= 0:
            self.erase_observation(int(prev), kf)
        old_slot = self.mp_obs[mp].get(kf)
        if old_slot is not None:
            self.kf_mp[kf, old_slot] = -1
        self.mp_obs[mp][kf] = slot
        self.kf_mp[kf, slot] = mp
        if self._native is not None:
            self._native.add(mp, kf, slot)

    def erase_observation(self, mp: int, kf: int):
        slot = self.mp_obs[mp].pop(kf, None)
        if slot is not None and self.kf_mp[kf, slot] == mp:
            self.kf_mp[kf, slot] = -1
        if slot is not None and self._native is not None:
            self._native.erase(mp, kf)
        if len(self.mp_obs[mp]) <= 1 and self.mp_valid[mp]:
            # ref: MapPoint::EraseObservation -> SetBadFlag when obs<=2 for
            # stereo / <=1 mono-ish; use <=1
            self.set_bad_point(mp)

    def set_bad_point(self, mp: int):
        self.mp_valid[mp] = False
        for kf, slot in list(self.mp_obs[mp].items()):
            if self.kf_mp[kf, slot] == mp:
                self.kf_mp[kf, slot] = -1
        self.mp_obs[mp] = {}
        if self._native is not None:
            self._native.clear_mp(mp)

    def replace_point(self, old: int, new: int):
        """ref: MapPoint::Replace — all observations move to `new`."""
        if old == new:
            return
        for kf, slot in list(self.mp_obs[old].items()):
            if kf in self.mp_obs[new]:
                # target already observed in this KF: drop the old obs
                if self.kf_mp[kf, slot] == old:
                    self.kf_mp[kf, slot] = -1
            else:
                self.mp_obs[new][kf] = slot
                self.kf_mp[kf, slot] = new
                if self._native is not None:
                    self._native.add(new, kf, slot)
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_obs[old] = {}
        self.mp_valid[old] = False
        self.mp_replaced_by[old] = new
        if self._native is not None:
            self._native.clear_mp(old)
        self.update_point_stats(new)

    def update_point_stats(self, mp: int):
        """Distinctive descriptor (min median Hamming) + normal & scale range
        (ref: MapPoint::ComputeDistinctiveDescriptors, UpdateNormalAndDepth)."""
        obs = self.mp_obs[mp]
        if not obs:
            return
        descs = np.stack([self.kf_feats[kf].bits[slot] for kf, slot in obs.items()])
        if len(descs) == 1:
            self.mp_bits[mp] = descs[0]
        else:
            d = (descs[:, None, :] != descs[None, :, :]).sum(-1)
            med = np.median(d, axis=1)
            self.mp_bits[mp] = descs[int(np.argmin(med))]
        # normal: mean of directions from KF centers; scale range from ref KF
        pos = self.mp_pos[mp]
        normals = []
        for kf in obs:
            Ow = -self.kf_R[kf].T @ self.kf_t[kf]
            v = pos - Ow
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if normals:
            nm = np.mean(normals, axis=0)
            nn = np.linalg.norm(nm)
            self.mp_normal[mp] = nm / nn if nn > 1e-9 else nm
        ref_kf = self.mp_first_kf[mp]
        if ref_kf not in obs:
            ref_kf = next(iter(obs))
        slot = obs[ref_kf]
        Ow = -self.kf_R[ref_kf].T @ self.kf_t[ref_kf]
        dist = np.linalg.norm(pos - Ow)
        level = self.kf_feats[ref_kf].octave[slot]
        sf = self.scale_factors[level]
        self.mp_max_dist[mp] = dist * sf
        self.mp_min_dist[mp] = self.mp_max_dist[mp] / self.scale_factors[-1]

    def update_point_stats_batch(self, mp_ids):
        """Vectorized update_point_stats over many points (the per-KF
        ProcessNewKeyFrame / fuse stat refresh touches hundreds of points;
        per-point numpy calls cost ~0.5 ms each on a small host — batched,
        the whole set is a handful of array ops)."""
        mp_ids = [int(j) for j in mp_ids
                  if j >= 0 and self.mp_valid[j] and self.mp_obs[j]]
        if not mp_ids:
            return
        kmax = max(len(self.mp_obs[j]) for j in mp_ids)
        P = len(mp_ids)
        descs = np.zeros((P, kmax, 256), np.uint8)
        centers = np.zeros((P, kmax, 3))
        nobs = np.zeros(P, np.int32)
        ref_dist = np.zeros(P)
        ref_level = np.zeros(P, np.int32)
        for i, j in enumerate(mp_ids):
            obs = self.mp_obs[j]
            nobs[i] = len(obs)
            for o, (kf, slot) in enumerate(obs.items()):
                descs[i, o] = self.kf_feats[kf].bits[slot]
                centers[i, o] = -self.kf_R[kf].T @ self.kf_t[kf]
            ref_kf = self.mp_first_kf[j]
            if ref_kf not in obs:
                ref_kf = next(iter(obs))
            slot = obs[ref_kf]
            Ow = -self.kf_R[ref_kf].T @ self.kf_t[ref_kf]
            ref_dist[i] = np.linalg.norm(self.mp_pos[j] - Ow)
            ref_level[i] = self.kf_feats[ref_kf].octave[slot]
        # distinctive descriptor: min median pairwise Hamming, masked
        d = (descs[:, :, None, :] != descs[:, None, :, :]).sum(-1)
        col = np.arange(kmax)
        valid = col[None, :] < nobs[:, None]
        pair_ok = valid[:, :, None] & valid[:, None, :]
        d = np.where(pair_ok, d, 0)
        # median over the valid columns only: sort with invalid -> +inf
        dm = np.where(pair_ok, d, np.inf)
        dm.sort(axis=2)
        med_idx = np.maximum(nobs - 1, 0) // 2
        med = np.take_along_axis(
            dm, med_idx[:, None, None].repeat(kmax, 1), 2)[:, :, 0]
        med = np.where(valid, med, np.inf)
        best = np.argmin(med, axis=1)
        ids_arr = np.asarray(mp_ids)
        self.mp_bits[ids_arr] = descs[np.arange(P), best]
        # viewing normal: mean of unit directions
        v = self.mp_pos[ids_arr][:, None, :] - centers
        n = np.linalg.norm(v, axis=2, keepdims=True)
        u = np.where((n > 1e-9) & valid[:, :, None], v / np.maximum(n, 1e-9),
                     0.0)
        nm = u.sum(1) / np.maximum(nobs[:, None], 1)
        nn = np.linalg.norm(nm, axis=1, keepdims=True)
        self.mp_normal[ids_arr] = np.where(nn > 1e-9, nm / np.maximum(nn, 1e-9),
                                           nm)
        sf = self.scale_factors[ref_level]
        self.mp_max_dist[ids_arr] = ref_dist * sf
        self.mp_min_dist[ids_arr] = (ref_dist * sf) / self.scale_factors[-1]

    def predict_scale(self, dists, mp_ids):
        """Predicted pyramid level from viewing distance
        (ref: MapPoint::PredictScale)."""
        ratio = self.mp_max_dist[mp_ids] / np.maximum(dists, 1e-9)
        lvl = np.ceil(np.log(np.maximum(ratio, 1e-9)) / np.log(self.scale_factors[1]))
        return np.clip(lvl, 0, self.n_levels - 1).astype(np.int32)

    # ---------------------------------------------------------- covisibility
    def update_connections(self, kf: int, th: int = 15):
        """Recount shared map points with other KFs; weight >= th creates an
        edge (always keep the single best). Sets spanning-tree parent on
        first connection (ref: KeyFrame::UpdateConnections, :388).
        The counting loop runs in the native core when available."""
        if self._native is not None:
            ks, ws = self._native.covis_counts(kf, self.kf_mp[kf, : self.n_feat])
            counts = {int(k): int(w) for k, w in zip(ks, ws)}
        else:
            counts = {}
            for mp in self.kf_mp[kf, : self.n_feat]:
                if mp < 0:
                    continue
                for okf in self.mp_obs[mp]:
                    if okf != kf:
                        counts[okf] = counts.get(okf, 0) + 1
        if not counts:
            self.covis[kf] = {}
            return
        best_kf = max(counts, key=lambda o: (counts[o], -o))  # deterministic
        edges = {o: w for o, w in counts.items() if w >= th}
        if not edges:
            edges = {best_kf: counts[best_kf]}
        # symmetric update
        old = self.covis[kf]
        for o in set(old) - set(edges):
            self.covis[o].pop(kf, None)
        for o, w in edges.items():
            self.covis[o][kf] = w
        self.covis[kf] = edges
        if self.kf_parent[kf] < 0 and kf != 0:
            self.kf_parent[kf] = best_kf

    def redundancy(self, kf: int, min_obs: int = 3) -> int:
        """#points of kf seen by >= min_obs other KFs at the same-or-finer
        scale (ref KeyFrameCulling redundancy rule). Native when available."""
        row = self.kf_mp[kf, : self.n_feat]
        if self._native is not None:
            return self._native.redundancy(
                kf, row, self.kf_octave_tab, min_obs)
        n_red = 0
        for slot in np.nonzero(row >= 0)[0]:
            mp = int(row[slot])
            lvl = self.kf_feats[kf].octave[slot]
            c = 0
            for okf, oslot in self.mp_obs[mp].items():
                if okf == kf:
                    continue
                if self.kf_feats[okf].octave[oslot] <= lvl + 1:
                    c += 1
                    if c >= min_obs:
                        break
            if c >= min_obs:
                n_red += 1
        return n_red

    def rebuild_native(self):
        """Re-mirror the inverse index (after checkpoint load)."""
        if self._native is None:
            return
        self._native = NativeObsIndex()
        for mp, obs in enumerate(self.mp_obs):
            for kf, slot in obs.items():
                self._native.add(mp, int(kf), int(slot))

    def best_covisible(self, kf: int, k: int | None = None):
        nb = sorted(self.covis[kf].items(), key=lambda kv: -kv[1])
        nb = [o for o, w in nb if self.kf_valid[o]]
        return nb if k is None else nb[:k]

    def covisible_by_weight(self, kf: int, w_min: int):
        return [o for o, w in self.covis[kf].items() if w >= w_min and self.kf_valid[o]]

    # -------------------------------------------------------------- queries
    def kf_center(self, kf: int):
        return -self.kf_R[kf].T @ self.kf_t[kf]

    def valid_kf_ids(self, map_id=None, all_maps: bool = False):
        """Valid KFs of one map (default: the current/active map)."""
        ok = self.kf_valid[: self.n_kf]
        if not all_maps:
            mid = self.current_map_id if map_id is None else map_id
            ok = ok & (self.kf_map_id[: self.n_kf] == mid)
        return np.nonzero(ok)[0]

    def valid_mp_ids(self):
        return np.nonzero(self.mp_valid[: self.n_mp])[0]

    def points_in_kfs(self, kf_ids):
        ids = np.unique(self.kf_mp[kf_ids])
        return ids[ids >= 0][self.mp_valid[ids[ids >= 0]]]

    def resolve_replaced(self, mp: int) -> int:
        while mp >= 0 and not self.mp_valid[mp] and self.mp_replaced_by[mp] >= 0:
            mp = int(self.mp_replaced_by[mp])
        return mp

    def check_essential_graph(self, map_id=None):
        """Spanning-tree invariant check (ref: Map::CheckEssentialGraph,
        asserted after loop correction at LoopClosing.cc:1048-1050):
        every valid KF of the map either is a root (parent == -1) or has a
        valid, same-map, non-self parent, and following parents terminates
        at a root (no cycles). Returns a list of violation strings
        (empty = healthy); callers assert on emptiness in debug paths.
        """
        errs = []
        ids = self.valid_kf_ids(map_id=map_id)
        idset = set(int(k) for k in ids)
        roots = 0
        for k in ids:
            p = int(self.kf_parent[k])
            if p < 0:
                roots += 1
                continue
            if p == int(k):
                errs.append(f"kf {k}: parent is self")
                continue
            if not self.kf_valid[p]:
                errs.append(f"kf {k}: parent {p} is bad")
            elif int(p) not in idset:
                errs.append(f"kf {k}: parent {p} in another map")
            # cycle walk (paths are short; bail at n_kf hops)
            seen = {int(k)}
            while p >= 0:
                if p in seen:
                    errs.append(f"kf {k}: parent cycle through {p}")
                    break
                seen.add(p)
                p = int(self.kf_parent[p])
        if len(ids) and roots == 0:
            errs.append("no spanning-tree root in map")
        return errs

    # ----------------------------------------------------------------- inertial
    def temporal_chain(self, map_id=None):
        """Valid KFs of one map in temporal order."""
        ids = [k for k in self.valid_kf_ids(map_id=map_id)]
        return sorted(ids, key=lambda k: self.kf_time[k])

    def apply_scaled_rotation(self, Rwg, s: float, velocities=None):
        """Gravity-align and rescale the whole map after IMU init
        (ref: Map::ApplyScaledRotation Map.cc:289).

        New world frame: X' = s * Rwg^T X  (gravity becomes (0,0,-G)).
        Camera poses: Rcw' = Rcw Rwg, tcw' = s * tcw. Velocities are
        *metric* already (from the init solver): v' = Rwg^T v.
        """
        Rwg = np.asarray(Rwg)
        Rgw = Rwg.T
        n = self.n_kf
        in_map = self.kf_map_id[:n] == self.current_map_id
        self.kf_R[:n][in_map] = self.kf_R[:n][in_map] @ Rwg
        self.kf_t[:n][in_map] = s * self.kf_t[:n][in_map]
        if velocities is not None:
            self.kf_vel[:n][in_map] = velocities[in_map] @ Rgw.T
        else:
            self.kf_vel[:n][in_map] = s * self.kf_vel[:n][in_map] @ Rgw.T
        valid = self.mp_valid[: self.n_mp].copy()
        anchor = self.mp_first_kf[: self.n_mp]
        valid &= (anchor >= 0) & (self.kf_map_id[np.maximum(anchor, 0)]
                                  == self.current_map_id)
        self.mp_pos[: self.n_mp][valid] = s * self.mp_pos[: self.n_mp][valid] @ Rgw.T
        self.mp_normal[: self.n_mp][valid] = self.mp_normal[: self.n_mp][valid] @ Rgw.T
        self.mp_min_dist[: self.n_mp][valid] *= s
        self.mp_max_dist[: self.n_mp][valid] *= s
        self.map_version += 1


# a map's IMU state (the flags and the inertial mapper's schedule on it) and
# its value on a new map
IMU_STATE_NEW = dict(imu_initialized=False, inertial_ba1=False, inertial_ba2=False,
                     imu_init_time=None, viba_stage=0, last_refine=-1e9, merged=False)
IMU_STATE = tuple(IMU_STATE_NEW)
# the state a SlamMap carries: struct-of-arrays fields, Python-side graph
# structures and scalar bookkeeping
ARRAY_FIELDS = (
    "kf_R", "kf_t", "kf_time", "kf_valid", "kf_frame_id", "kf_mp", "kf_vel", "kf_bg",
    "kf_ba", "kf_bg0", "kf_ba0", "kf_prev", "kf_parent", "kf_map_id", "kf_octave_tab",
    "mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist", "mp_bits", "mp_valid",
    "mp_first_kf", "mp_visible", "mp_found", "mp_replaced_by", "scale_factors")
GRAPH_FIELDS = ("mp_obs", "covis", "kf_tcp")
# per keyframe: the preintegration dict from the previous KF and the raw
# (w, a, dt) window it integrated, or None
INERTIAL_FIELDS = ("kf_preint", "kf_imu")
SCALAR_FIELDS = ("n_kf", "n_mp", "map_id", "n_levels", "imu_initialized", "inertial_ba1",
                 "inertial_ba2", "bad_imu", "map_version", "current_map_id",
                 "n_maps_created")
FEATURE_FIELDS = ("xy", "und_xy", "norm_xy", "octave", "angle", "response", "bits",
                  "packed", "valid", "depth", "u_right")


def map_state(m) -> tuple[dict, list]:
    """(arrays, kf_feats) of a SlamMap, tpuslam's or the port's: copies of
    every field named above, and per keyframe a dict of its feature fields
    (None where the slot is empty). The input of `map_from_numpy`."""
    import copy

    arrays = {k: np.array(getattr(m, k)) for k in ARRAY_FIELDS}
    arrays.update({k: copy.deepcopy(getattr(m, k))
                   for k in GRAPH_FIELDS + SCALAR_FIELDS + INERTIAL_FIELDS})
    for k in INERTIAL_FIELDS:
        arrays[k] = [None if x is None else
                     ({n: np.array(v) for n, v in x.items()} if isinstance(x, dict)
                      else tuple(np.array(v) for v in x)) for x in arrays[k]]
    feats = [None if f is None else {k: (None if getattr(f, k) is None
                                         else np.array(getattr(f, k)))
                                     for k in FEATURE_FIELDS}
             for f in m.kf_feats]
    return arrays, feats


def map_from_numpy(arrays: dict, kf_feats: list) -> SlamMap:
    """The port's SlamMap holding the state carried over from a tpuslam
    SlamMap: `arrays` maps every field of ARRAY_FIELDS, GRAPH_FIELDS and
    SCALAR_FIELDS to its value (numpy arrays; lists of dicts for mp_obs
    and covis; a list of (Rcp, tcp) or None for kf_tcp), `kf_feats` gives
    one dict of FrameFeatures fields (or None) per keyframe slot; the
    INERTIAL_FIELDS are carried where `arrays` has them. The native
    observation index is rebuilt from mp_obs."""
    sf = np.asarray(arrays["scale_factors"])
    m = SlamMap(int(arrays["kf_mp"].shape[1]), scale=float(sf[1]), n_levels=len(sf),
                map_id=int(arrays["map_id"]))
    for k in ARRAY_FIELDS:
        setattr(m, k, np.array(arrays[k]))
    for k in GRAPH_FIELDS:
        setattr(m, k, [dict(d) if isinstance(d, dict) else d for d in arrays[k]])
    for k in SCALAR_FIELDS:
        setattr(m, k, arrays[k])
    cap = len(m.kf_R)
    m.kf_feats = [None if f is None else FrameFeatures(**f) for f in kf_feats]
    m.kf_feats += [None] * (cap - len(m.kf_feats))
    for k in INERTIAL_FIELDS:
        vals = list(arrays.get(k, []))
        setattr(m, k, vals + [None] * (cap - len(vals)))
    m.rebuild_native()
    return m
