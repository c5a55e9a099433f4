"""Fused tracking step: the whole per-frame hot path as one module
(port of tpuslam/engine/track_device.py::make_fused_step).

    extract(L,R) -> stereo depth -> reference-KF descriptor match
    -> pose LM -> [project local map -> masked window match -> pose LM] x3

Semantics mirror the JAX step (ref: Tracking::TrackReferenceKeyFrame
src/Tracking.cc:1750, Tracking::TrackLocalMap :1974 with the
SearchLocalPoints frustum gates and SearchByProjection same-octave ratio
gating, ORBmatcher.cc:130). `forward` never waits on the device: no
`.item()`, no host copies, no data-dependent Python branches; the widen
threshold, the inlier count and the pose stay device tensors, so a caller
can chain `pose_in` from the previous step's output.

The kernels on this path are the patch gather (ops/patch_cuda.py, one
launch per image: 2 per stereo frame, 1 per mono frame) and the pose LM
(solve/pose_opt_cuda.py, 4 launches per frame).

`FusedTracker` is the host orchestrator around the step (the local-map
cache, dispatch, fetch, completion into a tracker Frame); `DeviceFeatures`
holds a frame's features on the device until the host needs them. The
device-to-host results stream through non-blocking copies into pinned
buffers, completed by an event (`HostCopy`), in place of tpuslam's
`copy_to_host_async` and `jax.device_get`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..engine.config import OrbConfig, TrackingConfig
from ..ops import match as M
from ..ops.hamming import hamming_matrix
from ..ops.orb import OrbExtractor
from ..ops.stereo import sad_refine, sad_refine_pyramid, stereo_match
from ..solve.pose_opt_cuda import pose_optimize_fused
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.pad import bucket, pad_to


def _scatter_drop(n: int, index, src, fill):
    """out[index[i]] = src[i] for index < n, dropping index == n
    (jnp `.at[].set(mode="drop")`): scatter into n + 1 slots, slice."""
    out = torch.full((n + 1,), fill, dtype=src.dtype, device=src.device)
    return out.scatter(0, index.long(), src)[:n]


class FusedTrackStep(nn.Module):
    """One fused tracking step for one camera and config.

    forward(imgs [2,H,W] (or [1,H,W] mono) u8 or f32,
            mapGeo [P,8] (X | normal | min_dist | max_dist),
            mapBits [P,256] u8, mapValid [P] bool,
            refBits [N,256] u8, refMeta [N,2] (angle, map row or -1),
            pose_in [13] (R row-major | t | ignored), min_req2 [1])
    -> dict(pose [13] = R | t | n_inliers, assoc [N] i32 map row per
            feature or -1, rowflags [2P] = visible | found, feats {...})
    """

    def __init__(self, camera, orb_cfg: OrbConfig, tcfg: TrackingConfig,
                 n_levels: int, scale: float, bf: float, stereo: bool,
                 n_passes: int = 3, device=DEFAULT_DEVICE):
        super().__init__()
        if tcfg.fused_sad not in ("pyramid", "level0"):
            raise ValueError(f"fused_sad must be 'pyramid' or 'level0', not {tcfg.fused_sad!r}")
        self.camera = camera
        self.tcfg = tcfg
        self.n_levels = n_levels
        self.scale = scale
        self.log_sf = float(np.log(scale))
        self.bf = float(bf)
        self.stereo = stereo
        self.n_passes = n_passes
        device = resolve_device(device)
        self.extractor = OrbExtractor(orb_cfg, device)
        sf = torch.tensor((scale ** np.arange(n_levels)).astype(np.float32), device=device)
        self.register_buffer("sf", sf)
        self.register_buffer("inv_s2", 1.0 / sf ** 2)

    def _pose_opt(self, R, t, Xrows, uvr, is2, stereo_rows, valid_rows, n_rounds):
        c = self.camera
        return pose_optimize_fused(R, t, Xrows, uvr, is2, stereo_rows, valid_rows,
                                   c.fx, c.fy, c.cx, c.cy, self.bf, n_rounds=n_rounds)

    def extract(self, imgs):
        imgs = imgs.float()
        if not self.stereo:
            f = self.extractor(imgs[0])
            f["u_right"] = torch.full_like(f["resp"], -1.0)
            f["depth"] = torch.full_like(f["resp"], -1.0)
            return f
        fl = self.extractor(imgs[0])
        fr = self.extractor(imgs[1])
        u_r, disp, ok = stereo_match(
            fl["bits"], fr["bits"], fl["xy"], fr["xy"], fl["octave"], fr["octave"],
            fl["valid"], fr["valid"], self.sf, 0.3, self.camera.fx)
        if self.tcfg.fused_sad == "pyramid":
            u_r, sadv, ok = sad_refine_pyramid(
                imgs[0], imgs[1], fl["xy"], fl["octave"], u_r, ok,
                n_levels=self.n_levels, scale=self.scale)
        else:  # level-0 SAD: one gather shape for every octave
            u_r, sadv, ok = sad_refine(imgs[0], imgs[1], fl["xy"], u_r, ok)
        # median-SAD outlier filter (ref Frame.cc:931-975): masked median
        # over the ok set, th = 1.5 * 1.4 * median
        big = torch.where(ok, sadv, float("inf"))
        n_ok = torch.clamp(ok.sum(), min=1)
        mid = torch.clamp(n_ok // 2, 0, sadv.shape[0] - 1)
        med = torch.sort(big).values.gather(0, mid.reshape(1))
        ok = ok & (sadv < 1.5 * 1.4 * med)
        disp = fl["xy"][:, 0] - u_r
        ok = ok & (disp > 1e-3)
        fl["u_right"] = torch.where(ok, u_r, -1.0)
        fl["depth"] = torch.where(ok, self.bf / torch.clamp(disp, min=1e-9), -1.0)
        return fl

    def forward(self, imgs, mapGeo, mapBits, mapValid, refBits, refMeta, pose_in,
                min_req2v):
        tc = self.tcfg
        cam = self.camera
        fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
        W, H = float(cam.width), float(cam.height)
        R0 = pose_in[:9].reshape(3, 3).float()
        t0 = pose_in[9:12].float()
        min_req2 = min_req2v[0].to(torch.int32)
        mapX = mapGeo[:, 0:3]
        mapNormal = mapGeo[:, 3:6]
        mapMind = mapGeo[:, 6]
        mapMaxd = mapGeo[:, 7]
        refAng = refMeta[:, 0]
        refRow = refMeta[:, 1].to(torch.int32)
        feats = self.extract(imgs)
        xy = feats["xy"]
        und = cam.undistort_points(xy) if cam.has_distortion() else xy
        feats["und_xy"] = und
        feats["norm_xy"] = torch.stack([(und[:, 0] - cx) / fx, (und[:, 1] - cy) / fy], -1)
        fvalid = feats["valid"]
        N = xy.shape[0]
        P = mapX.shape[0]
        uvr_feat = torch.cat([und, torch.clamp(feats["u_right"], min=0.0)[:, None]], -1)
        st_feat = feats["u_right"] >= 0
        oct_b = feats["octave"]
        is2_feat = self.inv_s2[oct_b.long()]

        # ---- pass A: reference-KF descriptor match (window-free)
        dist_ref = hamming_matrix(refBits, feats["bits"])
        mask_ref = (refRow >= 0)[:, None] & fvalid[None, :]
        idx, best, second = M.masked_best2(dist_ref, mask_ref)
        ok = (best <= M.TH_LOW) & (best.float() < tc.nn_ratio_ref_kf * second.float())
        ok = M.rotation_consistency(refAng, feats["angle"][idx.long()], ok)
        idx, ok = M.resolve_duplicates(idx, best, ok, N)
        assocA = _scatter_drop(N, torch.where(ok, idx, N), refRow, -1)
        avalidA = assocA >= 0
        XA = mapX[torch.clamp(assocA, 0, P - 1).long()].contiguous()
        R1, t1, _, _ = self._pose_opt(R0, t0, XA, uvr_feat, is2_feat,
                                      st_feat & avalidA, avalidA, n_rounds=2)

        # ---- local-map passes: the Hamming matrix is pose-independent
        dist_map = hamming_matrix(mapBits, feats["bits"])
        rows = torch.arange(P, dtype=torch.int32, device=mapGeo.device)

        def local_pass(R, t, radius_mult, n_rounds=4):
            Xc = mapX @ R.T + t
            z = Xc[:, 2]
            uv = cam.project(Xc)
            Ow = -R.T @ t
            vdir = mapX - Ow[None]
            d = torch.linalg.norm(vdir, dim=1)
            cosv = (vdir * mapNormal).sum(1) / torch.clamp(d, min=1e-9)
            in_img = (
                (z > 0)
                & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                & (uv[:, 1] >= 0) & (uv[:, 1] < H)
                & (d >= 0.8 * mapMind) & (d <= 1.2 * mapMaxd)
                & (cosv > 0.5) & mapValid
            )  # ref Frame::isInFrustum (:483)
            ratio = mapMaxd / torch.clamp(d, min=1e-9)
            pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / self.log_sf)
            pred = torch.clamp(pred, 0, self.n_levels - 1).to(torch.int32)
            radius = torch.where(cosv > 0.998, tc.local_map_radius_tight,
                                 tc.local_map_radius) * self.sf[pred.long()] * radius_mult
            mask = (M.window_mask(uv, xy, radius) & in_img[:, None] & fvalid[None, :]
                    & M.level_mask(pred, oct_b, 1, 0))
            idx, best, idx2, second = M.masked_best2_idx(dist_map, mask)
            same_oct = oct_b[idx.long()] == oct_b[idx2.long()]
            ok = (best <= M.TH_HIGH) & (
                (~same_oct) | (best.float() < tc.nn_ratio_local * second.float()))
            idx, ok = M.resolve_duplicates(idx, best, ok, N)
            assoc = _scatter_drop(N, torch.where(ok, idx, N), rows, -1)
            avalid = assoc >= 0
            Xr = mapX[torch.clamp(assoc, 0, P - 1).long()].contiguous()
            R2, t2, inl_f, _ = self._pose_opt(R, t, Xr, uvr_feat, is2_feat,
                                              st_feat & avalid, avalid, n_rounds)
            return R2, t2, assoc, inl_f & avalid, in_img

        one = torch.ones((), dtype=torch.float32, device=mapGeo.device)
        np_ = self.n_passes
        R2, t2, assoc, inl_f, in_img = local_pass(R1, t1, one, 2 if np_ > 1 else 4)
        if np_ > 1:
            # conditional widen (ref widens SearchByProjection th when weak)
            widen = (inl_f.sum() < min_req2).float() * 2.0 + 1.0
            R2, t2, assoc, inl_f, in_img = local_pass(R2, t2, widen, 2 if np_ > 2 else 4)
        if np_ > 2:
            R2, t2, assoc, inl_f, in_img = local_pass(R2, t2, one)

        # per-row "found": row matched by some feature that is an inlier
        found = _scatter_drop(P, torch.where(assoc >= 0, assoc, P), inl_f, False)
        return dict(
            pose=torch.cat([R2.reshape(-1), t2, inl_f.sum().float()[None]]),
            assoc=torch.where(inl_f, assoc, -1),
            rowflags=torch.cat([in_img, found]),
            feats=feats,
        )


def step_inputs_from_numpy(imgs, mapGeo, mapBits, mapValid, refBits, refMeta,
                           pose_in, min_req2, device):
    """The JAX step's eight inputs (numpy or anything np.asarray takes, as
    `__graft_entry__.entry()` builds them) -> the port's tensors on
    `device`: the state carried from frame to frame."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    im = np.asarray(imgs)
    return (
        t(im, torch.uint8 if im.dtype == np.uint8 else torch.float32),
        t(mapGeo, torch.float32),
        t(mapBits, torch.uint8),
        t(mapValid, torch.bool),
        t(refBits, torch.uint8),
        t(refMeta, torch.float32),
        t(pose_in, torch.float32),
        t(min_req2, torch.float32),
    )


class HostCopy:
    """Device-to-host copies of a dict of tensors, started now: on CUDA,
    non-blocking copies into pinned buffers and an event recorded after
    them on the current stream; on the CPU, the tensors themselves.
    `wait()` blocks on the event and returns the numpy views."""

    def __init__(self, tensors: dict):
        self.event = None
        if any(t.is_cuda for t in tensors.values()):
            self.host = {}
            for k, t in tensors.items():
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self.host[k] = buf
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = dict(tensors)

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


FEATURE_KEYS = ("xy", "und_xy", "norm_xy", "octave", "angle", "resp", "packed", "valid",
                "u_right", "depth")


class DeviceFeatures:
    """Lazy feature holder for the fused path: the tensors stay on the
    device; a numpy FrameFeatures is materialized only when the host needs
    it (keyframe creation, host-path fallback), from the host copy that
    `FusedTracker.dispatch` started."""

    def __init__(self, dev: dict, host_copy: HostCopy):
        self.dev = dev
        self._copy = host_copy
        self._np = None
        self.n = int(dev["xy"].shape[0])

    def __getattr__(self, name):
        # transparent host fallback: any FrameFeatures field access
        # materializes the numpy view
        if name.startswith("_") or name in ("dev", "n"):
            raise AttributeError(name)
        return getattr(self.materialize(), name)

    def materialize(self):
        from ..map.store import FrameFeatures

        if self._np is None:
            h = self._copy.wait()
            ur = np.asarray(h["u_right"], np.float64)
            dep = np.asarray(h["depth"], np.float64)
            packed = np.asarray(h["packed"], np.uint32)
            # the {0,1}-byte descriptor view from the packed words
            # (little-endian per ops/orb.pack_bits)
            bits = ((packed[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
                    ).astype(np.uint8).reshape(packed.shape[0], 256)
            self._np = FrameFeatures(
                xy=np.asarray(h["xy"], np.float64),
                und_xy=np.asarray(h["und_xy"], np.float64),
                norm_xy=np.asarray(h["norm_xy"], np.float64),
                octave=np.asarray(h["octave"], np.int32),
                angle=np.asarray(h["angle"], np.float64),
                response=np.asarray(h["resp"], np.float64),
                bits=bits,
                packed=packed,
                valid=np.asarray(h["valid"], bool),
                depth=dep if (dep > 0).any() else None,
                u_right=ur if (ur >= 0).any() else None,
            )
        return self._np


def _to_u8(im):
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    return np.clip(np.round(im), 0, 255).astype(np.uint8)


class FusedTracker:
    """Host orchestrator of the fused step (port of tpuslam's
    FusedTracker): owns the device-resident local map, rebuilt from the
    last frame's covisibility vote and cached between map mutations, and
    the reference-KF block."""

    P_BASE = 2048

    # steps shared across System instances, keyed by the full static
    # configuration (the extractor's buffers are built once per key)
    _CACHE: dict = {}

    def __init__(self, tracker):
        self.tr = tracker
        self.map = tracker.map
        self.device = torch.device(tracker.device)
        self._stereo = tracker.sensor != "mono"
        self.ids = np.zeros(0, np.int64)
        self._cache_key = None
        self._min_req_dev = None
        self._min_req_val = None

    def _step_for(self, Pb: int, stereo: bool):
        cam = self.tr.camera
        cfg = self.tr.cfg
        tc = cfg.tracking
        key = (
            Pb, stereo, str(self.device), type(cam).__name__, tuple(map(float, cam.params)),
            tuple(map(float, getattr(cam, "dist", []))), cam.width, cam.height,
            float(self.tr.bf), dataclasses.astuple(cfg.orb), tc.fused_passes, tc.fused_sad,
            tc.nn_ratio_ref_kf, tc.nn_ratio_local, tc.local_map_radius,
            tc.local_map_radius_tight,
        )
        if key not in FusedTracker._CACHE:
            FusedTracker._CACHE[key] = FusedTrackStep(
                cam, cfg.orb, tc, cfg.orb.n_levels, cfg.orb.scale, self.tr.bf, stereo,
                n_passes=tc.fused_passes, device=self.device)
        return FusedTracker._CACHE[key]

    def build_local_map(self, frame_mp: np.ndarray):
        """K1/K2 covisibility vote from the LAST frame's matches (host; ref
        Tracking::UpdateLocalKeyFrames :2472). Returns False if there is no
        usable local map (the caller falls back to the host path).

        The device tensors are cached across frames: between map mutations
        (tracked by the (ref KF, n_kf, n_mp, map_version) key) the local
        map is the same, so the upload is skipped."""
        from ..utils.timing import GLOBAL_TIMER as T

        m = self.map
        counts: dict[int, int] = {}
        for j in frame_mp[frame_mp >= 0]:
            j = m.resolve_replaced(int(j))
            if j < 0:
                continue
            for kf in m.mp_obs[j]:
                counts[kf] = counts.get(kf, 0) + 1
        if not counts:
            return False
        k1 = sorted(counts, key=counts.get, reverse=True)
        self.tr.ref_kf = k1[0]
        key = (k1[0], m.n_kf, m.n_mp, m.map_version)
        if key == self._cache_key:
            return True
        with T.stage("fused.rebuild"):
            return self._rebuild(k1, key)

    def _rebuild(self, k1, key):
        m = self.map
        local_kfs = list(k1)
        seen = set(local_kfs)
        for kf in k1[:10]:
            for o in m.best_covisible(kf, 10):
                if o not in seen and len(local_kfs) < 80:
                    seen.add(o)
                    local_kfs.append(o)
        ids = np.unique(m.kf_mp[local_kfs])
        ids = ids[ids >= 0]
        ids = ids[m.mp_valid[ids]]
        if len(ids) < 30:
            return False
        self.ids = ids
        P = len(ids)
        Pb = bucket(P, self.P_BASE)
        f32 = np.float32
        dev = self.device
        geo = np.concatenate([
            m.mp_pos[ids], m.mp_normal[ids],
            m.mp_min_dist[ids, None], m.mp_max_dist[ids, None]], 1)
        self.mapGeo = torch.as_tensor(pad_to(geo.astype(f32), Pb), device=dev)
        self.mapBits = torch.as_tensor(pad_to(m.mp_bits[ids], Pb), device=dev)
        valid = np.zeros(Pb, bool)
        valid[:P] = True
        self.mapValid = torch.as_tensor(valid, device=dev)
        # reference-KF block: slot descriptors/angles + map row per slot
        kf = self.tr.ref_kf
        fk = m.kf_feats[kf]
        kf_mp = m.kf_mp[kf, : fk.n].copy()
        for i, j in enumerate(kf_mp):
            if j >= 0:
                kf_mp[i] = m.resolve_replaced(int(j))
        # global mp id -> local row
        row_of = np.full(int(ids.max()) + 2, -1, np.int32)
        row_of[ids] = np.arange(P, dtype=np.int32)
        ref_row = np.where(
            (kf_mp >= 0) & (kf_mp <= ids.max()), row_of[np.maximum(kf_mp, 0)], -1)
        self.refBits = torch.as_tensor(np.ascontiguousarray(fk.bits), device=dev)
        self.refMeta = torch.as_tensor(
            np.stack([fk.angle, ref_row.astype(np.float64)], 1).astype(f32), device=dev)
        self.Pb = Pb
        self._cache_key = key
        return True

    def _min_req2(self, min_req: int):
        v = 2 * min_req
        if self._min_req_dev is None or self._min_req_val != v:
            self._min_req_dev = torch.tensor([float(v)], device=self.device)
            self._min_req_val = v
        return self._min_req_dev

    def dispatch(self, img_l, img_r, pose_in, min_req: int):
        """Enqueue the fused step; returns the output dict with the host
        copies of its small outputs and of the features already started.
        pose_in: [13] f32, a previous step's device "pose" output (the
        pipelined chain) or a host array."""
        from ..utils.timing import GLOBAL_TIMER as T

        step = self._step_for(self.Pb, self._stereo)
        dev = self.device
        with T.stage("fused.upload"):
            # u8 is the native camera format and the smallest upload; the
            # extractor casts to f32 on the device
            imgs = _to_u8(img_l)[None] if img_r is None else np.stack(
                [_to_u8(img_l), _to_u8(img_r)])
            imgs = torch.from_numpy(imgs)
            if dev.type == "cuda":
                imgs = imgs.pin_memory().to(dev, non_blocking=True)
            if not torch.is_tensor(pose_in):
                pose_in = torch.as_tensor(np.asarray(pose_in, np.float32), device=dev)
        with T.stage("fused.dispatch"):
            out = step(imgs, self.mapGeo, self.mapBits, self.mapValid, self.refBits,
                       self.refMeta, pose_in, self._min_req2(min_req))
            out["ids"] = self.ids  # snapshot (rebuilds swap self.ids)
            # the fetch at completion overlaps the next frame's work
            out["results"] = HostCopy({k: out[k] for k in ("pose", "assoc", "rowflags")})
            # if this frame becomes a keyframe, materialize() finds its
            # features already on the host
            out["feats_host"] = HostCopy({k: out["feats"][k] for k in FEATURE_KEYS})
        return out

    def fetch_results(self, out):
        """Wait for the step's small outputs (callers run this OUTSIDE the
        map lock, so the mapping worker is not stalled behind it)."""
        from ..utils.timing import GLOBAL_TIMER as T

        with T.stage("fused.fetch"):
            h = out["results"].wait()
            return h["pose"], h["assoc"], h["rowflags"]

    def complete(self, out, frame, fetched=None):
        """Fill frame.{R,t,mp,feats} from the step's results and update the
        map counters (callers hold the map lock). Returns n_inliers."""
        m = self.map
        pose, assoc, rowflags = fetched if fetched is not None else self.fetch_results(out)
        ids = out["ids"]
        Pb = rowflags.shape[0] // 2
        visible = rowflags[:Pb]
        found = rowflags[Pb:]
        n_inl = pose[12]
        frame.R = np.asarray(pose[:9], np.float64).reshape(3, 3)
        frame.t = np.asarray(pose[9:12], np.float64)
        frame.feats = DeviceFeatures(out["feats"], out["feats_host"])
        P = len(ids)
        frame.mp = np.full(assoc.shape[0], -1, np.int32)
        okf = (assoc >= 0) & (assoc < P)
        frame.mp[okf] = ids[assoc[okf]]
        # cached tensors can outlive a culled/replaced point by a frame
        # (async mapping): drop stale ids
        stale = (frame.mp >= 0) & ~m.mp_valid[np.maximum(frame.mp, 0)]
        frame.mp[stale] = -1
        vis_ids = ids[visible[:P]]
        fnd_ids = ids[found[:P]]
        m.mp_visible[vis_ids[m.mp_valid[vis_ids]]] += 1
        m.mp_found[fnd_ids[m.mp_valid[fnd_ids]]] += 1
        return int(n_inl)

    def track(self, img_l, img_r, frame, R0, t0, min_req: int):
        """Synchronous fused step (dispatch + complete)."""
        pose_in = np.concatenate([
            np.asarray(R0, np.float32).ravel(), np.asarray(t0, np.float32),
            np.float32([0.0])])
        out = self.dispatch(img_l, img_r, pose_in, min_req)
        return self.complete(out, frame)
