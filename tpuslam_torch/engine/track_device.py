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

The kernels on this path are the patch gather (ops/patch_cuda.py, 16
launches per stereo frame) and the pose LM (solve/pose_opt_cuda.py, 4
launches per frame).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..engine.config import OrbConfig, TrackingConfig
from ..ops import match as M
from ..ops.hamming import hamming_matrix
from ..ops.orb import OrbExtractor
from ..ops.stereo import sad_refine_pyramid, stereo_match
from ..solve.pose_opt_cuda import pose_optimize_fused


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
                 n_passes: int = 3, device=None):
        super().__init__()
        if tcfg.fused_sad != "pyramid":
            raise NotImplementedError("only fused_sad='pyramid' is ported")
        self.camera = camera
        self.tcfg = tcfg
        self.n_levels = n_levels
        self.scale = scale
        self.log_sf = float(np.log(scale))
        self.bf = float(bf)
        self.stereo = stereo
        self.n_passes = n_passes
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
        u_r, sadv, ok = sad_refine_pyramid(
            imgs[0], imgs[1], fl["xy"], fl["octave"], u_r, ok,
            n_levels=self.n_levels, scale=self.scale)
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
