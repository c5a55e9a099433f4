"""Device-side local-mapping kernels: fuse + triangulation matching
(port of tpuslam/engine/map_device.py).

Keyframe features are cached ON the device (uploaded once per KF), the
candidate masks are computed on the device from compact per-call geometry
(point positions, fundamental matrices, free-slot flags; the frustum,
window, level and epipolar formulas of ORBmatcher::Fuse,
src/ORBmatcher.cc:1403, and SearchForTriangulation, :969), and only the
small argmin results come back to the host. These are XLA programs in
tpuslam and plain PyTorch here. The JAX version pads targets and points to
fixed buckets so that no program recompiles mid-run; eager PyTorch runs
each call at its own size, and padded rows were masked out, so the
results are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import match as M
from ..ops.hamming import hamming_matrix
from ..utils import DEFAULT_DEVICE, resolve_device

FUSE_CHUNK = 4096  # points per reverse-fuse call (bounds the [T,P,N] masks)
MAX_TARGETS = 32   # neighbours per fuse / triangulation call


def unpack_desc(packed):
    """[.., 8] u32 (ops/orb.pack_bits layout) -> [.., 256] u8 {0,1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.uint8)


class KFDeviceCache:
    """Per-keyframe feature tensors resident on the device.

    Features are immutable per KF id, so entries never go stale; the LRU
    cap only bounds device memory (~60 KB per KF)."""

    def __init__(self, device, capacity: int = 160):
        self.device = torch.device(device)
        self.capacity = capacity
        self._store: dict[int, dict] = {}

    def get(self, m, kf: int) -> dict:
        e = self._store.pop(int(kf), None)
        if e is None:
            f = m.kf_feats[kf]

            def up(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a), device=self.device).to(dtype)

            e = dict(
                xy=up(f.xy, torch.float32),
                und_xy=up(f.und_xy, torch.float32),
                norm_xy=up(f.norm_xy, torch.float32),
                oct=up(f.octave, torch.int32),
                ang=up(f.angle, torch.float32),
                valid=up(f.valid, torch.bool),
                packed=up(np.asarray(f.packed, np.uint32).astype(np.int64), torch.int64),
            )
        self._store[int(kf)] = e  # re-insert = most recent
        while len(self._store) > self.capacity:
            self._store.pop(next(iter(self._store)))
        return e

    def drop(self, kf: int):
        self._store.pop(int(kf), None)

    def clear(self):
        self._store.clear()


def fuse_candidates(camera, sf, log_sf: float, fuse_radius: float, n_levels: int,
                    geo, pbits, pvalid, Rt, kf_ok, txy, toct, tval, tpacked):
    """The fuse-candidate kernel (tpuslam's make_fuse_kernel step).

    geo [P,8] (X | normal | mind | maxd), pbits [P,256] u8, pvalid [P],
    Rt [T,3,4], kf_ok [T], txy [T,N,2], toct [T,N], tval [T,N],
    tpacked [T,N,8] -> (bestFeat [T,P] i32 (-1 = none), bestDist [T,P] i32).

    Per (target, point): frustum + distance-band + view-angle gates (ref
    Frame::isInFrustum via ORBmatcher::Fuse, src/ORBmatcher.cc:1403-1473),
    window radius fuse_radius * sf[predicted level], level gate
    |oct - pred| <= 1, Hamming argmin over the target's features."""
    X = geo[:, 0:3]
    normal = geo[:, 3:6]
    mind, maxd = geo[:, 6], geo[:, 7]
    R = Rt[:, :, :3]
    t = Rt[:, :, 3]
    T, N = txy.shape[:2]
    P = X.shape[0]
    W, H = float(camera.width), float(camera.height)
    Xc = torch.einsum("tij,pj->tpi", R, X) + t[:, None, :]   # [T,P,3]
    uv = camera.project(Xc)                                   # [T,P,2]
    Ow = -torch.einsum("tji,tj->ti", R, t)                    # [T,3]
    vdir = X[None] - Ow[:, None]                              # [T,P,3]
    dist = torch.linalg.norm(vdir, dim=-1)
    cosv = (vdir * normal[None]).sum(-1) / torch.clamp(dist, min=1e-9)
    vis = (
        (Xc[..., 2] > 0)
        & (uv[..., 0] >= 0) & (uv[..., 0] < W)
        & (uv[..., 1] >= 0) & (uv[..., 1] < H)
        & (dist >= 0.8 * mind[None]) & (dist <= 1.2 * maxd[None])
        & (cosv > 0.5) & pvalid[None] & kf_ok[:, None]
    )                                                         # [T,P]
    ratio = maxd[None] / torch.clamp(dist, min=1e-9)
    pred = torch.clamp(torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_sf),
                       0, n_levels - 1).to(torch.int64)      # [T,P]
    radius = fuse_radius * sf[pred]                           # [T,P]
    dx = torch.abs(uv[..., 0][:, :, None] - txy[..., 0][:, None, :])
    dy = torch.abs(uv[..., 1][:, :, None] - txy[..., 1][:, None, :])
    win = (dx <= radius[..., None]) & (dy <= radius[..., None])
    lvl = (toct[:, None, :] >= pred[..., None] - 1) & (toct[:, None, :] <= pred[..., None] + 1)
    mask = win & lvl & tval[:, None, :] & vis[..., None]      # [T,P,N]
    dist_h = hamming_matrix(unpack_desc(tpacked).reshape(T * N, 256), pbits).reshape(T, N, P)
    d = torch.where(mask, dist_h.transpose(1, 2), M.BIG)      # [T,P,N]
    best_feat = torch.argmin(d, dim=-1)
    best = d.gather(-1, best_feat[..., None])[..., 0]
    best_feat = best_feat.to(torch.int32)
    return torch.where(best <= M.TH_LOW, best_feat, -1), best.to(torch.int32)


def tri_candidates(opacked, oang, oxyh, ofree, Fm, gxy, tfree, tsig2, tpacked, tang):
    """The triangulation matcher (tpuslam's make_tri_kernel step; ref
    ORBmatcher::SearchForTriangulation, src/ORBmatcher.cc:969-1090): rows =
    the new KF's features, cols = the concatenated neighbour features; mask
    = epipolar distance gate from per-neighbour F matrices & free slots;
    dist <= TH_LOW, rotation-histogram consistency, one-to-one.

    gxy / oxyh: the gate coordinates, undistorted pixels for pinhole F
    matrices or normalized ray coordinates for the essential matrices of a
    fisheye (kb8) camera; tsig2 [T,N]: the thresholds 3.84 * sigma2, divided
    by fx^2 in the normalized case (ref KB8 epipolarConstrain,
    KannalaBrandt8.cpp:202).

    -> (midx [N] i32 into the flattened T*N columns or -1, mdist [N] i32)."""
    N = opacked.shape[0]
    T, Nt = gxy.shape[:2]
    lines = torch.einsum("ni,tij->tnj", oxyh, Fm)             # [T,N,3]
    num = (lines[..., 0][:, :, None] * gxy[..., 0][:, None, :]
           + lines[..., 1][:, :, None] * gxy[..., 1][:, None, :]
           + lines[..., 2][:, :, None])                       # [T,No,Nt]
    den = torch.clamp(lines[..., 0] ** 2 + lines[..., 1] ** 2, min=1e-12)[:, :, None]
    epi = (num * num / den) < tsig2[:, None, :]
    mask = epi & tfree[:, None, :] & ofree[None, :, None]
    mask2 = mask.transpose(0, 1).reshape(N, T * Nt)
    dist = hamming_matrix(unpack_desc(opacked), unpack_desc(tpacked).reshape(T * Nt, 256))
    idx, best, _ = M.masked_best2(dist, mask2)
    ok = best <= M.TH_LOW
    ok = M.rotation_consistency(oang, tang.reshape(T * Nt)[idx.long()], ok)
    idx, ok = M.resolve_duplicates(idx, best, ok, T * Nt)
    return torch.where(ok, idx, -1), torch.where(ok, best, M.BIG).to(torch.int32)


class MapDeviceKernels:
    """The fuse and triangulation kernels plus the KF cache of one
    LocalMapper, on its device."""

    def __init__(self, camera, sf, fuse_radius: float, n_levels: int,
                 device=DEFAULT_DEVICE):
        self.camera = camera
        self.device = resolve_device(device)
        self.sf = np.asarray(sf, np.float64)
        self.sf_dev = torch.as_tensor(self.sf.astype(np.float32), device=self.device)
        self.log_sf = float(np.log(self.sf[1]))
        self.fuse_radius = float(fuse_radius)
        self.n_levels = int(n_levels)
        self.cache = KFDeviceCache(self.device)

    # ---------------------------------------------------------------- fuse
    def fuse_snapshot(self, m, targets, mp_ids):
        """Under the map lock: snapshot the per-call geometry (point
        positions / normals / distance bands / descriptors, target poses,
        KF feature handles). Returns an opaque dict for fuse_run."""
        P, T = len(mp_ids), len(targets)
        geo = np.concatenate([
            m.mp_pos[mp_ids], m.mp_normal[mp_ids],
            m.mp_min_dist[mp_ids, None], m.mp_max_dist[mp_ids, None]], 1).astype(np.float32)
        Rt = np.zeros((T, 3, 4), np.float32)
        kf_ok = np.zeros(T, bool)
        ents = []
        for i, kn in enumerate(targets):
            Rt[i, :, :3] = m.kf_R[kn]
            Rt[i, :, 3] = m.kf_t[kn]
            kf_ok[i] = m.kf_valid[kn]
            ents.append(self.cache.get(m, kn))
        return dict(P=P, T=T, geo=geo, pvalid=m.mp_valid[mp_ids].copy(), Rt=Rt,
                    kf_ok=kf_ok, ents=ents, pbits=m.mp_bits[mp_ids].copy())

    def fuse_run(self, snap):
        """Lock-free: run the kernel on the snapshot. For each (target KF,
        point) returns (best feature slot, dist) or (-1, BIG)."""
        ents = snap["ents"]
        dev = self.device

        def up(a):
            return torch.as_tensor(a, device=dev)

        bf, bd = fuse_candidates(
            self.camera, self.sf_dev, self.log_sf, self.fuse_radius, self.n_levels,
            up(snap["geo"]), up(snap["pbits"]), up(snap["pvalid"]), up(snap["Rt"]),
            up(snap["kf_ok"]),
            torch.stack([e["xy"] for e in ents]), torch.stack([e["oct"] for e in ents]),
            torch.stack([e["valid"] for e in ents]), torch.stack([e["packed"] for e in ents]))
        return bf.cpu().numpy(), bd.cpu().numpy()

    # ------------------------------------------------------- triangulation
    def tri_match(self, m, kf: int, ofree, used, Fms, free2, gate_norm: bool, sig2_cols):
        """Triangulation match of kf's free features against the `used`
        neighbours. ofree [N]: the new KF's free-slot
        mask; Fms [T,3,3] per-neighbour F (undistorted px) or E
        (normalized); free2 [T,N] free-slot masks; sig2_cols [T,N]
        epipolar thresholds (3.84 * sigma2, pre-scaled).
        Returns (midx [N] flattened col into T*N or -1, dist [N])."""
        own = self.cache.get(m, kf)
        N = int(own["xy"].shape[0])
        ents = [self.cache.get(m, kn) for kn in used]
        key = "norm_xy" if gate_norm else "und_xy"
        oxyh = torch.cat([own[key], torch.ones((N, 1), dtype=torch.float32,
                                               device=self.device)], 1)
        dev = self.device
        midx, mdist = tri_candidates(
            own["packed"], own["ang"], oxyh,
            torch.as_tensor(np.asarray(ofree, bool), device=dev),
            torch.as_tensor(np.asarray(Fms, np.float32), device=dev),
            torch.stack([e[key] for e in ents]),
            torch.as_tensor(np.asarray(free2, bool), device=dev),
            torch.as_tensor(np.asarray(sig2_cols, np.float32), device=dev),
            torch.stack([e["packed"] for e in ents]), torch.stack([e["ang"] for e in ents]))
        return midx.cpu().numpy(), mdist.cpu().numpy()
