"""Local mapping: triangulation, fusion, local BA, culling (port of
tpuslam/engine/local_mapping.py, visual mono / stereo / RGB-D).

The reference's LocalMapping thread (src/LocalMapping.cc): the mapper
runs once per keyframe, synchronously from the tracker or on the worker
of parallel/async_mapping.AsyncMapper. Its device work (the fuse
and triangulation kernels of map_device.py, local BA) runs on the
mapper's device; the map itself is host state.

Pipeline per new KF (ref: LocalMapping::Run :67-276):
  ProcessNewKeyFrame -> MapPointCulling (:341) -> CreateNewMapPoints (:383)
  -> SearchInNeighbors fuse (:729) -> local BA (Optimizer.cc:1699)
  -> KeyFrameCulling (:935).

Two faults of tpuslam's mapper are repaired here: `_erase_keyframe`
reparents a culled keyframe's children to its saved spanning-tree parent
(tpuslam points them at the recovery anchor, which can make a child its
own parent), and `_create_new_points` caps the triangulation neighbours
at MAX_TARGETS (tpuslam passes n_triangulate_neighbors uncapped into a
kernel padded to 32). A loop closer, when wired, is told of every culled
keyframe.

With an ImuCalib the mapper runs tpuslam's inertial stages: the IMU-init
state machine (init, VIBA1 at 5 s, VIBA2 at 15 s, periodic scale
refinement; engine/inertial.py), the inertial local BA once the IMU is
initialized, the temporal-chain protection in keyframe culling, and the
chain splice when a keyframe is erased.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..map.store import SlamMap
from ..solve import ba as B
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.timing import GLOBAL_TIMER as T
from ..utils.verbose import Level, print_mess
from .config import SlamConfig
from .inertial import full_inertial_ba, local_inertial_ba, run_imu_init
from .map_device import FUSE_CHUNK, MAX_TARGETS, MapDeviceKernels


def _no_lock():
    return contextlib.nullcontext()


class LocalMapper:
    def __init__(self, camera, cfg: SlamConfig, slam_map: SlamMap, bf: float = 0.0,
                 imu_calib=None, mono: bool | None = None, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        """bf > 0 for stereo / RGB-D, 0 for a monocular map (its scale is
        anchored by nothing). imu_calib: an ImuCalib enables the inertial
        stages; mono (default: bf == 0) selects the scale-solving IMU init
        and the scale refinement. device: where the mapping kernels and the
        BAs run; dtype: the BAs' float type (f32 on the card)."""
        self.camera = camera
        self.camspec = camera.spec
        self.cfg = cfg
        self.map = slam_map
        self.bf = bf
        # set by System when loop closing is wired: told of culled KFs
        self.loop_closer = None
        self.device = resolve_device(device)
        self.dtype = dtype
        self.recent_points: list[tuple[int, int]] = []  # (mp, created_at_kf)
        self.sf = slam_map.scale_factors
        self.inv_sigma2 = 1.0 / self.sf ** 2
        self.imu_calib = imu_calib
        self.mono = bf <= 0 if mono is None else mono
        # BA interruption hook (ref: mbAbortBA LocalMapping.cc:103,283); the
        # async mapper points it at its queue's non-empty check
        self.abort_check = None
        # debug-dump records of the IMU-init and VIBA events (ref:
        # System::SaveDebugData, System.cc:836-889): event, t, n_kfs, bg, ba
        self.debug_events: list[dict] = []
        self._devk = None

    # the IMU schedule (the time of the IMU init, the VIBA stage, the last
    # scale refinement) is the current map's (map/store.py): tpuslam keeps
    # it on the mapper, so a young map after change_dataset() ran on with
    # the old map's last refinement, and a merged map with the young map's
    # stage, its scale refinements rescaling the old map's keyframes too
    @property
    def imu_init_time(self):
        return self.map.imu_init_time

    @imu_init_time.setter
    def imu_init_time(self, value):
        self.map.imu_init_time = value

    @property
    def viba_stage(self):
        return self.map.viba_stage

    @viba_stage.setter
    def viba_stage(self, value):
        self.map.viba_stage = value

    @property
    def _last_refine(self):
        return self.map.last_refine

    @_last_refine.setter
    def _last_refine(self, value):
        self.map.last_refine = value

    @property
    def devk(self):
        """Fuse / triangulation kernels + KF feature cache (map_device.py),
        built on the first keyframe."""
        if self._devk is None:
            self._devk = MapDeviceKernels(self.camera, self.sf, self.cfg.mapping.fuse_radius,
                                          len(self.sf), self.device)
        return self._devk

    # ------------------------------------------------------------------ main
    def on_new_keyframe(self, kf: int, lock=None):
        """One mapping step for a new KF.

        lock: when the async worker passes the map lock, it is acquired PER
        STAGE, so the tracker's brief per-frame lock takes interleave
        between stages instead of stalling for the whole step."""
        hold = (lambda: lock) if lock is not None else _no_lock
        m = self.map
        with hold():
            # ProcessNewKeyFrame: refresh stats of points seen by this KF
            m.update_point_stats_batch(np.unique(m.kf_mp[kf]))
            m.update_connections(kf)
            self._cull_recent_points(kf)
        if m.n_kf >= 2:
            with T.stage("triangulate"):
                self._create_new_points(kf, hold=hold)
            with T.stage("fuse"):
                self._fuse_neighbors(kf, hold=hold)
            with T.stage("local_ba"):
                # sensor-aware interrupt discipline: with the scale anchored
                # by stereo / RGB-D depth a queued KF defers local BA (ref
                # LocalMapping::Run :103,283); on a scale-free mono map the
                # robust first phase always runs and only the second phase
                # yields to the queue (window_ba's abort_check), since a
                # full skip starves BA and lets the mono scale drift. An
                # initialized IMU anchors the scale too.
                backlog = self.abort_check is not None and self.abort_check()
                scale_anchored = self.bf > 0 or m.imu_initialized
                if backlog and scale_anchored:
                    pass
                elif m.imu_initialized:
                    with T.stage("local_inertial_ba"):
                        self._local_inertial_ba(kf, hold=hold)
                else:
                    self._local_ba(kf, hold=hold)
            with T.stage("kf_culling"), hold():
                self._cull_keyframes(kf)
        if self.imu_calib is not None:
            with T.stage("imu_stage"), hold():
                self._imu_stage(kf)

    # ---------------------------------------------------------------- inertial
    def _record(self, event: str, t_now: float):
        m = self.map
        chain = m.temporal_chain()
        last = chain[-1] if chain else -1
        self.debug_events.append(dict(
            event=event, t=t_now, n_kfs=len(chain),
            bg=m.kf_bg[last].tolist() if last >= 0 else None,
            ba=m.kf_ba[last].tolist() if last >= 0 else None))
        print_mess(f"[local_mapping] {event} t={t_now:.3f} kfs={len(chain)}", Level.NORMAL)

    def _full_inertial_ba(self, prior_g, prior_a):
        full_inertial_ba(self.map, self.camera, self.imu_calib, self.inv_sigma2, prior_g=prior_g,
                         prior_a=prior_a, device=self.device, dtype=self.dtype)

    def _imu_stage(self, kf: int):
        """IMU-init state machine (ref LocalMapping.cc:162-221: InitializeIMU,
        then VIBA1 at 5 s, VIBA2 at 15 s, scale refinement meanwhile)."""
        m = self.map
        icfg = self.cfg.inertial
        chain = m.temporal_chain()
        if not chain:
            return
        t_now = float(m.kf_time[kf])
        span = t_now - float(m.kf_time[chain[0]])
        if not m.imu_initialized:
            if len(chain) < icfg.init_min_kfs or span < icfg.init_min_span:
                return
            if run_imu_init(m, self.imu_calib, mono=self.mono, prior_g=icfg.prior_g1,
                            prior_a=icfg.prior_a1, vis_rot_sigma=icfg.init_vis_rot_sigma,
                            vis_pos_sigma=icfg.init_vis_pos_sigma,
                            max_logs_sigma=icfg.init_max_logs_sigma, device=self.device):
                self._full_inertial_ba(icfg.prior_g1, icfg.prior_a1)
                self.imu_init_time = t_now
                self.viba_stage = 1
                self._record("imu_init", t_now)
            return
        elapsed = t_now - self.imu_init_time
        if self.viba_stage == 1 and elapsed > icfg.viba1_time:
            self._full_inertial_ba(icfg.prior_g2, icfg.prior_a2)
            m.inertial_ba1 = True
            self.viba_stage = 2
            self._record("viba1", t_now)
        elif self.viba_stage == 2 and elapsed > icfg.viba2_time:
            self._full_inertial_ba(0.0, 0.0)
            m.inertial_ba2 = True
            self.viba_stage = 3
            self._record("viba2", t_now)
        elif (self.viba_stage < 3 and elapsed < icfg.scale_refine_until
              and t_now - self._last_refine > icfg.scale_refine_period):
            # periodic JOINT full VI BA + (mono) inertial-only scale / gravity
            # refinement while the estimate is young (ref LocalMapping.cc
            # :208-219): correlated visual rotation drift reads as a scale
            # change to the poses-fixed refinement, so full BA runs first
            self._last_refine = t_now
            self._full_inertial_ba(icfg.prior_g2, icfg.prior_a2)
            if self.mono and not m.merged:
                run_imu_init(m, self.imu_calib, mono=True, opt_bias=False, device=self.device)

    def _local_inertial_ba(self, kf: int, hold=_no_lock):
        """Until VIBA2 declares the biases converged, keep the zero-mean
        bias priors on: with gentle motion a free accelerometer bias absorbs
        the scale / gravity signal (ref priorA=1e5 until the 15 s FIBA)."""
        icfg = self.cfg.inertial
        pg, pa = (0.0, 0.0) if self.map.inertial_ba2 else (icfg.prior_g2, icfg.prior_a2)
        local_inertial_ba(self.map, kf, self.camera, self.imu_calib, self.inv_sigma2,
                          window=icfg.local_window, prior_g=pg, prior_a=pa, hold=hold,
                          device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------- culling
    def _cull_recent_points(self, kf: int):
        """ref: MapPointCulling (LocalMapping.cc:341)."""
        m = self.map
        keep = []
        for mp, born in self.recent_points:
            if not m.mp_valid[mp]:
                continue
            age = kf - born
            ratio = m.mp_found[mp] / max(m.mp_visible[mp], 1)
            if ratio < self.cfg.mapping.recent_cull_found_ratio:
                m.set_bad_point(mp)
            elif age >= 2 and len(m.mp_obs[mp]) <= 2:
                m.set_bad_point(mp)
            elif age >= 3:
                pass  # graduates
            else:
                keep.append((mp, born))
        self.recent_points = keep

    def _cull_keyframes(self, kf: int):
        """ref: KeyFrameCulling (LocalMapping.cc:935) — a local KF is
        redundant if >=90% of its points are seen by >=3 other KFs at the
        same or finer scale. Inertial maps protect the temporal chain: the
        last 21 KFs are never culled, nothing is culled before IMU init,
        and a cull may not open a time gap over 0.5 s (ref :949-961, :1019)."""
        m = self.map
        inertial = self.imu_calib is not None
        protected = set(m.temporal_chain()[-21:]) if inertial else set()
        for cand in m.best_covisible(kf):
            if cand == 0 or not m.kf_valid[cand]:
                continue
            if inertial:
                if cand in protected or not m.imu_initialized:
                    continue
                prev = int(m.kf_prev[cand])
                nxts = np.nonzero(m.kf_prev[: m.n_kf] == cand)[0]
                if prev < 0 or len(nxts) != 1 or m.kf_time[nxts[0]] - m.kf_time[prev] > 0.5:
                    continue
            slots = np.nonzero(m.kf_mp[cand] >= 0)[0]
            if len(slots) == 0:
                continue
            n_red = m.redundancy(cand, min_obs=3)
            if n_red > self.cfg.mapping.culling_redundancy * len(slots):
                self._erase_keyframe(cand)

    def _erase_keyframe(self, cand: int):
        m = self.map
        if self._devk is not None:
            self._devk.cache.drop(cand)
        if self.loop_closer is not None:
            self.loop_closer.on_kf_erased(cand)
        # trajectory-recovery anchor: the strongest surviving covisible KF
        # (it moves with the culled KF's neighbourhood under later BA)
        anchor = int(m.kf_parent[cand])
        best_w = 0
        for o, w in m.covis[cand].items():
            if m.kf_valid[o] and o != cand and w > best_w:
                anchor, best_w = int(o), int(w)
        for slot in np.nonzero(m.kf_mp[cand] >= 0)[0]:
            m.erase_observation(int(m.kf_mp[cand, slot]), cand)
        for o in list(m.covis[cand]):
            m.covis[o].pop(cand, None)
        m.covis[cand] = {}
        m.kf_valid[cand] = False
        # splice the temporal (inertial) chain: the next KF inherits prev;
        # its preintegration is rebuilt from the joined raw windows on use
        for c in np.nonzero(m.kf_prev[: m.n_kf] == cand)[0]:
            m.kf_prev[c] = m.kf_prev[cand]
            m.kf_preint[c] = None
            if m.kf_imu[c] is not None and m.kf_imu[cand] is not None:
                m.kf_imu[c] = tuple(np.concatenate([x1, x2])
                                    for x1, x2 in zip(m.kf_imu[cand], m.kf_imu[c]))
        # reparent the live children (spanning tree) to the saved parent
        # BEFORE cand's own pointer moves to the anchor. Culled KFs that
        # point at cand keep pointing at it: their stored relative pose is
        # to cand, whose recovery pointer leads on to the anchor.
        parent = int(m.kf_parent[cand])
        for c in np.nonzero(m.kf_parent[: m.n_kf] == cand)[0]:
            if m.kf_valid[c]:
                m.kf_parent[c] = parent
        if anchor >= 0:
            # store pose relative to the anchor for trajectory recovery
            # (ref: KeyFrame::SetBadFlag mTcp); the recovery walk follows
            # kf_parent through culled KFs
            Rp, tp = m.kf_R[anchor], m.kf_t[anchor]
            Rcp = m.kf_R[cand] @ Rp.T
            tcp = m.kf_t[cand] - Rcp @ tp
            m.kf_tcp[cand] = (Rcp, tcp)
            m.kf_parent[cand] = anchor

    # -------------------------------------------------------- triangulation
    def _create_new_points(self, kf: int, hold=_no_lock):
        """ref: CreateNewMapPoints (LocalMapping.cc:383). All neighbours'
        candidate matches go through ONE triangulation-kernel call
        (map_device.tri_candidates), with the epipolar masks computed on
        the device; the per-match two-view triangulation and gates run in
        vectorized numpy. The map lock is held for the snapshot and the
        insert sections only. A fisheye (kb8) camera has no common image
        plane for a pixel F matrix: its epipolar gate is the essential
        matrix in normalized ray coordinates, thresholds scaled by 1/fx^2
        (the camera-generic form of KB8 epipolarConstrain,
        KannalaBrandt8.cpp:202)."""
        m = self.map
        cfg = self.cfg.mapping
        cam = self.camera
        kb8 = self.camspec.kind == "kb8"
        Fms, free2_l, sig2_l, used = [], [], [], []
        pose_snap = {}
        with hold():
            neighbors = m.best_covisible(kf, min(cfg.n_triangulate_neighbors, MAX_TARGETS))
            R1, t1 = m.kf_R[kf].copy(), m.kf_t[kf].copy()
            O1 = m.kf_center(kf)
            f1 = m.kf_feats[kf]
            free1 = (m.kf_mp[kf] < 0) & f1.valid
            if not free1.any():
                m.update_connections(kf)
                return 0
            Kinv = np.linalg.inv(cam.K().astype(np.float64))
            for kn in neighbors:
                R2, t2 = m.kf_R[kn].copy(), m.kf_t[kn].copy()
                O2 = m.kf_center(kn)
                baseline = np.linalg.norm(O2 - O1)
                med_depth = self._median_depth(kn)
                if med_depth <= 0 or baseline / med_depth < cfg.min_baseline_depth_ratio:
                    continue
                pose_snap[kn] = (R2, t2)
                f2 = m.kf_feats[kn]
                free2_l.append((m.kf_mp[kn] < 0) & f2.valid)
                # essential matrix from the relative pose (ref ComputeF12)
                R12 = R1 @ R2.T
                t12 = -R12 @ t2 + t1
                E12 = np.array([[0, -t12[2], t12[1]],
                                [t12[2], 0, -t12[0]],
                                [-t12[1], t12[0], 0]]) @ R12
                if kb8:
                    Fms.append(E12.astype(np.float32))
                    sig2_l.append(3.84 * self.sf[f2.octave] ** 2 / float(cam.fx) ** 2)
                else:
                    Fms.append((Kinv.T @ E12 @ Kinv).astype(np.float32))
                    sig2_l.append(3.84 * self.sf[f2.octave] ** 2)
                used.append(kn)
        if not used:
            with hold():
                m.update_connections(kf)
            return 0
        n2 = f1.n  # per-neighbour feature count (fixed extractor budget)
        # NO ratio test: SearchForTriangulation gates on dist < TH_LOW +
        # epipolar only (ORBmatcher.cc:1061-1085); rotation histogram and
        # one-to-one run inside the kernel
        with T.stage("tri.kernel"):
            midx, _ = self.devk.tri_match(
                m, kf, free1, used, np.stack(Fms), np.stack(free2_l), kb8,
                np.stack(sig2_l).astype(np.float32))
        r1 = np.nonzero(midx >= 0)[0]
        if len(r1) == 0:
            with hold():
                m.update_connections(kf)
            return 0
        t_idx = midx[r1] // n2
        i2 = midx[r1] % n2
        i1 = r1
        kns = np.asarray(used)[t_idx]
        R2s = np.stack([pose_snap[int(k)][0] for k in kns])
        t2s = np.stack([pose_snap[int(k)][1] for k in kns])
        # two-view DLT triangulation, vectorized on the host
        P1 = np.concatenate([R1, t1[:, None]], 1)
        P2 = np.concatenate([R2s, t2s[:, :, None]], 2)  # [M,3,4]
        x1 = f1.norm_xy[i1]
        f2cat_norm = np.stack([m.kf_feats[k].norm_xy for k in used])
        f2cat_und = np.stack([m.kf_feats[k].und_xy for k in used])
        f2cat_oct = np.stack([m.kf_feats[k].octave for k in used])
        x2 = f2cat_norm[t_idx, i2]
        A = np.stack([
            x1[:, 0, None] * P1[2][None] - P1[0][None],
            x1[:, 1, None] * P1[2][None] - P1[1][None],
            x2[:, 0, None] * P2[:, 2] - P2[:, 0],
            x2[:, 1, None] * P2[:, 2] - P2[:, 1],
        ], axis=1)  # [M,4,4]
        _, _, Vt = np.linalg.svd(A)
        Xh = Vt[:, -1]
        X = Xh[:, :3] / np.where(np.abs(Xh[:, 3:]) < 1e-12, 1e-12, Xh[:, 3:])
        # gates (ref LocalMapping.cc:470-720): parallax, cheirality,
        # reprojection chi2, scale consistency
        O2s = -np.einsum("mij,mi->mj", R2s, t2s)
        r1 = X - O1[None]
        r2 = X - O2s
        d1 = np.linalg.norm(r1, axis=1)
        d2 = np.linalg.norm(r2, axis=1)
        cosp = np.sum(r1 * r2, 1) / np.maximum(d1 * d2, 1e-12)
        Xc1 = X @ R1.T + t1
        Xc2 = np.einsum("mij,mj->mi", R2s, X) + t2s
        uv1 = cam.project_np(Xc1)
        uv2 = cam.project_np(Xc2)
        oct2 = f2cat_oct[t_idx, i2]
        e1 = ((uv1 - f1.und_xy[i1]) ** 2).sum(1) / self.sf[f1.octave[i1]] ** 2
        e2 = ((uv2 - f2cat_und[t_idx, i2]) ** 2).sum(1) / self.sf[oct2] ** 2
        ratio_d = d1 / np.maximum(d2, 1e-9)
        ratio_oct = self.sf[f1.octave[i1]] / self.sf[oct2]
        ok = (
            (cosp < 0.9998)
            & (Xc1[:, 2] > 0)
            & (Xc2[:, 2] > 0)
            & (e1 < 5.991)
            & (e2 < 5.991)
            & (ratio_d < ratio_oct * 1.5 * self.sf[1])
            & (ratio_d * 1.5 * self.sf[1] > ratio_oct)
        )
        n_created = 0
        with hold():
            for w in np.nonzero(ok)[0]:
                a, b, kn = int(i1[w]), int(i2[w]), int(kns[w])
                if m.kf_mp[kf, a] >= 0 or m.kf_mp[kn, b] >= 0 or not m.kf_valid[kn]:
                    continue
                mp = m.add_point(X[w], kf, a)
                m.add_observation(mp, kn, b)
                m.update_point_stats(mp)
                self.recent_points.append((mp, kf))
                n_created += 1
            m.update_connections(kf)
        return n_created

    def _median_depth(self, kf: int):
        m = self.map
        ids = m.kf_mp[kf][m.kf_mp[kf] >= 0]
        if len(ids) == 0:
            return -1.0
        Xc = m.mp_pos[ids] @ m.kf_R[kf].T + m.kf_t[kf]
        return float(np.median(Xc[:, 2]))

    # ---------------------------------------------------------------- fusion
    def _fuse_neighbors(self, kf: int, hold=_no_lock):
        """ref: SearchInNeighbors (LocalMapping.cc:729) + ORBmatcher::Fuse.
        Both directions (this KF's points into every neighbour; the
        neighbourhood's points into this KF) are fuse-kernel calls on the
        device-cached KF features; snapshot and merge run under the lock,
        the kernel without it."""
        m = self.map
        with T.stage("fuse.snap"), hold():
            targets = m.best_covisible(kf, 10)
            second = set()
            for kn in targets:
                for o in m.best_covisible(kn, 5):
                    if o != kf and o not in targets:
                        second.add(o)
            targets = [k for k in list(targets) + list(second)
                       if m.kf_valid[k]][:MAX_TARGETS]
            own = np.unique(m.kf_mp[kf])
            own = own[own >= 0]
            own = own[m.mp_valid[own]]
            snap_fwd = (self.devk.fuse_snapshot(m, targets, own)
                        if len(own) and targets else None)
            nbr_pts = np.unique(m.kf_mp[targets]) if targets else np.zeros(0, int)
            nbr_pts = nbr_pts[nbr_pts >= 0]
            nbr_pts = nbr_pts[m.mp_valid[nbr_pts]]
            rev_chunks = [nbr_pts[i:i + FUSE_CHUNK] for i in range(0, len(nbr_pts), FUSE_CHUNK)]
            snaps_rev = [self.devk.fuse_snapshot(m, [kf], c) for c in rev_chunks]
        if snap_fwd is not None:
            with T.stage("fuse.kernel"):
                bf, _ = self.devk.fuse_run(snap_fwd)
            with T.stage("fuse.merge"), hold():
                self._merge_candidates(targets, own, bf)
        for chunk, snap_rev in zip(rev_chunks, snaps_rev):
            with T.stage("fuse.kernel"):
                bf, _ = self.devk.fuse_run(snap_rev)
            with T.stage("fuse.merge"), hold():
                self._merge_candidates([kf], chunk, bf)
        with T.stage("fuse.stats"), hold():
            m.update_point_stats_batch(np.unique(m.kf_mp[kf]))
            m.update_connections(kf)

    def _merge_candidates(self, targets, mp_ids, best_feat):
        """Apply fuse results: per (target KF, point) best feature — merge
        with the slot's existing point or claim a free slot (ORBmatcher::
        Fuse semantics, ORBmatcher.cc:1403). Under the map lock;
        staleness-guarded against cull/replace during the kernel."""
        m = self.map
        ti, pi = np.nonzero(best_feat >= 0)
        for t_i, p in zip(ti, pi):
            kn = targets[int(t_i)]
            if not m.kf_valid[kn]:
                continue
            slot = int(best_feat[t_i, p])
            mp = int(mp_ids[p])
            if not m.mp_valid[mp]:
                continue
            existing = int(m.kf_mp[kn, slot])
            if existing >= 0:
                if existing != mp and m.mp_valid[existing]:
                    # keep the one with more observations (ref: Fuse)
                    if len(m.mp_obs[existing]) > len(m.mp_obs[mp]):
                        m.replace_point(mp, existing)
                    else:
                        m.replace_point(existing, mp)
            else:
                m.add_observation(mp, kn, slot)

    def _fuse_into(self, kf: int, mp_ids):
        """Project mp_ids into kf and merge. Caller holds the map lock."""
        m = self.map
        mp_ids = np.asarray(mp_ids, np.int64)
        mp_ids = mp_ids[mp_ids >= 0]
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        if len(mp_ids) == 0 or not m.kf_valid[kf]:
            return
        bf, _ = self.devk.fuse_run(self.devk.fuse_snapshot(m, [kf], mp_ids))
        self._merge_candidates([kf], mp_ids, bf)

    # ---------------------------------------------------------------- localBA
    def _local_ba(self, kf: int, hold=_no_lock):
        """ref: Optimizer::LocalBundleAdjustment (Optimizer.cc:1699): window =
        covisible KFs of kf; points they see; fixed frontier = other KFs
        observing those points; 5+10 LM schedule with chi2 pruning."""
        window = [kf] + self.map.best_covisible(kf)
        window_ba(self.map, self.camera, self.camspec, self.inv_sigma2, self.bf, window,
                  n_iters=self.cfg.mapping.local_ba_iters, abort_check=self.abort_check,
                  hold=hold, device=self.device, dtype=self.dtype)


def window_ba(m: SlamMap, camera, camspec, inv_sigma2, bf, window, n_iters: int = 15,
              abort_check=None, fixed_kfs=None, hold=_no_lock, device=DEFAULT_DEVICE,
              dtype=torch.float32):
    """Local BA over an explicit keyframe window (the core of
    Optimizer::LocalBundleAdjustment, Optimizer.cc:1699): optimizes
    `window` poses + the points they see; other observers form the fixed
    frontier; 5-iteration robust phase, chi2 prune, then `n_iters` more;
    outlier observations erased afterwards.

    abort_check: polled between the two LM phases (the reference's
    mbAbortBA, LocalMapping.cc:103,283). fixed_kfs: KFs held fixed beyond
    the frontier. hold: lock-context factory — assembly and write-back run
    under the map lock, the LM solves on the snapshot without it."""
    device = resolve_device(device)
    cam = camera
    fixed_kfs = set(int(k) for k in (fixed_kfs or ()))
    with hold():
        snap = _window_ba_assemble(m, inv_sigma2, window, fixed_kfs)
    if snap is None:
        return
    (window, kf_list, kf_index, fixed, pts, obs_kf, obs_pt, uvr, inv_s2,
     stereo, obs_j, obs_okf, R0s, t0s, X0s) = snap
    chi2_th = np.where(stereo, 7.815, 5.991)
    solve = dict(cam=camspec, device=device, dtype=dtype)
    # phase 1 (5 it robust), prune, phase 2 (ref :2048,:2121)
    Rf, tf, Xf, chi2, posz = B.ba_solve_np(
        R0s, t0s, X0s, obs_kf, obs_pt, uvr, inv_s2, stereo, np.ones(len(obs_kf), bool),
        fixed, cam.fx, cam.fy, cam.cx, cam.cy, bf, n_iters=5, **solve)
    good = (chi2 <= chi2_th) & posz
    if abort_check is None or not abort_check():
        Rf, tf, Xf, chi2, posz = B.ba_solve_np(
            Rf, tf, Xf, obs_kf, obs_pt, uvr, inv_s2, stereo, good,
            fixed, cam.fx, cam.fy, cam.cx, cam.cy, bf, n_iters=n_iters, **solve)
    with hold():
        # write back (staleness-guarded: culled KFs/points are skipped)
        for i in np.nonzero(~fixed)[0]:
            if m.kf_valid[kf_list[i]]:
                m.kf_R[kf_list[i]] = Rf[i]
                m.kf_t[kf_list[i]] = tf[i]
        live = m.mp_valid[pts]
        m.mp_pos[pts[live]] = Xf[live]
        # erase observations that remain outliers (ref :2259-2290)
        bad = (chi2 > chi2_th) | ~posz
        for o in np.nonzero(bad)[0]:
            j, okf = int(obs_j[o]), int(obs_okf[o])
            if m.mp_valid[j]:
                m.erase_observation(j, okf)
        m.update_point_stats_batch(pts)
        # the map changed: the tracker's cached local-map tensors rebuild
        m.map_version += 1


def _window_ba_assemble(m, inv_sigma2, window, fixed_kfs):
    window = sorted(set(int(k) for k in window) - fixed_kfs)
    window = [k for k in window if m.kf_valid[k]]
    wset = set(window)
    pts = np.unique(m.kf_mp[window]) if window else np.zeros(0, int)
    pts = pts[pts >= 0]
    pts = pts[m.mp_valid[pts]]
    if len(pts) < 10 or len(window) < 2:
        return None
    frontier = set(k for k in fixed_kfs if m.kf_valid[k])
    for j in pts:
        for okf in m.mp_obs[int(j)]:
            if okf not in wset:
                frontier.add(okf)
    kf_list = window + sorted(frontier)
    kf_index = {k: i for i, k in enumerate(kf_list)}
    fixed = np.zeros(len(kf_list), bool)
    fixed[len(window):] = True
    if len(frontier) == 0:
        # gauge: fix ONLY the oldest KF (ref: LocalBundleAdjustment fixes
        # the map-origin KF, Optimizer.cc:1797)
        fixed[kf_index[min(window)]] = True
    # per-KF observation assembly (one numpy pass per keyframe row)
    pt_row = np.full(int(pts.max()) + 1, -1, np.int32)
    pt_row[pts] = np.arange(len(pts), dtype=np.int32)
    obs_kf_l, obs_pt_l, uvr_l, is2_l, st_l, oj_l, okf_l = [], [], [], [], [], [], []
    for k in kf_list:
        row = m.kf_mp[k]
        slots = np.nonzero((row >= 0) & (row <= pts.max()))[0]
        rows = pt_row[row[slots]]
        ok = rows >= 0
        slots, rows = slots[ok], rows[ok]
        if len(slots) == 0:
            continue
        f = m.kf_feats[k]
        ur = f.u_right[slots] if f.u_right is not None else np.full(len(slots), -1.0)
        obs_kf_l.append(np.full(len(slots), kf_index[k], np.int32))
        obs_pt_l.append(rows)
        uvr_l.append(np.concatenate([f.und_xy[slots], np.where(ur >= 0, ur, 0.0)[:, None]], 1))
        is2_l.append(inv_sigma2[f.octave[slots]])
        st_l.append(ur >= 0)
        oj_l.append(row[slots])
        okf_l.append(np.full(len(slots), k, np.int64))
    if not obs_kf_l:
        return None
    return (window, kf_list, kf_index, fixed, pts, np.concatenate(obs_kf_l),
            np.concatenate(obs_pt_l), np.concatenate(uvr_l), np.concatenate(is2_l),
            np.concatenate(st_l), np.concatenate(oj_l), np.concatenate(okf_l),
            m.kf_R[kf_list].copy(), m.kf_t[kf_list].copy(), m.mp_pos[pts].copy())
