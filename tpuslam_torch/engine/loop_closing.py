"""Loop closing: place recognition -> Sim3 verification -> correction
(port of tpuslam/engine/loop_closing.py, visual maps).

The reference's LoopClosing thread (src/LoopClosing.cc): candidates from
the BoW database (NewDetectCommonRegions :263, DetectCommonRegionsFromBoW
:557), temporal consistency over consecutive keyframes, loop correction
and the visual Atlas merge (CorrectLoop :1013, MergeLocal :1252: Sim3
propagation over the covisible window, point correction, fusion, the
essential graph, the weld-window BA) and global BA on a background thread
with staged corrections (RunGlobalBundleAdjustment :2430).

The engine is synchronous per keyframe; the numerics (Sim3 RANSAC and
refinement, the essential graph, BA) run on the closer's device in its
dtype, the bookkeeping on the host map. The Sim3 RANSAC draws come from
one explicit torch.Generator (seed 7, as tpuslam's PRNGKey(7)), advanced
per try.

One fault of tpuslam's GBA apply is repaired: a point created during the
solve whose first keyframe was culled in the meantime rides the
correction of another surviving observer (tpuslam leaves it at its stale
position). On an IMU-initialized map the closer runs tpuslam's inertial
parts: the merge gates (scale within [0.9, 1.1] after VIBA1, the rotation
projected onto yaw), the 4-DoF essential graph, the visual-inertial weld
BA of a merge, and the FullInertialBA as the background GBA, which stages
velocities and biases with the poses. Three faults of tpuslam's inertial
merge are repaired: an inertial map merges only once its own IMU is
initialized (tpuslam merges it, then re-initializes the IMU over both
sessions); the yaw projection acts on the merge's world correction, about
gravity, and holds through the candidate's refinement (tpuslam projects
the camera-to-camera rotation onto the optical axis); the essential graph
of a fixed-scale merge measures the seam's edges in one frame (tpuslam's
pull the young map back). In a process group of more than one rank, a
large GBA (visual or inertial) is the obs-sharded distributed solve of
parallel/dist_ba.py, driven from rank 0.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..map.store import SlamMap
from ..ops import match as M
from ..parallel import dist_ba
from ..place import BinaryVocabulary, KeyFrameDatabase
from ..solve import ba as B
from ..solve.pose_graph import optimize_essential_graph
from ..solve.sim3 import optimize_sim3, sim3_ransac
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.timing import GLOBAL_TIMER as T
from .config import SlamConfig
from .inertial import _window_viba_assemble, solve_window_snapshot, window_inertial_ba
from .local_mapping import window_ba


class LoopCloser:
    def __init__(self, camera, cfg: SlamConfig, slam_map: SlamMap, vocab: BinaryVocabulary,
                 fix_scale: bool = False, local_mapper=None,
                 device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        """device: where BoW descent, matching and the solvers run; dtype:
        the solvers' float type (f32 on the card)."""
        self.camera = camera
        self.cfg = cfg
        self.map = slam_map
        self.vocab = vocab
        self.db = KeyFrameDatabase(vocab)
        self.fix_scale = fix_scale
        self.local_mapper = local_mapper
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kf_nodes: dict[int, np.ndarray] = {}
        self.kf_bow: dict[int, dict] = {}
        self.loop_edges: list = []      # [(ka, kb, (s, R, t))]
        self.n_loops_closed = 0
        # confirmed merges not made because the young inertial map had not
        # initialized its IMU: [(current kf, candidate kf)]
        self.merges_aborted: list = []
        # temporal-consistency state (ref LoopClosing.cc:263-500): one
        # pending common-region candidate, confirmed across consecutive KFs
        # before any correction. Keys: cand, last_kf, sim3 (s, R, t:
        # X_last_kf = S X_cand), count, not_found, merge, match_pairs.
        self.pending: dict | None = None
        self.sf = slam_map.scale_factors
        self.inv_sigma2 = 1.0 / self.sf ** 2
        self.generator = torch.Generator().manual_seed(7)
        # background GBA (the reference's transient thread, :1237-1244):
        # each run carries its OWN abort event, so a newer loop aborts the
        # old run without joining it under the map lock
        self._gba_thread = None
        self._gba_abort_evt = None

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    def _match(self, *args, **kw):
        return M.match_padded(*args, device=self.device, **kw)

    # ------------------------------------------------------------------ main
    def on_new_keyframe(self, kf: int) -> bool:
        """Returns True if a loop was closed (map rewritten). Timed as stage
        "loop" (the correction inside it as "loop.correct")."""
        with T.stage("loop"):
            return self._on_new_keyframe(kf)

    def _on_new_keyframe(self, kf: int) -> bool:
        m = self.map
        f = m.kf_feats[kf]
        word, node, bow = self.vocab.transform(f.bits, f.valid, device=self.device)
        self.kf_nodes[kf] = node
        self.kf_bow[kf] = bow
        closed = False
        lcfg = self.cfg.loop
        # 1) pending candidate: re-confirm on this KF (ref
        #    NewDetectCommonRegions :302-429 -> DetectAndReffineSim3FromLastKF)
        if self.pending is not None and not m.kf_valid[self.pending["cand"]]:
            self.pending = None
        if self.pending is not None:
            if self._refine_pending(kf):
                self.pending["count"] += 1
                self.pending["not_found"] = 0
            else:
                self.pending["not_found"] += 1
                if self.pending["not_found"] >= lcfg.max_not_found:
                    # chain broken: fresh detection below still runs
                    self.pending = None
        if self.pending is None:
            # 2) fresh detection (ref :276-295: same-map loops need a
            #    mature map; merges with other Atlas maps are allowed earlier)
            cur_map = int(m.kf_map_id[kf])
            n_cur = len(m.valid_kf_ids())
            exclude = {kf} | set(m.best_covisible(kf))
            cands = self.db.detect_candidates(bow, lambda k: m.best_covisible(k, 10), exclude,
                                              n_best=lcfg.n_candidates)
            for cand, _score in cands:
                if not m.kf_valid[cand]:
                    continue
                merge = int(m.kf_map_id[cand]) != cur_map
                if not merge and n_cur < lcfg.min_kfs:
                    continue
                det = self._try_loop(kf, cand, merge=merge)
                if det is not None:
                    self.pending = dict(cand=cand, last_kf=kf, sim3=det["sim3"], count=1,
                                        not_found=0, merge=merge,
                                        match_pairs=det["match_pairs"])
                    break
        # 3) enough consecutive confirmations -> correct
        if self.pending is not None and self.pending["count"] >= lcfg.consecutive_kfs:
            p = self.pending
            self.pending = None
            if p["merge"] and self._imu_calib() is not None and not m.imu_initialized:
                # an inertial map merges only once its own IMU is initialized
                # (ref LoopClosing::Run: "IMU is not initilized, merge is
                # aborted"); tpuslam merges it, and its IMU stage then re-runs
                # the IMU init over both sessions' keyframes
                self.merges_aborted.append((p["last_kf"], p["cand"]))
            else:
                s, R, t = p["sim3"]
                with T.stage("loop.correct"):
                    self._correct_loop(p["last_kf"], p["cand"], s, R, t, p["match_pairs"],
                                       merge=p["merge"])
                closed = True
        self.db.add(kf, word, bow)
        return closed

    def _refine_pending(self, kf: int) -> bool:
        """Confirm the pending region on a new KF: propagate the stored Sim3
        by the relative motion last_kf -> kf, re-project the loop side's
        local map and refine (ref DetectAndReffineSim3FromLastKF :502)."""
        m = self.map
        p = self.pending
        last, cand = p["last_kf"], p["cand"]
        if not m.kf_valid[last]:
            return False
        s, R, t = p["sim3"]
        Rkl = m.kf_R[kf] @ m.kf_R[last].T
        tkl = m.kf_t[kf] - Rkl @ m.kf_t[last]
        R2 = Rkl @ R
        t2 = Rkl @ t + tkl
        n_proj, pairs = self._search_by_projection(kf, cand, s, R2, t2)
        if n_proj < self.cfg.loop.min_refine_matches:
            return False
        ref = self._refine_sim3(kf, cand, s, R2, t2, pairs)
        if ref is not None:
            s, R2, t2 = ref
            if p["merge"] and self.map.imu_initialized:
                # the refinement frees the rotation again: the merge applies
                # the yaw-only Sim3 (ref LoopClosing::Run projects the final
                # Sim3 just before MergeLocal2)
                R2, t2, _ = self._yaw_only(kf, cand, s, R2, t2)
        p["sim3"] = (s, R2, t2)
        p["last_kf"] = kf
        p["match_pairs"] = pairs
        return True

    def _refine_sim3(self, kf: int, cand: int, s, R, t, pairs):
        """optimize_sim3 over matched (cur_mp, loop_mp) pairs; None if too
        few usable pairs."""
        m = self.map
        cam = self.camera
        usable = [(a, b) for a, b in pairs
                  if m.mp_valid[a] and m.mp_valid[b]
                  and kf in m.mp_obs[a] and cand in m.mp_obs[b]]
        if len(usable) < 10:
            return None
        mp_c = np.array([a for a, _ in usable])
        mp_l = np.array([b for _, b in usable])
        slot_c = np.array([m.mp_obs[int(a)][kf] for a in mp_c])
        slot_l = np.array([m.mp_obs[int(b)][cand] for b in mp_l])
        Xc = m.mp_pos[mp_c] @ m.kf_R[kf].T + m.kf_t[kf]
        Xl = m.mp_pos[mp_l] @ m.kf_R[cand].T + m.kf_t[cand]
        fc, fl = m.kf_feats[kf], m.kf_feats[cand]
        T = self._t
        s2, R2, t2, _, n_inl = optimize_sim3(
            T(s), T(R), T(t), T(Xl), T(Xc), torch.ones(len(mp_c), dtype=torch.bool,
                                                       device=self.device),
            T(fl.und_xy[slot_l]), T(fc.und_xy[slot_c]),
            T(self.inv_sigma2[fl.octave[slot_l]]), T(self.inv_sigma2[fc.octave[slot_c]]),
            cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=self.fix_scale, cam=cam.spec)
        if int(n_inl) < 10:
            return None
        return float(s2), R2.cpu().numpy().astype(np.float64), t2.cpu().numpy().astype(np.float64)

    def on_kf_erased(self, kf: int):
        """Culling hook: drop the KF from the inverted index (ref
        KeyFrame::SetBadFlag -> KeyFrameDatabase::erase)."""
        self.db.erase(kf)
        self.kf_nodes.pop(kf, None)
        self.kf_bow.pop(kf, None)

    # ------------------------------------------------------------ detection
    def _match_bow(self, kf_a: int, kf_b: int):
        """Node-gated descriptor matching between the map-point-bearing
        features of two KFs (ref ORBmatcher::SearchByBoW KF-KF :827)."""
        m = self.map
        fa, fb = m.kf_feats[kf_a], m.kf_feats[kf_b]
        na = self.kf_nodes.get(kf_a)
        nb = self.kf_nodes.get(kf_b)
        mask = ((m.kf_mp[kf_a] >= 0) & fa.valid)[:, None] & ((m.kf_mp[kf_b] >= 0) & fb.valid)[None, :]
        if na is not None and nb is not None:
            mask = mask & (na[:, None] == nb[None, :])
        midx, _ = self._match(fa.bits, fb.bits, mask, max_dist=M.TH_LOW,
                              nn_ratio=self.cfg.loop.nn_ratio, ang_a=fa.angle, ang_b=fb.angle)
        ia = np.nonzero(midx >= 0)[0]
        return ia, midx[ia]

    def _try_loop(self, kf: int, cand: int, merge: bool = False):
        """BoW + Sim3 RANSAC + guided projection detection of a common
        region (ref DetectCommonRegionsFromBoW :557). Returns dict(sim3,
        match_pairs) or None; the caller counts the temporal consistency."""
        m = self.map
        lcfg = self.cfg.loop
        ia, ib = self._match_bow(kf, cand)
        if len(ia) < lcfg.min_bow_matches:
            return None
        mp_c = m.kf_mp[kf, ia]
        mp_l = m.kf_mp[cand, ib]
        ok = (mp_c >= 0) & (mp_l >= 0) & m.mp_valid[mp_c] & m.mp_valid[mp_l]
        ia, ib, mp_c, mp_l = ia[ok], ib[ok], mp_c[ok], mp_l[ok]
        if len(ia) < lcfg.min_bow_matches:
            return None
        Xc = m.mp_pos[mp_c] @ m.kf_R[kf].T + m.kf_t[kf]
        Xl = m.mp_pos[mp_l] @ m.kf_R[cand].T + m.kf_t[cand]
        fc, fl = m.kf_feats[kf], m.kf_feats[cand]
        cam = self.camera
        T = self._t
        args = (T(Xl), T(Xc), torch.ones(len(ia), dtype=torch.bool, device=self.device),
                T(fl.und_xy[ib]), T(fc.und_xy[ia]),
                T(self.inv_sigma2[fl.octave[ib]]), T(self.inv_sigma2[fc.octave[ia]]),
                cam.fx, cam.fy, cam.cx, cam.cy)
        # S: X_kf = S X_cand (current <- loop)
        out = sim3_ransac(*args, generator=self.generator, n_hyp=lcfg.ransac_hypotheses,
                          fix_scale=self.fix_scale, cam=cam.spec)
        if int(out["n_inliers"]) < lcfg.min_ransac_inliers:
            return None
        s, R, t, inl, n_inl = optimize_sim3(out["s"], out["R"], out["t"], *args,
                                            fix_scale=self.fix_scale, cam=cam.spec)
        if int(n_inl) < lcfg.min_sim3_inliers:
            return None
        s = float(s)
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy().astype(np.float64)
        if merge and m.imu_initialized:
            # inertial merge gates (ref LoopClosing.cc:95-114): gravity pins
            # pitch / roll and, once VIBA1 ran, the scale is metric — reject a
            # Sim3 scale outside [0.9, 1.1] and project the merge's world
            # correction onto yaw (MergeLocal2's 4-DoF alignment)
            if m.inertial_ba1 and not (0.9 < s < 1.1):
                return None
            R, t, removed = self._yaw_only(kf, cand, s, R, t)
            if removed > 0.35:
                return None  # the Sim3 disagrees badly with gravity: no merge
        # guided projection: the loop side's local map into the current KF
        n_proj, proj_pairs = self._search_by_projection(kf, cand, s, R, t)
        if n_proj < lcfg.min_proj_matches:
            return None
        inl = inl.cpu().numpy()
        return dict(sim3=(s, R, t), match_pairs=list(zip(mp_c[inl], mp_l[inl])) + proj_pairs)

    def _yaw_only(self, kf: int, cand: int, s, R, t):
        """The merge Sim3 (X_kf = s R X_cand + t, camera to camera) with the
        world correction it implies, W = R_cand^T R^T R_kf (young map's
        world to the merge map's), projected onto a rotation about gravity
        (world z), the current keyframe's corrected camera centre kept.
        Returns (R, t, the rotation removed from W in rad). tpuslam projects
        R itself onto the current camera's optical axis, which is not the
        vertical: on a gravity-aligned pair of maps that removes the true
        heading difference of the two views and leaves a tilt."""
        m = self.map
        Rk, Rc, tc = m.kf_R[kf], m.kf_R[cand], m.kf_t[cand]
        W = Rc.T @ R.T @ Rk
        yaw = np.arctan2(W[1, 0] - W[0, 1], W[0, 0] + W[1, 1])
        W_yaw = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                          [0.0, 0.0, 1.0]])
        removed = float(np.arccos(np.clip((np.trace(W_yaw.T @ W) - 1) / 2, -1, 1)))
        R_cw = R @ Rc
        centre = -R_cw.T @ (s * (R @ tc) + t) / s    # the corrected kf camera centre
        R_yaw = Rk @ W_yaw.T @ Rc.T
        return R_yaw, -s * (Rk @ W_yaw.T @ centre) - s * (R_yaw @ tc), removed

    def _search_by_projection(self, kf: int, cand: int, s, R, t):
        """Project the loop side's local map into the current KF through the
        candidate Sim3 (ref SearchByProjection, Sim3 variant,
        ORBmatcher.cc:2183). Returns (n_matches, [(mp_cur, mp_loop)])."""
        m = self.map
        cam = self.camera
        window = [cand] + m.best_covisible(cand, 10)
        pts = np.unique(m.kf_mp[window])
        pts = pts[pts >= 0]
        pts = pts[m.mp_valid[pts]]
        if len(pts) == 0:
            return 0, []
        Xl = m.mp_pos[pts] @ m.kf_R[cand].T + m.kf_t[cand]
        Xc = s * Xl @ R.T + t
        z = Xc[:, 2]
        uv = cam.project_np(Xc)
        in_img = ((z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        pts, uv = pts[in_img], uv[in_img]
        if len(pts) == 0:
            return 0, []
        f = m.kf_feats[kf]
        pred = m.predict_scale(np.linalg.norm(Xc[in_img], axis=1), pts)
        mask = (M.window_mask_np(uv, f.xy, self.cfg.loop.proj_radius * self.sf[pred])
                & f.valid[None, :])
        midx, _ = self._match(m.mp_bits[pts], f.bits, mask, max_dist=M.TH_HIGH)
        ok = midx >= 0
        pairs = []
        for a in np.nonzero(ok)[0]:
            cur_mp = int(m.kf_mp[kf, midx[a]])
            if cur_mp >= 0 and m.mp_valid[cur_mp]:
                pairs.append((cur_mp, int(pts[a])))
        return int(ok.sum()), pairs

    # ------------------------------------------------------------ correction
    @staticmethod
    def _ride_points(m, pt_ids, anchor_rows, R_old, t_old, R_new, t_new, s_new):
        """Batched anchor ride: every point moves with its anchor KF's
        correction, X' = (1/s_a) R_a_new^T (R_a_old X + t_a_old - t_a_new);
        anchor_rows index the stacked per-anchor arrays."""
        if len(pt_ids) == 0:
            return
        Ro, to = R_old[anchor_rows], t_old[anchor_rows]
        Rn, tn, sn = R_new[anchor_rows], t_new[anchor_rows], s_new[anchor_rows]
        Xc = np.einsum("pij,pj->pi", Ro, m.mp_pos[pt_ids]) + to
        m.mp_pos[pt_ids] = np.einsum("pji,pj->pi", Rn, Xc - tn) / sn[:, None]

    def _seam_poses(self, old_side, kf: int, kf_old_pose, S_kf):
        """The merge map's keyframes posed in the young map's frame and
        scale before the transport, {kf: (s, R, t)}. The essential graph
        measures every edge between the poses from before the correction;
        across the seam the young keyframe's pose is in the young map's
        frame and the old keyframe's in the merge map's, so without these
        the seam's covisibility edges pull the young map back to where it
        was (tpuslam measures them so). The transport moved every young
        keyframe by one similarity: S_k = T_k_old G^-1 with G^-1 =
        T_kf_old^-1 S_kf, S_kf the current keyframe's corrected Scw; an old
        keyframe's pose in the young frame is T_a G = T_a S_kf^-1 T_kf_old,
        whose scale is 1/s of S_kf (1 on a fixed-scale map: stereo, RGB-D,
        inertial)."""
        m = self.map
        Ro, to = kf_old_pose
        s, Rn, tn = S_kf
        sg, Rg, tg = 1.0 / s, Rn.T @ Ro, Rn.T @ (to - tn) / s     # G = S_kf^-1 T_kf_old
        return {a: (sg, m.kf_R[a] @ Rg, m.kf_R[a] @ tg + m.kf_t[a]) for a in old_side}

    def _correct_loop(self, kf: int, cand: int, s, R, t, match_pairs, merge: bool = False):
        """ref CorrectLoop (:1013); with merge=True the visual Atlas merge
        (MergeLocal :1252): the weld window (current KF + covisibles) gets
        the exact corrected Sim3 and seeds the essential graph; the rest of
        the young map is transported by the same relative-pose formula as a
        seed; point motion is batched per anchor."""
        m = self.map
        # corrected Scw of the current KF: S_c<-l o T_lw
        s_cw = s
        R_cw = R @ m.kf_R[cand]
        t_cw = s * (m.kf_t[cand] @ R.T) + t
        window = [kf] + m.best_covisible(kf)
        if merge:
            young = [int(x) for x in m.valid_kf_ids(map_id=int(m.kf_map_id[kf]))]
            wset = set(window)
            transported = window + [k for k in young if k not in wset]
        else:
            transported = window
        old_pose = {k: (m.kf_R[k].copy(), m.kf_t[k].copy()) for k in transported}
        # per-KF corrected Sim3: S_kw = T_kc o S_cw, from the drifted poses
        Rc, tc = m.kf_R[kf], m.kf_t[kf]
        t_idx = np.asarray(transported, np.int64)
        Rkc = np.einsum("kij,jl->kil", m.kf_R[t_idx], Rc.T)
        tkc = m.kf_t[t_idx] - np.einsum("kij,j->ki", Rkc, tc)
        R_corr = np.einsum("kij,jl->kil", Rkc, R_cw)
        t_corr = np.einsum("kij,j->ki", Rkc, t_cw) + tkc
        s_corr = np.full(len(transported), s_cw)
        corrected = {k: (s_corr[i], R_corr[i], t_corr[i]) for i, k in enumerate(window)}
        # every point of the transported set rides its anchor (the first KF
        # of `transported` that sees it)
        seen = np.zeros(m.n_mp, bool)
        pt_chunks, anch_chunks = [], []
        for i, k in enumerate(transported):
            mps = np.unique(m.kf_mp[k])
            mps = mps[mps >= 0]
            mps = mps[m.mp_valid[mps] & ~seen[mps]]
            seen[mps] = True
            pt_chunks.append(mps.astype(np.int64))
            anch_chunks.append(np.full(len(mps), i))
        done = np.concatenate(pt_chunks) if pt_chunks else np.zeros(0, np.int64)
        self._ride_points(
            m, done, np.concatenate(anch_chunks) if anch_chunks else np.zeros(0, int),
            np.stack([old_pose[k][0] for k in transported]),
            np.stack([old_pose[k][1] for k in transported]), R_corr, t_corr, s_corr)
        # corrected poses [R | t/s]; world velocities ride the correction
        # (ref CorrectLoop Rcor * Vw :1127)
        for i, k in enumerate(transported):
            Ro, _ = old_pose[k]
            m.kf_R[k] = R_corr[i]
            m.kf_t[k] = t_corr[i] / s_corr[i]
            m.kf_vel[k] = (R_corr[i].T @ Ro @ m.kf_vel[k]) / s_corr[i]
        # fuse matched duplicates: the loop point replaces the current (:1156)
        for cur_mp, loop_mp in match_pairs:
            cur_mp = m.resolve_replaced(int(cur_mp))
            loop_mp = m.resolve_replaced(int(loop_mp))
            if (cur_mp != loop_mp and cur_mp >= 0 and loop_mp >= 0
                    and m.mp_valid[cur_mp] and m.mp_valid[loop_mp]):
                m.replace_point(cur_mp, loop_mp)
        # fuse the loop side's points into the corrected weld window (ref
        # SearchAndFuse :1676)
        weld_cur = [kf] + m.best_covisible(kf, 10)
        weld_loop = [cand] + m.best_covisible(cand, 10)
        if self.local_mapper is not None:
            loop_pts = np.unique(m.kf_mp[weld_loop])
            loop_pts = loop_pts[loop_pts >= 0]
            for k in weld_cur:
                self.local_mapper._fuse_into(k, loop_pts)
        for k in (weld_cur if merge else window):
            m.update_connections(k)
        old_side = []
        if merge:
            # the merge map's frame is kept: its KFs are the fixed side of
            # the graph and the weld BA (ref MergeLocal vpFixedKFs)
            old_side = [int(x) for x in m.valid_kf_ids(map_id=int(m.kf_map_id[cand]))]
            m.relabel_map(int(m.kf_map_id[kf]), int(m.kf_map_id[cand]))
        if merge:
            old_pose.update(self._seam_poses(old_side, kf, old_pose[kf], corrected[kf]))
        # the essential graph with the new loop edge (S_kf<-cand)
        self.loop_edges.append((cand, kf, (s, R, t)))
        pre_R = {int(k): m.kf_R[k].copy() for k in m.valid_kf_ids()}
        pre_t = {int(k): m.kf_t[k].copy() for k in m.valid_kf_ids()}
        out = optimize_essential_graph(
            m, list(self.loop_edges), corrected, fix_kf=cand, fix_scale=self.fix_scale,
            min_covis_weight=self.cfg.loop.essential_min_weight, old_poses=old_pose,
            four_dof=m.imu_initialized, fix_kfs=old_side, device=self.device,
            dtype=self.dtype)
        # the remaining points ride their anchor KF's graph correction; the
        # rare anchor-not-in-graph points take their first observer
        rem_mask = m.mp_valid[: m.n_mp].copy()
        rem_mask[done] = False
        rem = np.nonzero(rem_mask)[0].astype(np.int64)
        if len(rem):
            n_kf = m.n_kf
            have = np.zeros(n_kf, bool)
            sG = np.ones(n_kf)
            RG = np.broadcast_to(np.eye(3), (n_kf, 3, 3)).copy()
            tG = np.zeros((n_kf, 3))
            RO = RG.copy()
            tO = tG.copy()
            for k, (s_n, R_n, t_n) in out.items():
                if 0 <= k < n_kf and k in pre_R:
                    have[k] = True
                    sG[k], RG[k], tG[k] = s_n, R_n, t_n
                    RO[k], tO[k] = pre_R[k], pre_t[k]
            anchors = m.mp_first_kf[rem]
            ok = (anchors >= 0) & have[np.maximum(anchors, 0)]
            self._ride_points(m, rem[ok], anchors[ok], RO, tO, RG, tG, sG)
            for j in rem[~ok]:
                j = int(j)
                if not m.mp_obs[j]:
                    continue
                anchor = next(iter(m.mp_obs[j]))
                if anchor not in out:
                    continue
                s_n, R_n, t_n = out[anchor]
                Xc_old = pre_R[anchor] @ m.mp_pos[j] + pre_t[anchor]
                m.mp_pos[j] = (1.0 / s_n) * (R_n.T @ (Xc_old - t_n))
        m.update_point_stats_batch(m.valid_mp_ids())
        if merge:
            # weld-area local BA last: both sides of the seam move, the
            # frontier is fixed (ref MergeLocal -> LocalBundleAdjustment,
            # LoopClosing.cc:1676-1722)
            calib = self._imu_calib()
            if m.imu_initialized and calib is not None:
                # inertial maps weld with the visual-inertial window BA so the
                # seam respects the preintegration chain (MergeInertialBA, ref
                # Optimizer.cc:6912)
                opt = m.temporal_chain()[-10:]
                if len(opt) >= 2:
                    oset = set(opt)
                    window_inertial_ba(m, self.camera, calib, self.inv_sigma2, opt_kfs=opt,
                                       fixed_kfs=[k for k in weld_loop
                                                  if m.kf_valid[k] and k not in oset],
                                       n_iters=15, device=self.device, dtype=self.dtype)
            else:
                lm = self.local_mapper
                window_ba(m, self.camera, self.camera.spec, self.inv_sigma2,
                          lm.bf if lm is not None else 0.0, weld_cur, n_iters=15,
                          fixed_kfs=old_side, device=self.device, dtype=self.dtype)
        # global BA after the correction, on a background thread (ref
        # :1237-1244 spawns the GBA thread)
        if self.cfg.loop.run_gba:
            self._launch_gba(fix_kf=cand)
        # spanning-tree invariant (ref :1048-1050): logged, not raised
        errs = m.check_essential_graph()
        if errs:
            from ..utils.verbose import print_mess
            print_mess(f"essential-graph invariant violated after loop: {errs[:4]}")
        m.map_version += 1
        self.n_loops_closed += 1

    # ------------------------------------------------------- background GBA
    def _imu_calib(self):
        return getattr(self.local_mapper, "imu_calib", None)

    def _snapshot_gba(self, fix_kf: int):
        """The GBA problem, assembled from the map under the lock (one
        numpy pass per keyframe row). On an inertial map it is the
        FullInertialBA problem (ref RunGlobalBundleAdjustment routes to
        FullInertialBA(7 it) when the IMU is initialized,
        LoopClosing.cc:2437-2440)."""
        m = self.map
        calib = self._imu_calib()
        if m.imu_initialized and calib is not None:
            return self._snapshot_gba_vi(fix_kf, calib)
        kfs = np.asarray(m.valid_kf_ids(), np.int64)
        pts = np.unique(m.kf_mp[kfs])
        pts = pts[pts >= 0]
        pts = pts[m.mp_valid[pts]]
        if len(pts) < 20 or len(kfs) < 3:
            return None
        pt_row = np.full(int(pts.max()) + 1, -1, np.int32)
        pt_row[pts] = np.arange(len(pts), dtype=np.int32)
        obs_kf, obs_pt, uvr, inv_s2, stereo = [], [], [], [], []
        for i, k in enumerate(kfs):
            row = m.kf_mp[k]
            slots = np.nonzero(row >= 0)[0]
            rows = pt_row[np.minimum(row[slots], len(pt_row) - 1)]
            ok = (rows >= 0) & (row[slots] <= pts.max())
            slots, rows = slots[ok], rows[ok]
            if len(slots) == 0:
                continue
            f = m.kf_feats[k]
            ur = f.u_right[slots] if f.u_right is not None else np.full(len(slots), -1.0)
            obs_kf.append(np.full(len(slots), i, np.int32))
            obs_pt.append(rows)
            uvr.append(np.concatenate([f.und_xy[slots], np.where(ur >= 0, ur, 0.0)[:, None]], 1))
            stereo.append(ur >= 0)
            inv_s2.append(self.inv_sigma2[f.octave[slots]])
        if not obs_kf:
            return None
        fixed = np.zeros(len(kfs), bool)
        kf_index = {int(k): i for i, k in enumerate(kfs)}
        fixed[kf_index.get(int(fix_kf), 0)] = True
        lm = self.local_mapper
        return dict(
            abort=threading.Event(), kfs=kfs, pts=pts,
            R=m.kf_R[kfs].copy(), t=m.kf_t[kfs].copy(), X=m.mp_pos[pts].copy(),
            obs_kf=np.concatenate(obs_kf), obs_pt=np.concatenate(obs_pt),
            uvr=np.concatenate(uvr), inv_s2=np.concatenate(inv_s2),
            stereo=np.concatenate(stereo), fixed=fixed,
            bf=lm.bf if lm is not None else 0.0)

    def _snapshot_gba_vi(self, fix_kf: int, calib):
        """FullInertialBA snapshot: the temporal chain optimizes poses,
        velocities and biases, every other valid KF is the fixed visual
        frontier; the first chain KF's pose is fixed (ref FullInertialBA
        fixes the init KF, Optimizer.cc:446) and so is fix_kf (the loop /
        merge anchor)."""
        m = self.map
        chain = m.temporal_chain()
        if len(chain) < 3:
            return None
        others = sorted(set(int(k) for k in m.valid_kf_ids()) - set(chain))
        asm = _window_viba_assemble(m, self.camera, calib, self.inv_sigma2, opt_kfs=chain,
                                    fixed_kfs=others, fix_first=True, device=self.device)
        if asm is None:
            return None
        fixed = asm["fixed"].copy()
        if int(fix_kf) in asm["idx"]:
            fixed[asm["idx"][int(fix_kf)]] = True
        return dict(kind="vi", abort=threading.Event(), asm=asm, calib=calib,
                    kfs=np.asarray(chain + others, np.int64), pts=asm["pts"], fixed=fixed)

    def _solve_gba_vi(self, snap, n_iters: int = 7, chunks: int = 3):
        """Chunked FullInertialBA on the snapshot, without the map lock,
        abortable between chunks (ref FullInertialBA(7 it) + mbStopGBA).
        Returns (R, t, X, v, bg, ba) per snapshot KF / point, or None."""
        asm = dict(snap["asm"])
        calib = snap["calib"]
        per = max(1, n_iters // chunks)
        done = 0
        while done < n_iters:
            if snap["abort"].is_set():
                return None
            it = min(per, n_iters - done)
            Rwb, p, v, bg, ba, X, cost = solve_window_snapshot(
                asm, self.camera, calib, 0.0, 0.0, it, self.device, self.dtype,
                fixed=snap["fixed"])
            if not np.isfinite(cost):
                return None
            asm.update(Rwb=Rwb, p=p, v=v, bg=bg, ba=ba, X=X)
            done += it
        if snap["abort"].is_set():
            return None
        K = len(snap["kfs"])
        Rg, tg = np.zeros((K, 3, 3)), np.zeros((K, 3))
        for i in range(K):
            Rg[i], tg[i] = calib.cam_from_body(asm["Rwb"][i], asm["p"][i])
        return Rg, tg, asm["X"], asm["v"], asm["bg"], asm["ba"]

    def _solve_gba(self, snap, n_iters: int = 10, chunks: int = 3):
        """The solve on the snapshot WITHOUT the map lock, in chunks so an
        abort (a new loop or merge, shutdown) is honoured between chunks
        (ref mbStopGBA checks, LoopClosing.cc:2445-2450). In a group of more
        than one rank a large problem is the obs-sharded distributed solve:
        the engine's GBA is the distributed-BA serving path."""
        cam = self.camera
        R, t, X = snap["R"], snap["t"], snap["X"]
        O = len(snap["obs_kf"])
        per = max(1, n_iters // chunks)
        done = 0
        if dist_ba.route_open() and O >= self.cfg.loop.dist_gba_min_obs:
            while done < n_iters:
                if snap["abort"].is_set():
                    return None
                R, t, X, _ = dist_ba.dispatch(
                    "ba", R, t, X, snap["obs_kf"], snap["obs_pt"], snap["uvr"], snap["inv_s2"],
                    snap["stereo"], np.ones(O, bool), snap["fixed"], cam.fx, cam.fy, cam.cx,
                    cam.cy, snap["bf"], n_iters=min(per, n_iters - done), cam=cam.spec,
                    device=self.device, dtype=self.dtype)
                done += per
        else:
            while done < n_iters:
                if snap["abort"].is_set():
                    return None
                R, t, X, _, _ = B.ba_solve_np(
                    R, t, X, snap["obs_kf"], snap["obs_pt"], snap["uvr"], snap["inv_s2"],
                    snap["stereo"], np.ones(O, bool), snap["fixed"],
                    cam.fx, cam.fy, cam.cx, cam.cy, snap["bf"],
                    n_iters=min(per, n_iters - done), cam=cam.spec, device=self.device,
                    dtype=self.dtype)
                done += per
        if snap["abort"].is_set():
            return None
        return R, t, X

    def _apply_gba(self, snap, solved):
        """Stage the GBA result into the (possibly advanced) map: snapshot
        KFs and points take their solved values; KFs created during the
        solve are corrected through the spanning tree (ref mTcwGBA /
        mTcwBefGBA, :2476-2530); points created during the solve ride their
        anchor KF's correction, the first keyframe or, if that was culled
        meanwhile, another surviving observer."""
        m = self.map
        Rg, tg, Xg = solved[:3]
        vi = len(solved) > 3   # the FullInertialBA result: also v / bg / ba
        kfs, pts = snap["kfs"], snap["pts"]
        with m.lock:
            if snap["abort"].is_set():
                return  # aborted while waiting for the lock: discard
            in_snap = set(int(k) for k in kfs)
            before = {int(k): (m.kf_R[k].copy(), m.kf_t[k].copy()) for k in m.valid_kf_ids()}
            for i, k in enumerate(kfs):
                if m.kf_valid[k] and not snap["fixed"][i]:
                    m.kf_R[k] = Rg[i]
                    m.kf_t[k] = tg[i]
                    if vi:
                        # velocity / bias corrections stage with the poses
                        # (ref mVwbGBA / bias update, LoopClosing.cc:2476-2530)
                        m.kf_vel[k] = solved[3][i]
                        m.kf_bg[k] = solved[4][i]
                        m.kf_ba[k] = solved[5][i]
            # KFs created during GBA: walk to the first snapshot ancestor a;
            # P_child_new = P_child_old P_a_old^-1 P_a_new
            for k in m.valid_kf_ids():
                k = int(k)
                if k in in_snap:
                    continue
                a = k
                hops = 0
                while a >= 0 and a not in in_snap and hops < m.n_kf:
                    a = int(m.kf_parent[a])
                    hops += 1
                if a < 0 or a not in in_snap or not m.kf_valid[a]:
                    continue
                Ra_o, ta_o = before[a]
                Rrel = before[k][0] @ Ra_o.T
                trel = before[k][1] - Rrel @ ta_o
                m.kf_R[k] = Rrel @ m.kf_R[a]
                m.kf_t[k] = Rrel @ m.kf_t[a] + trel
                if vi:
                    # the world velocity rides the anchor's world correction
                    m.kf_vel[k] = m.kf_R[a].T @ Ra_o @ m.kf_vel[k]
            live = m.mp_valid[pts]
            m.mp_pos[pts[live]] = Xg[live]
            in_pts = np.zeros(m.n_mp, bool)
            in_pts[pts] = True
            rem = np.nonzero(m.mp_valid[: m.n_mp] & ~in_pts)[0].astype(np.int64)
            if len(rem):
                n_kf = m.n_kf
                have = np.zeros(n_kf, bool)
                RO = np.broadcast_to(np.eye(3), (n_kf, 3, 3)).copy()
                tO = np.zeros((n_kf, 3))
                RN = RO.copy()
                tN = tO.copy()
                for k, (Ro, to) in before.items():
                    if 0 <= k < n_kf and m.kf_valid[k]:
                        have[k] = True
                        RO[k], tO[k] = Ro, to
                        RN[k], tN[k] = m.kf_R[k], m.kf_t[k]
                anchors = m.mp_first_kf[rem].astype(np.int64)
                for r in np.nonzero(~((anchors >= 0) & have[np.maximum(anchors, 0)]))[0]:
                    # the first keyframe is gone: anchor at a surviving observer
                    for k in m.mp_obs[int(rem[r])]:
                        if 0 <= k < n_kf and have[k]:
                            anchors[r] = k
                            break
                ok = (anchors >= 0) & have[np.maximum(anchors, 0)]
                self._ride_points(m, rem[ok], anchors[ok], RO, tO, RN, tN, np.ones(n_kf))
            m.map_version += 1

    def _launch_gba(self, fix_kf: int, n_iters: int = 10):
        """Spawn (or replace) the background GBA thread; a newer loop aborts
        a running GBA by signalling its token, never by joining under the
        map lock (ref CorrectLoop stops a running GBA, :1028-1044)."""
        if self._gba_abort_evt is not None:
            self._gba_abort_evt.set()
        snap = self._snapshot_gba(fix_kf)
        if snap is None:
            return
        self._gba_abort_evt = snap["abort"]

        def run():
            with T.stage("gba.solve"):
                solved = (self._solve_gba_vi(snap) if snap.get("kind") == "vi"
                          else self._solve_gba(snap, n_iters=n_iters))
            if solved is not None:
                with T.stage("gba.apply"):
                    self._apply_gba(snap, solved)

        if self.cfg.loop.background_gba:
            self._gba_thread = threading.Thread(target=run, daemon=True)
            self._gba_thread.start()
        else:
            run()

    def wait_gba(self):
        """Join a running background GBA (tests, shutdown). Must not be
        called while holding the map lock."""
        if self._gba_thread is not None:
            self._gba_thread.join()

    def abort_gba(self):
        if self._gba_abort_evt is not None:
            self._gba_abort_evt.set()
        self.wait_gba()
