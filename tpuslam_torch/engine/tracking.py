"""Tracking engine: the per-frame state machine (port of
tpuslam/engine/tracking.py: mono, stereo, fisheye stereo, RGB-D, and
visual-inertial).

The reference Tracking (src/Tracking.cc:829 Track() and friends):
  - monocular initialization by two-view reconstruction (:1460, :1550)
    and stereo / RGB-D initialization from depth (:1351)
  - the fused on-device step (track_device.FusedTracker) in the OK state,
    mono or stereo, synchronous or pipelined, with the host path as its
    fallback; RGB-D and fisheye (KB8) stereo frames always take the host
    path, as in tpuslam
  - reference-KF / motion-model tracking (:1750, :1879)
  - local-map tracking (:1974) with frustum culling (:2358)
  - keyframe decision (:2089) and creation (:2228), with the loop
    closer's hook
  - relocalization: the reference-KF neighbourhood, then BoW candidates +
    PnP RANSAC when a vocabulary is wired (:2626)
  - RECENTLY_LOST / LOST handling (Tracking.h:101-109)

The state machine is host code over numpy; matching, the solvers and the
fused step run on the tracker's device. Every host pose solve goes
through `pose_optimize_best`, i.e. the pose-LM kernel on the card. The
random draws of the two-view and PnP RANSACs come from explicit
torch.Generators seeded as tpuslam seeds its PRNG keys (0 per init
attempt, the frame id per relocalization).

With an ImuCalib the tracker is visual-inertial (mono or stereo): raw
samples buffer between keyframes, each keyframe stores its
preintegration from the previous one, frames are IMU-predicted once the
map's IMU is initialized, and the pose solves become the pose-inertial
solve with its marginalization prior (solve/pose_inertial.py, in the
tracker's dtype). In the OK state an initialized mono-inertial frame runs
the fused visual step seeded at the IMU prediction, then one
pose-inertial solve on its associations; before IMU init, and whenever
the fused step cannot run, frames take the host path. tpuslam's guards
are kept: a bad-IMU flag or a backwards timestamp resets the active map,
a sensor gap over 1 s opens a new map or resets, and stereo-inertial
initialization waits for accelerometer excitation. Once the IMU is
initialized, a frame that fails tracking rides the IMU prediction, the
first failing one too (tpuslam logs that one's rejected visual pose).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..map.store import FrameFeatures, SlamMap
from ..ops import match as M
from ..ops import twoview as TV
from ..parallel.async_mapping import AsyncMapper
from ..solve import ba as B
from ..solve.pnp import pnp_ransac
from ..solve.pose_opt_dispatch import pose_optimize_best as pose_optimize
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.pad import pad_to
from ..utils.timing import GLOBAL_TIMER as T
from ..utils.verbose import print_mess
from .config import SlamConfig
from .frontend import Frontend
from .track_device import DeviceFeatures, FusedTracker

POSE_PAD = 256  # host pose solves pad their observations to a multiple of this


class State(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclass
class Frame:
    feats: FrameFeatures | DeviceFeatures | None
    time: float
    frame_id: int
    R: np.ndarray | None = None  # Tcw
    t: np.ndarray | None = None
    mp: np.ndarray | None = None  # [N] mp id per feature (-1 none)
    v: np.ndarray | None = None   # world velocity of the body (inertial)
    bg: np.ndarray | None = None  # per-frame bias estimates (inertial)
    ba: np.ndarray | None = None
    # (kf, Rcw, tcw): a keyframe's pose when this frame's pose was computed
    # against the map (Tracker._anchor, _reanchor)
    anchor: tuple | None = None

    def center(self):
        return -self.R.T @ self.t


class Tracker:
    def __init__(self, camera, cfg: SlamConfig, slam_map: SlamMap, local_mapper=None,
                 sensor: str = "stereo", bf: float = 0.0, loop_closer=None,
                 imu_calib=None, camera2=None, Tlr=None, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
        """sensor: "mono", or "stereo" for stereo and RGB-D frames (the
        frame's input decides). imu_calib: an ImuCalib makes the tracker
        visual-inertial. camera2/Tlr: the right camera of a fisheye (KB8)
        stereo rig and the left<-right extrinsic 4x4 (ref: Tracking ctor,
        Camera2.* + Tlr, src/Tracking.cc:95-134): stereo frames then go
        through the lapping-area matcher and two-ray triangulation instead
        of the rectified row-banded one. dtype: the float type of the
        two-view, initial-BA, PnP and pose-inertial solves (f32 on the
        card)."""
        if sensor not in ("mono", "stereo"):
            raise ValueError(f"sensor {sensor!r}: expected 'mono' or 'stereo'")
        self.camera = camera
        self.cfg = cfg
        self.map = slam_map
        self.bf = bf
        self.device = resolve_device(device)
        self.dtype = dtype
        self.frontend = Frontend(camera, cfg.orb, bf=bf, device=self.device)
        self.camera2 = camera2
        self.R_rl = self.t_rl = None
        if camera2 is not None:
            # Tlr maps right-camera coordinates into the left frame; the
            # triangulation takes its inverse Trl (right <- left)
            Tlr = np.asarray(Tlr if Tlr is not None else np.eye(4), np.float64)
            R_lr, t_lr = Tlr[:3, :3], Tlr[:3, 3]
            self.R_rl = R_lr.T
            self.t_rl = -R_lr.T @ t_lr
        # the solvers see left-camera observations only (right features are
        # consumed by the depth triangulation), so the left camera's spec
        # covers every solve
        self.camspec = camera.spec
        self.local_mapper = local_mapper
        self.loop_closer = loop_closer
        self.sensor = sensor
        self.state = State.NO_IMAGES_YET
        self.last_frame: Frame | None = None
        self.init_frame: Frame | None = None
        self.ref_kf = -1
        self.last_kf = -1
        self.frames_since_kf = 0
        self.frame_id = 0
        self.trajectory = []  # (time, Rcr, tcr, ref_kf, lost)
        self.n_inliers = 0
        self.sf = self.map.scale_factors
        self.inv_sigma2 = (1.0 / self.sf ** 2).astype(np.float64)
        self.lost_since = 0.0
        # inertial state (ref: Tracking's IMU members, Tracking.h)
        self.imu_calib = imu_calib
        self.use_imu = imu_calib is not None
        self.imu_since_kf: list = []   # raw samples [t, w, a] since the last KF
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.map_version_seen = 0
        # marginalization prior of VI frame tracking (ref Frame::mpcpi
        # ConstraintPoseImu; None: anchor at the last KF)
        self.prior: dict | None = None
        self._pre_frame = None  # preintegration last frame -> current frame
        # localization-only mode (ref: mbOnlyTracking): track against the
        # frozen map, no KF insertion
        self.only_tracking = False
        # ref: Tracking::mbVO — in localization mode, true when the frame
        # tracks mostly temporary visual-odometry points
        self.vo_mode = False
        # set by System.change_dataset: the next frame opens a new map
        self._force_new_map = False
        # fused on-device tracking: one dispatch + one fetch per frame in
        # the OK state; init, relocalization and fallbacks use the host path
        self.fused_enabled = True
        self._fused = None
        # pipelined fused tracking: the in-flight (frame, device out,
        # min_req), completed when the NEXT frame is dispatched
        self._pending = None
        self._last_completed = None

    # ------------------------------------------------------------------ util
    def _project(self, R, t, X):
        Xc = X @ R.T + t
        uv = self.camera.project_np(Xc)
        return uv, Xc[:, 2], Xc

    def _match(self, *args, **kw):
        return M.match_padded(*args, device=self.device, **kw)

    def _pose_opt(self, R0, t0, frame: Frame, mp_ids, X_by_feat=None, valid_by_feat=None):
        """Motion-only optimization over the frame's current matches, on
        the tracker's device in f32 (the pose-LM kernel on the card).
        Observations are padded with invalid rows to a multiple of
        POSE_PAD. Stereo features (u_right >= 0) contribute 3-dim residuals
        (ref: PoseOptimization stereo edges Optimizer.cc:975).

        X_by_feat/valid_by_feat: per-feature 3D positions + mask overriding
        the map lookup (temporary visual-odometry points, localization
        mode)."""
        sel = np.nonzero(valid_by_feat if valid_by_feat is not None else mp_ids >= 0)[0]
        n = len(sel)
        if n < 3:
            return R0, t0, np.zeros(0, bool), sel
        nb = -(-n // POSE_PAD) * POSE_PAD
        X = X_by_feat[sel] if X_by_feat is not None else self.map.mp_pos[mp_ids[sel]]
        f = frame.feats
        und = f.und_xy[sel]
        if f.u_right is not None:
            ur = f.u_right[sel]
            stereo = ur >= 0
        else:
            ur = np.zeros(n)
            stereo = np.zeros(n, bool)
        valid = np.zeros(nb, bool)
        valid[:n] = True
        dev = self.device

        def up(a, dtype=np.float32):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        Rf, tf, inl, _ = pose_optimize(
            up(R0), up(t0), up(pad_to(np.asarray(X, np.float32), nb)),
            up(pad_to(np.concatenate([und, ur[:, None]], 1).astype(np.float32), nb)),
            up(pad_to(self.inv_sigma2[f.octave[sel]].astype(np.float32), nb)),
            up(pad_to(stereo, nb, False), bool), up(valid, bool),
            self.camera.fx, self.camera.fy, self.camera.cx, self.camera.cy, self.bf,
            cam=self.camspec)
        return (Rf.cpu().numpy().astype(np.float64), tf.cpu().numpy().astype(np.float64),
                inl.cpu().numpy()[:n], sel)

    def _up(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(
            dtype or self.dtype)

    def _pose_opt_vi(self, frame: Frame, mp_ids):
        """Visual-inertial frame optimization (ref TrackLocalMap's
        PoseInertialOptimizationLastKeyFrame Optimizer.cc:7479 /
        ...LastFrame :7874). Anchor = the last KF right after a map update,
        else the last frame constrained by the marginalization prior; the
        solve returns the next frame's prior.

        Returns (inliers, sel) and writes pose, velocity and biases into
        `frame`; None if the inertial chain is not usable this frame (the
        caller falls back to the visual pose solve)."""
        from .inertial import preintegrate_window
        from ..imu.preintegration import information_from_cov, pre_to
        from ..solve.pose_inertial import pose_inertial_solve

        m = self.map
        calib = self.imu_calib
        last = self.last_frame
        use_kf_anchor = (self.prior is None or m.map_version != self.map_version_seen
                         or self.frames_since_kf == 0)
        if use_kf_anchor:
            kf = self.last_kf
            if kf < 0 or not m.kf_valid[kf]:
                return None
            t0 = float(m.kf_time[kf])
            if frame.time <= t0:
                return None
            bg1, ba1 = m.kf_bg[kf].copy(), m.kf_ba[kf].copy()
            bg0, ba0 = bg1, ba1          # the window's integration bias
            pre, _ = preintegrate_window(self.imu_since_kf, t0, frame.time, bg1, ba1, calib,
                                         self.device)
            R1, p1 = calib.body_from_cam(m.kf_R[kf], m.kf_t[kf])
            v1 = m.kf_vel[kf].copy()
            prior_H = np.zeros((15, 15))
            anchor_fixed = True
        else:
            if last is None or last.v is None or self._pre_frame is None:
                return None
            pre = self._pre_frame        # integrated at (self.bg, self.ba)
            bg0, ba0 = self.bg.copy(), self.ba.copy()
            bg1, ba1 = (last.bg, last.ba) if last.bg is not None else (self.bg, self.ba)
            R1, p1 = calib.body_from_cam(last.R, last.t)
            v1 = last.v
            prior_H = self.prior["H"]
            anchor_fixed = False
        dT = max(float(pre["dT"]), 1e-6)
        # the window's information in f64 (tpuslam's cast), then the
        # solver's dtype
        info9 = information_from_cov(self._up(np.asarray(pre["C"])[:9, :9], torch.float64))
        _, _, wg2, wa2 = calib.discrete_cov()
        sel = np.nonzero(mp_ids >= 0)[0]
        n = len(sel)
        if n < 3:
            return None
        f = frame.feats
        und = f.und_xy[sel]
        if f.u_right is not None:
            ur = f.u_right[sel]
            stereo = ur >= 0
        else:
            ur = np.zeros(n)
            stereo = np.zeros(n, bool)
        R2, p2 = calib.body_from_cam(frame.R, frame.t)
        v2 = frame.v if frame.v is not None else v1
        pr = self.prior if not anchor_fixed else dict(R=R1, p=p1, v=v1, bg=bg1, ba=ba1)
        up = self._up
        dev = self.device
        with T.stage("pose_inertial"):
            out = pose_inertial_solve(
                up(R1), up(p1), up(v1), up(bg1), up(ba1), up(R2), up(p2), up(v2), up(self.bg),
                up(self.ba), up(m.mp_pos[mp_ids[sel]]),
                up(np.concatenate([und, ur[:, None]], 1)), up(self.inv_sigma2[f.octave[sel]]),
                torch.as_tensor(stereo, device=dev), torch.ones(n, dtype=torch.bool, device=dev),
                pre_to(pre, dev, self.dtype), info9.to(self.dtype), up(bg0), up(ba0),
                1.0 / (wg2 * dT), 1.0 / (wa2 * dT), up(prior_H), up(pr["R"]), up(pr["p"]),
                up(pr["v"]), up(pr["bg"]), up(pr["ba"]), anchor_fixed, up(calib.Rcb),
                up(calib.tcb), self.camera.fx, self.camera.fy, self.camera.cx, self.camera.cy,
                self.bf, cam=self.camspec)
            Rb, pb, vb, bgf, baf, inl, H15, _ = (x.cpu().numpy() for x in out)
        Rb, pb = Rb.astype(np.float64), pb.astype(np.float64)
        if not np.all(np.isfinite(Rb)) or not np.all(np.isfinite(pb)):
            return None
        frame.R, frame.t = calib.cam_from_body(Rb, pb)
        frame.v = vb.astype(np.float64)
        frame.bg = bgf.astype(np.float64)
        frame.ba = baf.astype(np.float64)
        self.bg, self.ba = frame.bg.copy(), frame.ba.copy()
        self.prior = dict(H=H15.astype(np.float64), R=Rb, p=pb, v=frame.v, bg=frame.bg,
                          ba=frame.ba)
        self.map_version_seen = m.map_version
        return inl[:n], sel

    # ------------------------------------------------------------------ main
    def track(self, img, time: float, img_right=None, depth=None, imu=None):
        """img_right: the right image of a stereo pair; depth: the depth
        map of an RGB-D frame; neither for a monocular frame. imu: [N,7]
        samples (t, wx, wy, wz, ax, ay, az) since the last frame (ref
        System::TrackMonocular vImuMeas + GrabImuData); ignored without an
        ImuCalib."""
        if self.sensor == "stereo" and img_right is None and depth is None:
            raise ValueError("stereo tracking needs img_right or depth")
        if self.sensor == "mono" and (img_right is not None or depth is not None):
            raise ValueError("a monocular tracker takes one image")
        if self.use_imu and imu is not None and len(imu):
            self.imu_since_kf.extend(np.asarray(imu, np.float64).tolist())
        # IMU sanity guards (ref Tracking.cc:854-891 timestamp jumps;
        # LocalMapping.cc:138-145 bad-IMU map reset)
        if self.use_imu and self.map.bad_imu:
            self.map.bad_imu = False
            print_mess("[tracking] bad IMU stream: resetting active map")
            self.reset_active_map()
        if (self.last_frame is not None and not self._force_new_map
                and self.state not in (State.NO_IMAGES_YET, State.NOT_INITIALIZED)):
            dt_jump = time - self.last_frame.time
            if dt_jump < 0:
                # timestamps went backwards: broken stream -> reset the
                # active map (ref Tracking.cc:861-868)
                print_mess("[tracking] timestamp went backwards: reset")
                self.reset_active_map()
            elif self.use_imu and dt_jump > 1.0:
                # a >1 s sensor gap breaks the preintegration bridge: a mature
                # inertial map opens a new Atlas map, else reset in place
                # (ref Tracking.cc:869-890)
                print_mess(f"[tracking] {dt_jump:.2f}s sensor gap")
                if self.map.imu_initialized and self.map.inertial_ba1:
                    self._force_new_map = True
                else:
                    self.reset_active_map()
                self.imu_since_kf = []
        # fused on-device path: extraction happens INSIDE the fused step
        fused_ok = (
            self.fused_enabled
            and self.state == State.OK
            and not self._force_new_map
            and not self.use_imu
            and self.camera2 is None
            and depth is None
            and self.camspec.kind == "pinhole"
            and self.last_frame is not None
            and self.last_frame.mp is not None
        )
        frame = Frame(None, time, self.frame_id)
        self.frame_id += 1
        ran = False
        if self._pending is not None and not (fused_ok and self.cfg.tracking.pipelined):
            # leaving the pipelined path: settle the in-flight frame first
            self._flush_pipeline()
            self.last_frame = self._last_completed or self.last_frame
        if fused_ok and self.cfg.tracking.pipelined:
            # locking is staged inside (dispatch + result-apply under the
            # map lock, the device fetch outside it)
            with T.stage("track_fused"):
                res = self._track_fused_pipelined(frame, img, img_right)
            if res is not None:
                self.last_frame = self._last_completed or self.last_frame
                return frame
        if fused_ok:
            with self.map.lock:
                self._anchor(frame)
                with T.stage("track_fused"):
                    res = self._track_fused(frame, img, img_right)
                if res is not None:
                    ran = True
                    self._settle_fused(frame, res)
        # the visual-INERTIAL fused path: the fused visual step runs from
        # the IMU prediction, then ONE pose-inertial solve refines on its
        # associations (ref per-frame chain: PreintegrateIMU
        # Tracking.cc:909 -> PredictStateIMU :669 -> TrackLocalMap with
        # PoseInertialOptimization* Optimizer.cc:7479/7874)
        vi_fused_ok = not ran and self._vi_fused_ok(depth)
        if vi_fused_ok:
            with self.map.lock:
                ran = self._run_fused_vi(frame, img, img_right)
        if not ran:
            if frame.feats is None:
                with T.stage("extract"):
                    if img_right is not None and self.camera2 is not None:
                        frame.feats = self.frontend.process_stereo_fisheye(
                            img, img_right, self.camera2, self.R_rl, self.t_rl)
                    elif img_right is not None:
                        frame.feats = self.frontend.process_stereo(img, img_right)
                    elif depth is not None:
                        frame.feats = self.frontend.process_rgbd(
                            img, depth, self.cfg.depth_map_factor)
                    else:
                        frame.feats = self.frontend.process(img)
            if self._force_new_map and isinstance(self.local_mapper, AsyncMapper):
                # the mapping thread maps the old map's queued keyframes
                # before the store's IMU flags turn to the new map's (the
                # reference keeps them on each map)
                self.local_mapper.flush(raise_errors=False)
            # extraction ran lock-free; the state machine holds the map lock
            # (ref: Track() under Map::mMutexMapUpdate, Tracking.cc:921)
            with self.map.lock:
                # the mapping thread may have initialized the IMU since the
                # check above: decide again under the lock, as the
                # reference's Track() does
                if not vi_fused_ok and self._vi_fused_ok(depth):
                    ran = self._run_fused_vi(frame, img, img_right)
                if not ran:
                    self._track_host(frame)
        # trajectory log: pose RELATIVE to the reference KF, so later map
        # updates apply to logged frames too (ref: Tracking.cc:1327-1347)
        if frame.R is not None and self.ref_kf >= 0:
            with self.map.lock:
                self._reanchor(frame)
                self._log_pose(frame)
        self.last_frame = frame
        return frame

    def _vi_fused_ok(self, depth) -> bool:
        """Whether this frame can take the visual-inertial fused step."""
        last = self.last_frame
        return (self.fused_enabled and self.state == State.OK and not self._force_new_map
                and self.use_imu and self.map.imu_initialized and self.camera2 is None
                and depth is None and self.camspec.kind == "pinhole" and last is not None
                and last.mp is not None and last.R is not None)

    def _run_fused_vi(self, frame: Frame, img, img_right) -> bool:
        """The visual-inertial fused step after the async handshake; False
        when it cannot run. Caller holds the map lock."""
        self._anchor(frame)
        self._sync_imu_from_map()
        with T.stage("track_fused_vi"):
            res = self._track_fused_vi(frame, img, img_right)
        if res is None:
            return False
        self._settle_fused(frame, res)
        return True

    def _track_host(self, frame: Frame):
        """The host state machine on the frame's extracted features: a new
        Atlas map where one is due, then initialization or tracking. Caller
        holds the map lock."""
        if self._force_new_map and self.state not in (State.NO_IMAGES_YET,
                                                      State.NOT_INITIALIZED):
            # dataset boundary / sensor gap: open a fresh Atlas map
            self._force_new_map = False
            self.map.create_new_map()
            self._reset_tracker_state()
        self._anchor(frame)
        if self.state in (State.NO_IMAGES_YET, State.NOT_INITIALIZED):
            with T.stage("initialize"):
                if self.sensor == "mono":
                    self._initialize_mono(frame)
                else:
                    self._initialize_stereo(frame)
        else:
            self._sync_imu_from_map()
            with T.stage("track"):
                self._track_frame(frame)

    def _anchor(self, frame: Frame, kf: int | None = None):
        """Keep the pose of keyframe kf (the reference KF by default) on the
        frame whose pose is being computed against the map. Caller holds the
        map lock."""
        kf = self.ref_kf if kf is None else kf
        m = self.map
        frame.anchor = None if kf < 0 else (kf, m.kf_R[kf].copy(), m.kf_t[kf].copy())

    def _reanchor(self, frame: Frame):
        """A frame whose pose was computed against the map before its anchor
        keyframe moved (a merge or loop correction, a BA on the mapping
        thread, while the frame was in flight or between its tracking and
        its log) moves with that keyframe, as the reference's frames ride
        their reference keyframe (Tracking::UpdateLastFrame, with Track()
        under the map lock, Tracking.cc:921). Caller holds the map lock."""
        m = self.map
        if frame.anchor is None or frame.R is None:
            return
        kf, Ra, ta = frame.anchor
        if not m.kf_valid[kf] or (np.array_equal(m.kf_R[kf], Ra)
                                  and np.array_equal(m.kf_t[kf], ta)):
            return
        Rk, tk = m.kf_R[kf], m.kf_t[kf]
        Rcr = frame.R @ Ra.T
        tcr = frame.t - Rcr @ ta
        frame.R, frame.t = Rcr @ Rk, Rcr @ tk + tcr
        if frame.v is not None:
            frame.v = Rk.T @ Ra @ frame.v
        frame.anchor = (kf, Rk.copy(), tk.copy())

    def _settle_fused(self, frame: Frame, res: bool):
        """After a fused step: the OK bookkeeping, or (too few inliers) the
        host state machine on the features the step already extracted."""
        if res:
            self._post_track_ok(frame)
            return
        frame.R = frame.t = None
        frame.mp = None
        with T.stage("track"):
            self._track_frame(frame)

    # ---------------------------------------------------------------- inertial
    def _sync_imu_from_map(self):
        """Async-mapping handshake (ref Tracking::UpdateFrameIMU,
        Tracking.cc:2993): when mapping has advanced the map (IMU init, VI
        BA, gravity alignment, loop correction all bump map_version), pull
        the last KF's bias and velocity before tracking this frame; the
        marginalization prior is stale in the new frame."""
        from .inertial import preintegrate_window

        m = self.map
        if (not self.use_imu or m.map_version == self.map_version_seen
                or self.last_kf < 0 or not m.kf_valid[self.last_kf]):
            return
        self.bg = m.kf_bg[self.last_kf].copy()
        self.ba = m.kf_ba[self.last_kf].copy()
        self.prior = None
        last = self.last_frame
        if m.imu_initialized and last is not None and last.R is not None:
            # the world frame may have been rescaled / rotated: rebase the
            # last frame by IMU-predicting from the last KF's state (ref
            # Tracking.cc:3010-3040)
            t0 = float(m.kf_time[self.last_kf])
            if last.time > t0 + 1e-9:
                pre, _ = preintegrate_window(self.imu_since_kf, t0, last.time, self.bg, self.ba,
                                             self.imu_calib, self.device)
                if float(pre["dT"]) > 0:
                    last.R, last.t, last.v = self._predict_from(
                        m.kf_R[self.last_kf], m.kf_t[self.last_kf], m.kf_vel[self.last_kf], pre)
            else:
                last.R = m.kf_R[self.last_kf].copy()
                last.t = m.kf_t[self.last_kf].copy()
                last.v = m.kf_vel[self.last_kf].copy()

    def _predict_from(self, Rcw, tcw, v, pre):
        """Camera pose + velocity after `pre`, from the camera pose Tcw and
        body velocity v (predict_state in f64 on the tracker's device)."""
        from ..imu.preintegration import predict_state, pre_to

        Rwb, p = self.imu_calib.body_from_cam(Rcw, tcw)
        f64 = torch.float64
        Rwb2, p2, v2 = (x.cpu().numpy() for x in predict_state(
            self._up(Rwb, f64), self._up(p, f64), self._up(v, f64),
            pre_to(pre, self.device, f64)))
        Rcw2, tcw2 = self.imu_calib.cam_from_body(Rwb2, p2)
        return Rcw2, tcw2, v2

    def _predict_imu(self, frame: Frame):
        """IMU dead-reckoning from the last frame's body state (ref
        Tracking::PredictStateIMU Tracking.cc:669). Returns the camera pose
        and velocity prediction (R0, t0, v) or None."""
        from .inertial import preintegrate_window

        last = self.last_frame
        self._pre_frame = None
        if (not self.use_imu or not self.map.imu_initialized or last is None or last.R is None
                or last.v is None):
            return None
        pre, _ = preintegrate_window(self.imu_since_kf, last.time, frame.time, self.bg,
                                     self.ba, self.imu_calib, self.device)
        if float(pre["dT"]) <= 0:
            return None
        self._pre_frame = pre
        return self._predict_from(last.R, last.t, last.v, pre)

    def _log_pose(self, frame: Frame):
        m = self.map
        Rr, tr_ = m.kf_R[self.ref_kf], m.kf_t[self.ref_kf]
        Rcr = frame.R @ Rr.T
        tcr = frame.t - Rcr @ tr_
        self.trajectory.append((frame.time, Rcr, tcr, self.ref_kf, self.state != State.OK))

    # ------------------------------------------------------------- mono init
    def _initialize_mono(self, frame: Frame):
        """ref: MonocularInitialization (Tracking.cc:1460) +
        CreateInitialMapMonocular (:1550): match the reference frame,
        two-view reconstruction, map at median depth 1, full BA."""
        cfg = self.cfg.tracking
        n_feat = frame.feats.n
        if self.init_frame is None or frame.feats.valid.sum() < cfg.min_matches_init:
            if frame.feats.valid.sum() >= cfg.min_matches_init:
                self.init_frame = frame
                self.state = State.NOT_INITIALIZED
            return
        ref = self.init_frame
        # SearchForInitialization: window 100, ratio 0.9, all levels
        mask = (M.window_mask_np(ref.feats.xy, frame.feats.xy, cfg.init_window)
                & ref.feats.valid[:, None] & frame.feats.valid[None, :])
        midx, _ = self._match(ref.feats.bits, frame.feats.bits, mask, max_dist=M.TH_LOW,
                              nn_ratio=cfg.nn_ratio_init, ang_a=ref.feats.angle,
                              ang_b=frame.feats.angle)
        matched = np.nonzero(midx >= 0)[0]
        if len(matched) < cfg.min_matches_init:
            self.init_frame = frame  # restart with the current frame as reference
            return
        x1 = np.zeros((n_feat, 2))
        x2 = np.zeros((n_feat, 2))
        valid = np.zeros(n_feat, bool)
        x1[matched] = ref.feats.norm_xy[matched]
        x2[matched] = frame.feats.norm_xy[midx[matched]]
        valid[matched] = True

        def up(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype)

        # a fresh seed-0 generator per attempt (tpuslam: PRNGKey(0))
        out = TV.reconstruct_two_views(up(x1), up(x2), torch.as_tensor(valid, device=self.device),
                                       generator=torch.Generator().manual_seed(0))
        if not bool(out["success"]):
            return
        good = out["good"].cpu().numpy()
        R21 = out["R21"].cpu().numpy().astype(np.float64)
        t21 = out["t21"].cpu().numpy().astype(np.float64)
        X = out["X"].cpu().numpy().astype(np.float64)
        # median depth in cam 1 = 1 (ref CreateInitialMapMonocular :1607)
        med = np.median(X[good][:, 2])
        X = X / med
        t21 = t21 / med
        m = self.map
        kf0 = m.add_keyframe(np.eye(3), np.zeros(3), ref.feats, ref.time, ref.frame_id)
        kf1 = m.add_keyframe(R21, t21, frame.feats, frame.time, frame.frame_id)
        frame.mp = np.full(n_feat, -1, np.int32)
        for i in np.nonzero(good & valid)[0]:
            j = midx[i]
            mp = m.add_point(X[i], kf0, int(i))
            m.add_observation(mp, kf1, int(j))
            m.update_point_stats(mp)
            frame.mp[j] = mp
        m.update_connections(kf0)
        m.update_connections(kf1)
        # full BA on the initial map (ref GlobalBundleAdjustemnt(20))
        self._initial_ba(kf0, kf1)
        if self.use_imu:
            from .inertial import preintegrate_window

            m.kf_prev[kf1] = kf0
            m.kf_preint[kf1], m.kf_imu[kf1] = preintegrate_window(
                self.imu_since_kf, ref.time, frame.time, self.bg, self.ba, self.imu_calib,
                self.device)
            self.imu_since_kf = [s for s in self.imu_since_kf if s[0] > frame.time - 1e-12]
        frame.R = m.kf_R[kf1].copy()
        frame.t = m.kf_t[kf1].copy()
        self.ref_kf = kf1
        self.last_kf = kf1
        self.state = State.OK
        self.frames_since_kf = 0
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf0)
            self.local_mapper.on_new_keyframe(kf1)
        if self.loop_closer is not None:
            self.loop_closer.on_new_keyframe(kf0)
            self.loop_closer.on_new_keyframe(kf1)

    def _initial_ba(self, kf0, kf1):
        """Two-keyframe BA of the initial mono map, KF 0 fixed: the points
        the two keyframes triangulated, nothing of the Atlas's other maps.
        tpuslam takes every valid point of the store, so a young map's init
        after change_dataset() solves the older maps' points too, with each
        of their observations read as one of kf1's, and writes them back."""
        m = self.map
        obs_kf, obs_pt, uvr, inv_s2 = [], [], [], []
        mp_ids = m.points_in_kfs([kf0, kf1])
        remap = {int(j): i for i, j in enumerate(mp_ids)}
        for j in mp_ids:
            for kf, slot in m.mp_obs[j].items():
                obs_kf.append(0 if kf == kf0 else 1)
                obs_pt.append(remap[int(j)])
                uvr.append([*m.kf_feats[kf].und_xy[slot], 0.0])
                inv_s2.append(self.inv_sigma2[m.kf_feats[kf].octave[slot]])
        if not obs_kf:
            return
        n_obs = len(obs_kf)
        Rf, tf, Xf, _, _ = B.ba_solve_np(
            np.stack([m.kf_R[kf0], m.kf_R[kf1]]), np.stack([m.kf_t[kf0], m.kf_t[kf1]]),
            m.mp_pos[mp_ids], np.array(obs_kf, np.int32), np.array(obs_pt, np.int32),
            np.array(uvr), np.array(inv_s2), np.zeros(n_obs, bool), np.ones(n_obs, bool),
            np.array([True, False]), self.camera.fx, self.camera.fy, self.camera.cx,
            self.camera.cy, 0.0, n_iters=20, cam=self.camspec, device=self.device,
            dtype=self.dtype)
        m.kf_R[kf1] = Rf[1]
        m.kf_t[kf1] = tf[1]
        m.mp_pos[mp_ids] = Xf
        for j in mp_ids:
            m.update_point_stats(int(j))

    # ------------------------------------------------------------ stereo init
    def _initialize_stereo(self, frame: Frame):
        """ref: StereoInitialization (Tracking.cc:1351) — the first frame
        with enough features becomes a KF; map points spring from depth."""
        if frame.feats.valid.sum() < self.cfg.tracking.min_stereo_init_features:
            return
        if self.use_imu:
            # stereo-inertial init needs measured acceleration beyond
            # gravity (ref Tracking.cc:1363-1368 'not enough acceleration');
            # as in tpuslam, the std of |a| over the raw samples stands in
            # for the reference's preintegrated-acceleration norm
            if len(self.imu_since_kf) < 10:
                return
            a = np.asarray(self.imu_since_kf)[:, 4:7]
            if np.std(np.linalg.norm(a, axis=1)) < 0.25:
                print_mess("[tracking] stereo-IMU init: not enough acceleration, waiting")
                return
        m = self.map
        frame.R = np.eye(3)
        frame.t = np.zeros(3)
        frame.mp = np.full(frame.feats.n, -1, np.int32)
        kf = m.add_keyframe(frame.R, frame.t, frame.feats, frame.time, frame.frame_id)
        n_pts = self._spawn_stereo_points(kf, frame, max_new=10 ** 9)
        if n_pts < 100:
            m.kf_valid[kf] = False
            return
        m.update_connections(kf)
        self.ref_kf = kf
        self.last_kf = kf
        self.state = State.OK
        self.frames_since_kf = 0
        if self.use_imu:
            m.kf_prev[kf] = -1
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(kf)
        if self.loop_closer is not None:
            self.loop_closer.on_new_keyframe(kf)

    def _spawn_stereo_points(self, kf: int, frame: Frame, max_new=100):
        """Create map points from stereo / RGB-D depth for unmatched features
        (ref: CreateNewKeyFrame close-point spawning Tracking.cc:2270-2330):
        in order of increasing depth, all points closer than th_depth x
        baseline, then up to max_new."""
        f = frame.feats
        if f.depth is None:
            return 0
        m = self.map
        free = (frame.mp < 0) & f.valid & (f.depth > 0)
        order = np.argsort(np.where(free, f.depth, np.inf))
        th = self.cfg.th_depth * (self.bf / self.camera.fx)
        n = 0
        Rwc = frame.R.T
        Ow = -Rwc @ frame.t
        for i in order:
            if not free[i]:
                break
            z = f.depth[i]
            if z <= 0 or (n >= max_new and z > th):
                break
            # back-projection through the camera model: norm_xy is the z = 1
            # unprojected ray, exact for pinhole and fisheye alike (ref
            # UnprojectStereoFishEye Frame.cc:1245)
            nx, ny = f.norm_xy[i]
            Xw = Rwc @ np.array([nx * z, ny * z, z]) + Ow
            frame.mp[i] = m.add_point(Xw, kf, int(i))
            n += 1
        return n

    # ------------------------------------------------------------ fused path
    def _fused_tracker(self):
        if self._fused is None:
            self._fused = FusedTracker(self)
        return self._fused

    def _min_req(self):
        return self.cfg.tracking.min_inliers_local if self.frames_since_kf > 0 else 15

    def _flush_pipeline(self):
        """Complete the in-flight pipelined step so the tracker state is
        consistent before a mode change or fallback."""
        if self._pending is None:
            return
        pend_frame, out, min_req = self._pending
        self._pending = None
        fetched = self._fused.fetch_results(out)  # lock-free
        with self.map.lock:
            n_inl = self._fused.complete(out, pend_frame, fetched=fetched)
            self.n_inliers = n_inl
            self._finish_completed(pend_frame, n_inl, min_req)

    def _finish_completed(self, frame: Frame, n_inl: int, min_req: int):
        """Bookkeeping for a pipeline-completed frame: state machine, KF
        decision, trajectory log (what the synchronous path does inline).
        The frame was dispatched against the map as it was then: a
        correction since moves it first."""
        self._reanchor(frame)
        if n_inl >= min_req:
            self._post_track_ok(frame)
        else:
            self.state = State.RECENTLY_LOST
            self.lost_since = frame.time
        if frame.R is not None and self.ref_kf >= 0:
            self._log_pose(frame)
        self._last_completed = frame

    def _track_fused_pipelined(self, frame: Frame, img, img_right):
        """Pipelined fused tracking (cfg.tracking.pipelined): dispatch the
        CURRENT frame's step against the device-resident pose chain, then
        complete the PREVIOUS frame. One frame of latency. Returns None
        when the pipeline can't run (the caller falls back)."""
        ft = self._fused_tracker()
        self._last_completed = None
        vote_frame = self.last_frame
        if vote_frame is None or vote_frame.mp is None or vote_frame.R is None:
            return None
        with self.map.lock:
            ok_map = ft.build_local_map(vote_frame.mp)
            if ok_map:
                self._anchor(frame)
                min_req = self._min_req()
                if self._pending is not None:
                    pose_in = self._pending[1]["pose"]
                else:
                    pose_in = np.concatenate([
                        np.asarray(self.last_frame.R, np.float32).ravel(),
                        np.asarray(self.last_frame.t, np.float32), np.float32([0.0])])
                out = ft.dispatch(img, img_right, pose_in, min_req)
                pend = self._pending
                self._pending = (frame, out, min_req)
        if not ok_map:
            self._flush_pipeline()
            return None
        if pend is not None:
            pend_frame, pend_out, pend_req = pend
            fetched = ft.fetch_results(pend_out)  # lock-free
            with self.map.lock:
                n_inl = ft.complete(pend_out, pend_frame, fetched=fetched)
                self.n_inliers = n_inl
                self._finish_completed(pend_frame, n_inl, pend_req)
                if self.state != State.OK:
                    # the in-flight step rode a failed pose: discard it and
                    # let the host path take over on the next frame
                    self._pending = None
        return True

    def _track_fused(self, frame: Frame, img, img_right):
        """One-dispatch tracking via FusedTracker. Returns True (tracked),
        False (too few inliers: the caller falls back to the host path with
        the extracted features) or None (no usable local map)."""
        ft = self._fused_tracker()
        last = self.last_frame
        if not ft.build_local_map(last.mp):
            return None
        min_req = self._min_req()
        n_inl = ft.track(img, img_right, frame, last.R, last.t, min_req)
        self.n_inliers = n_inl
        return n_inl >= min_req

    def _track_fused_vi(self, frame: Frame, img, img_right):
        """Visual-inertial fused tracking: IMU-predict the pose, run the
        fused visual step seeded at the prediction (1 patch-gather launch
        per image, 4 pose-LM launches), then ONE pose-inertial solve over
        its associations; the marginalization-prior chain is kept as on the
        host path. Returns True (tracked), False (too few inliers: the
        caller falls back with the extracted features) or None (cannot
        run)."""
        ft = self._fused_tracker()
        pred = self._predict_imu(frame)
        if pred is None or not ft.build_local_map(self.last_frame.mp):
            return None
        R0, t0, frame.v = pred
        min_req = self._min_req()
        n_inl = ft.track(img, img_right, frame, R0, t0, min_req)
        if n_inl < max(min_req // 2, 10):
            self.n_inliers = n_inl
            return False
        vi = self._pose_opt_vi(frame, frame.mp)
        if vi is None:
            # the inertial chain is unusable this frame: the fused visual
            # pose stands (as the host path's visual fallback)
            self.n_inliers = n_inl
            return n_inl >= min_req
        inl, sel = vi
        frame.mp[sel[~inl]] = -1
        self.n_inliers = int(inl.sum())
        return self.n_inliers >= min_req

    def _post_track_ok(self, frame: Frame, pred=None):
        """Shared post-tracking bookkeeping: the frame's velocity, state
        and KF decision (ref: Track() after TrackLocalMap,
        Tracking.cc:1239+). tpuslam also stores a constant-velocity motion
        model here, which nothing reads; the port drops it."""
        self.state = State.OK
        # the frame's velocity, unless the VI solve estimated it
        if frame.bg is None:
            last = self.last_frame
            dt = frame.time - last.time
            if pred is not None:
                p_pred = -pred[0].T @ pred[1]
                frame.v = pred[2] + ((frame.center() - p_pred) / dt if dt > 0 else 0.0)
            elif last.R is not None and dt > 0:
                frame.v = (frame.center() - last.center()) / dt
        self.frames_since_kf += 1
        if not self.only_tracking and self._need_new_keyframe(frame):
            self._create_keyframe(frame)

    # -------------------------------------------------------------- tracking
    def _track_frame(self, frame: Frame):
        cfg = self.cfg.tracking
        ok = False
        pred = self._predict_imu(frame)
        if self.state == State.OK:
            # pose prediction: the IMU, else the LAST POSE (tpuslam drops the
            # constant-velocity extrapolation of Tracking.cc:1887 for vision-
            # only tracking, whose closed loop it measured as unstable)
            if pred is not None:
                R0, t0, _ = pred
            else:
                R0, t0 = self.last_frame.R, self.last_frame.t
            if self.only_tracking and self.vo_mode:
                # riding VO points in an unmapped region: try to relocate
                # into the map each frame, else keep dead-reckoning on
                # temporary points (ref Tracking.cc:1027-1047)
                ok = self._relocalize(frame)
                if ok:
                    self.vo_mode = False
                else:
                    ok = self._track_motion_model(frame, R0, t0)
                    if ok:
                        self.frames_since_kf += 1
                        return ok
                if not ok:
                    self.state = State.RECENTLY_LOST
                    self.lost_since = frame.time
                    self._keep_last_pose(frame)
                    return False
            # descriptor-first association (reference-KF match), with the
            # window-gated motion model as the fallback
            ok = self._track_reference_kf(frame, R0, t0)
            if not ok:
                ok = self._track_motion_model(frame, R0, t0)
        elif self.state == State.RECENTLY_LOST:
            if pred is not None:
                # with an initialized IMU a RECENTLY_LOST frame rides the
                # prediction and retries local-map tracking directly (ref
                # Tracking.cc:1017-1047)
                frame.R, frame.t, frame.v = pred
                frame.mp = np.full(frame.feats.n, -1, np.int32)
                ok = self._track_local_map(frame)
            if not ok:
                ok = self._relocalize(frame)
            if not ok and pred is not None:
                # IMU dead-reckoning while recently lost
                frame.R, frame.t, frame.v = pred
        if ok and self.only_tracking and self.vo_mode:
            # the frame slid onto VO points: skip local-map tracking, stay
            # OK (ref: !mbVO gate before TrackLocalMap, Tracking.cc:1161)
            self.frames_since_kf += 1
            return ok
        if ok:
            ok = self._track_local_map(frame)
        if ok:
            self._post_track_ok(frame, pred=pred)
        else:
            if self.state == State.OK:
                self.state = State.RECENTLY_LOST
                self.lost_since = frame.time
            elif (self.state == State.RECENTLY_LOST
                  and frame.time - self.lost_since > cfg.time_recently_lost):
                self.state = State.LOST
            if pred is not None:
                # with an initialized IMU the frame that fails rides the IMU
                # prediction, the first one too (tpuslam keeps that one's
                # rejected visual pose, which lands in the trajectory)
                frame.R, frame.t, frame.v = pred
            self._keep_last_pose(frame)
            if self.state == State.LOST:
                self._handle_lost()
        return ok

    def _keep_last_pose(self, frame: Frame):
        """A failed frame keeps the last pose for the trajectory."""
        if frame.R is None and self.last_frame.R is not None:
            frame.R = self.last_frame.R.copy()
            frame.t = self.last_frame.t.copy()
        if frame.mp is None:
            frame.mp = np.full(frame.feats.n, -1, np.int32)

    def _handle_lost(self):
        """ref: Tracking.cc:1053-1058 + CreateMapInAtlas (:1689) — a mature
        map spawns a fresh Atlas map; young maps are reset in place."""
        m = self.map
        if len(m.valid_kf_ids()) >= 10:
            m.create_new_map()
            self._reset_tracker_state()
        else:
            self.reset_active_map()

    def reset_active_map(self):
        """ref: Tracking::ResetActiveMap (Tracking.cc:2857) — drop the active
        map's KFs/MPs and restart initialization in place."""
        m = self.map
        with m.lock:
            for k in m.valid_kf_ids():
                for slot in np.nonzero(m.kf_mp[k] >= 0)[0]:
                    mp = int(m.kf_mp[k, slot])
                    if m.mp_valid[mp]:
                        m.set_bad_point(mp)
                m.kf_valid[k] = False
                if self.loop_closer is not None:
                    self.loop_closer.on_kf_erased(k)
        self._reset_tracker_state()

    def reset(self):
        """ref: Tracking::Reset (Tracking.cc:2792) — clear every Atlas map
        and all tracker state."""
        m = self.map
        with m.lock:
            for k in m.valid_kf_ids(all_maps=True):
                m.kf_valid[k] = False
                if self.loop_closer is not None:
                    self.loop_closer.on_kf_erased(k)
            m.mp_valid[: m.n_mp] = False
            m.create_new_map()
            m.imu_initialized = False
            m.map_version += 1
        self._reset_tracker_state()
        self.last_frame = None
        self.trajectory = []
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.frame_id = 0

    def _reset_tracker_state(self):
        self.state = State.NO_IMAGES_YET
        self.init_frame = None
        self.ref_kf = -1
        self.last_kf = -1
        self.imu_since_kf = []
        self.frames_since_kf = 0
        self.prior = None

    def _track_motion_model(self, frame: Frame, R0, t0):
        """ref: TrackWithMotionModel (Tracking.cc:1879) — project the last
        frame's map points from the predicted pose. In localization mode the
        last frame's depth spawns TEMPORARY visual-odometry points for its
        unmatched features (ref: UpdateLastFrame, Tracking.cc:1249-1270)."""
        cfg = self.cfg.tracking
        last = self.last_frame
        last_mp = np.array(
            [self.map.resolve_replaced(int(j)) if j >= 0 else -1 for j in last.mp], np.int32)
        sel = np.nonzero(last_mp >= 0)[0]
        n_real = len(sel)
        vo_X = np.zeros((0, 3))
        if (self.only_tracking and self.sensor != "mono" and last.feats.depth is not None
                and last.R is not None):
            d = last.feats.depth
            free = (last_mp < 0) & last.feats.valid & (d > 0)
            cand = np.nonzero(free)[0]
            if len(cand):
                order = cand[np.argsort(d[cand])]
                th = self.cfg.th_depth * (self.bf / self.camera.fx) if self.bf > 0 else np.inf
                close = order[d[order] < th][:100]
                if len(close) < 20:  # spawn at least some (ref 100 cap)
                    close = order[:100]
                if len(close):
                    nx = last.feats.norm_xy[close]
                    zc = d[close]
                    Xc = np.stack([nx[:, 0] * zc, nx[:, 1] * zc, zc], 1)
                    Rwc = last.R.T
                    vo_X = Xc @ Rwc.T + (-Rwc @ last.t)[None]
                    sel = np.concatenate([sel, close])
        if len(sel) < 10:
            return False
        mp_ids = last_mp[sel]  # -1 rows are VO points
        Xall = np.concatenate([self.map.mp_pos[last_mp[sel[:n_real]]], vo_X], 0)
        uv, z, _ = self._project(R0, t0, Xall)
        radius = cfg.motion_model_radius * self.sf[last.feats.octave[sel]]
        for th_mult in (1.0, 2.0):  # widen once if too few (ref :1928)
            mask = (
                M.window_mask_np(uv, frame.feats.xy, radius * th_mult)
                & (z > 0)[:, None]
                & frame.feats.valid[None, :]
                & M.level_mask_np(last.feats.octave[sel], frame.feats.octave, 1, 1)
            )
            midx, _ = self._match(
                last.feats.bits[sel], frame.feats.bits, mask, max_dist=M.TH_HIGH,
                ang_a=last.feats.angle[sel], ang_b=frame.feats.angle)
            if (midx >= 0).sum() >= cfg.min_matches_motion:
                break
        if (midx >= 0).sum() < cfg.min_matches_motion:
            return False
        frame.mp = np.full(frame.feats.n, -1, np.int32)
        rows = np.nonzero(midx >= 0)[0]
        real = rows[mp_ids[rows] >= 0]
        frame.mp[midx[real]] = mp_ids[real]
        # per-feature positions: map points AND temporary VO points
        X_feat = np.zeros((frame.feats.n, 3))
        vmask = np.zeros(frame.feats.n, bool)
        X_feat[midx[rows]] = Xall[rows]
        vmask[midx[rows]] = True
        Rf, tf, inl, osel = self._pose_opt(R0, t0, frame, frame.mp, X_by_feat=X_feat,
                                           valid_by_feat=vmask)
        frame.R, frame.t = Rf, tf
        frame.mp[osel[~inl]] = -1
        self.n_inliers = int(inl.sum())
        if self.only_tracking:
            # ref: mbVO = few MAP matches — the frame rides VO points
            self.vo_mode = int((frame.mp[osel[inl]] >= 0).sum()) < 10
        return self.n_inliers >= cfg.min_inliers_motion

    def _track_reference_kf(self, frame: Frame, R0=None, t0=None):
        """ref: TrackReferenceKeyFrame (Tracking.cc:1750) — descriptor match
        against the reference KF's map-point features, window-FREE; R0/t0
        only initialize the optimizer."""
        cfg = self.cfg.tracking
        m = self.map
        kf = self.ref_kf
        if kf < 0:
            return False
        kf_mp = m.kf_mp[kf].copy()
        for i, j in enumerate(kf_mp):
            if j >= 0:
                kf_mp[i] = m.resolve_replaced(int(j))
        sel = np.nonzero(kf_mp >= 0)[0]
        if len(sel) < 10:
            return False
        fk = m.kf_feats[kf]
        mask = fk.valid[sel][:, None] & frame.feats.valid[None, :]
        midx, _ = self._match(
            fk.bits[sel], frame.feats.bits, mask, max_dist=M.TH_LOW,
            nn_ratio=cfg.nn_ratio_ref_kf, ang_a=fk.angle[sel], ang_b=frame.feats.angle)
        if (midx >= 0).sum() < 15:
            return False
        frame.mp = np.full(frame.feats.n, -1, np.int32)
        ok = midx >= 0
        frame.mp[midx[ok]] = kf_mp[sel[ok]]
        if R0 is None:
            R0 = self.last_frame.R
            t0 = self.last_frame.t
        Rf, tf, inl, osel = self._pose_opt(R0, t0, frame, frame.mp)
        frame.R, frame.t = Rf, tf
        frame.mp[osel[~inl]] = -1
        self.n_inliers = int(inl.sum())
        return self.n_inliers >= cfg.min_inliers_motion

    def _relocalize(self, frame: Frame):
        """Relocalization (ref Tracking::Relocalization Tracking.cc:2626):
        the reference-KF neighbourhood first, then BoW candidates + PnP
        RANSAC when a vocabulary is wired."""
        if self.ref_kf < 0:
            self.state = State.LOST
            return False
        for kf in [self.ref_kf] + self.map.best_covisible(self.ref_kf, 5):
            self.ref_kf = kf
            if self._track_reference_kf(frame):
                return True
        if self.loop_closer is not None:
            return self._relocalize_bow(frame)
        return False

    def _relocalize_bow(self, frame: Frame):
        """ref DetectRelocalizationCandidates + SearchByBoW + PnP RANSAC +
        PoseOptimization: node-gated matching against each candidate KF's
        map points, RANSAC DLT-PnP (256 hypotheses drawn from a generator
        seeded with the frame id), then the pose LM."""
        lc = self.loop_closer
        m = self.map
        word, node, bow = lc.vocab.transform(frame.feats.bits, frame.feats.valid,
                                             device=self.device)
        cands = lc.db.detect_relocalization_candidates(bow, lambda k: m.best_covisible(k, 10))
        for kf, _score in cands:
            if not m.kf_valid[kf]:
                continue
            fk = m.kf_feats[kf]
            nk = lc.kf_nodes.get(kf)
            mask = ((m.kf_mp[kf] >= 0) & fk.valid)[:, None] & frame.feats.valid[None, :]
            if nk is not None:
                mask = mask & (nk[:, None] == node[None, :])
            midx, _ = self._match(fk.bits, frame.feats.bits, mask, max_dist=M.TH_LOW,
                                  nn_ratio=0.75, ang_a=fk.angle, ang_b=frame.feats.angle)
            ia = np.nonzero(midx >= 0)[0]
            if len(ia) < 15:
                continue
            mp = m.kf_mp[kf, ia]
            ok = mp >= 0
            ia, mp = ia[ok], mp[ok]
            slots = midx[ia]
            n = len(ia)

            def up(a):
                return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

            res = pnp_ransac(up(m.mp_pos[mp]), up(frame.feats.norm_xy[slots]),
                             up(self.inv_sigma2[frame.feats.octave[slots]]),
                             torch.ones(n, dtype=torch.bool, device=self.device),
                             generator=torch.Generator().manual_seed(frame.frame_id),
                             n_hyp=256, focal2=float(self.camera.fx) ** 2)
            if int(res["n_inliers"]) < 10:
                continue
            frame.mp = np.full(frame.feats.n, -1, np.int32)
            inl = res["inliers"].cpu().numpy()
            frame.mp[slots[inl]] = mp[inl]
            Rf, tf, pin, osel = self._pose_opt(
                res["R"].cpu().numpy().astype(np.float64),
                res["t"].cpu().numpy().astype(np.float64), frame, frame.mp)
            frame.R, frame.t = Rf, tf
            frame.mp[osel[~pin]] = -1
            self.n_inliers = int(pin.sum())
            if self.n_inliers >= 15:
                self.ref_kf = kf
                return True
        return False

    # ------------------------------------------------------------- local map
    def _track_local_map(self, frame: Frame):
        cfg = self.cfg.tracking
        m = self.map
        # K1: KFs observing current map points; new ref_kf = max overlap
        counts: dict[int, int] = {}
        for j in frame.mp[frame.mp >= 0]:
            for kf in m.mp_obs[int(j)]:
                counts[kf] = counts.get(kf, 0) + 1
        if not counts:
            # no associations yet: the last keyframe's neighbourhood (ref
            # UpdateLocalKeyFrames last-KF fallback, Tracking.cc:2526)
            anchor = self.last_kf if (self.last_kf >= 0 and m.kf_valid[self.last_kf]) \
                else self.ref_kf
            if anchor < 0 or not m.kf_valid[anchor]:
                return False
            k1 = [anchor]
        else:
            k1 = sorted(counts, key=counts.get, reverse=True)
        self.ref_kf = k1[0]
        local_kfs = list(k1)
        seen = set(local_kfs)
        for kf in k1[:10]:  # K2: neighbours (ref caps the local window at 80)
            for o in m.best_covisible(kf, 10):
                if o not in seen and len(local_kfs) < 80:
                    seen.add(o)
                    local_kfs.append(o)
        ids = np.unique(m.kf_mp[local_kfs])
        ids = ids[ids >= 0]
        ids = ids[m.mp_valid[ids]]
        min_req = self._min_req()

        def search_and_opt(radius_mult: float, count_stats: bool):
            """One projection-search + pose-opt pass at the frame's current
            pose; fills only FREE slots of frame.mp. Returns (inl, osel)."""
            cur_set = set(int(j) for j in frame.mp[frame.mp >= 0])
            cand = np.array([j for j in ids if int(j) not in cur_set], np.int32)
            if len(cand):
                X = m.mp_pos[cand]
                uv, z, _ = self._project(frame.R, frame.t, X)
                Ow = -frame.R.T @ frame.t
                vdir = X - Ow[None]
                dist = np.linalg.norm(vdir, axis=1)
                cosv = np.sum(vdir * m.mp_normal[cand], 1) / np.maximum(dist, 1e-9)
                in_img = (
                    (z > 0)
                    & (uv[:, 0] >= 0) & (uv[:, 0] < self.camera.width)
                    & (uv[:, 1] >= 0) & (uv[:, 1] < self.camera.height)
                    & (dist >= 0.8 * m.mp_min_dist[cand])
                    & (dist <= 1.2 * m.mp_max_dist[cand])
                    & (cosv > 0.5)
                )  # ref: Frame::isInFrustum (:483)
                if count_stats:
                    m.mp_visible[cand[in_img]] += 1
                cand = cand[in_img]
                uv = uv[in_img]
                dist = dist[in_img]
                cosv = cosv[in_img]
            if len(cand):
                pred = m.predict_scale(dist, cand)
                radius = np.where(cosv > 0.998, cfg.local_map_radius_tight,
                                  cfg.local_map_radius) * self.sf[pred] * radius_mult
                free = frame.mp < 0  # only fill unmatched feature slots
                mask = (
                    M.window_mask_np(uv, frame.feats.xy, radius)
                    & (frame.feats.valid & free)[None, :]
                    & M.level_mask_np(pred, frame.feats.octave, 1, 0)
                )
                # ratio test only when best/second share a pyramid level
                # (ref: SearchByProjection ORBmatcher.cc:130)
                midx, _ = self._match(
                    m.mp_bits[cand], frame.feats.bits, mask, max_dist=M.TH_HIGH,
                    nn_ratio=cfg.nn_ratio_local, oct_b=frame.feats.octave,
                    ratio_same_octave=True)
                ok = midx >= 0
                frame.mp[midx[ok]] = cand[ok]
            vi = None
            if self.use_imu and m.imu_initialized:
                vi = self._pose_opt_vi(frame, frame.mp)
            if vi is not None:
                inl, osel = vi
            else:
                Rf, tf, inl, osel = self._pose_opt(frame.R, frame.t, frame, frame.mp)
                frame.R, frame.t = Rf, tf
            self.n_inliers = int(inl.sum())
            return inl, osel

        # pass 1: inherited associations + local fill-in
        inl, osel = search_and_opt(1.0, count_stats=False)
        if self.n_inliers < 2 * min_req:
            # weak: widen the window from the refined pose once (ref
            # Tracking.cc:2377-2392)
            frame.mp[osel[~inl]] = -1
            inl, osel = search_and_opt(3.0, count_stats=False)
        # full re-association from the whole local map, iterated until the
        # pose stops moving (pruned inliers can return)
        for it in range(3):
            t_before = frame.t.copy()
            frame.mp = np.full(frame.feats.n, -1, np.int32)
            inl, osel = search_and_opt(1.0, count_stats=(it == 2))
            if np.linalg.norm(frame.t - t_before) < 1e-4:
                if it < 2:  # stats not counted yet this frame
                    m.mp_visible[frame.mp[frame.mp >= 0]] += 1
                break
        m.mp_found[frame.mp[osel[inl]]] += 1
        frame.mp[osel[~inl]] = -1
        self.n_inliers = int(inl.sum())
        if self.n_inliers >= min_req and self.only_tracking:
            self.vo_mode = False  # back on the map (ref mbVO=false)
        return self.n_inliers >= min_req

    # -------------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: Frame):
        """ref: NeedNewKeyFrame (Tracking.cc:2089) — c1a/c1b + c2, with the
        reference KF's WELL-OBSERVED points as the baseline (ref
        TrackedMapPoints(nMinObs=3), Tracking.cc:2113); stereo and RGB-D
        use the tighter thRefRatio of 0.75 (:2182)."""
        cfg = self.cfg.tracking
        m = self.map
        if self.ref_kf < 0:
            return False
        min_obs = 3 if len(m.valid_kf_ids()) > 2 else 1
        mp = m.kf_mp[self.ref_kf]
        mp = mp[mp >= 0]
        ref_matches = int(sum(
            1 for j in mp if m.mp_valid[int(j)] and len(m.mp_obs[int(j)]) >= min_obs))
        ratio = cfg.kf_ref_ratio if self.sensor == "mono" else min(cfg.kf_ref_ratio, 0.75)
        c1a = self.frames_since_kf >= cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.min_frames_between_kf
        c2 = self.n_inliers < ref_matches * ratio and self.n_inliers > cfg.min_kf_inliers
        return (c1a or (c1b and c2)) and self.n_inliers > cfg.min_kf_inliers

    def _create_keyframe(self, frame: Frame):
        if isinstance(frame.feats, DeviceFeatures):
            # KF features live in the host map store (matching,
            # triangulation read them): materialize once here
            with T.stage("kf.materialize"):
                frame.feats = frame.feats.materialize()
        with T.stage("kf.create"):
            m = self.map
            kf = m.add_keyframe(frame.R, frame.t, frame.feats, frame.time, frame.frame_id,
                                mp_assign=frame.mp)
            if self.sensor != "mono":
                self._spawn_stereo_points(kf, frame, max_new=100)
            m.update_connections(kf)
            if self.use_imu:
                self._attach_kf_inertial(kf, frame)
            self.ref_kf = kf
            self.last_kf = kf
            self.frames_since_kf = 0
            if self.local_mapper is not None:
                self.local_mapper.on_new_keyframe(kf)
                if self.loop_closer is not None:
                    self.loop_closer.on_new_keyframe(kf)
                # poses may have moved during local BA: refresh the frame
                frame.R = m.kf_R[kf].copy()
                frame.t = m.kf_t[kf].copy()
                self._anchor(frame, kf)
                if self.use_imu:
                    self._refresh_inertial_state(kf, frame)
        return kf

    def _attach_kf_inertial(self, kf: int, frame: Frame):
        """Store the preintegration from the previous KF and its raw window
        (ref Tracking::CreateNewKeyFrame keeps mpImuPreintegratedFromLastKF,
        Tracking.cc:2247-2248; temporal chain mPrevKF / mNextKF)."""
        from .inertial import preintegrate_window

        m = self.map
        prev = self.last_kf
        m.kf_prev[kf] = prev
        m.kf_vel[kf] = frame.v if frame.v is not None else 0.0
        m.kf_bg[kf] = m.kf_bg0[kf] = self.bg
        m.kf_ba[kf] = m.kf_ba0[kf] = self.ba
        if prev >= 0:
            m.kf_preint[kf], m.kf_imu[kf] = preintegrate_window(
                self.imu_since_kf, float(m.kf_time[prev]), frame.time, self.bg, self.ba,
                self.imu_calib, self.device)
        # drop the samples a KF window has integrated
        self.imu_since_kf = [s for s in self.imu_since_kf if s[0] > frame.time - 1e-12]

    def _refresh_inertial_state(self, kf: int, frame: Frame):
        """After mapping (IMU init may have rescaled the map, inertial BA
        refines the biases): pull the KF's state back into the tracker (ref
        Tracking::UpdateFrameIMU Tracking.cc:2993); the next frame
        re-anchors at this KF (ref mbMapUpdated, Tracking.cc:2004-2010)."""
        m = self.map
        self.bg = m.kf_bg[kf].copy()
        self.ba = m.kf_ba[kf].copy()
        self.prior = None
        if m.imu_initialized:
            frame.v = m.kf_vel[kf].copy()
        self.map_version_seen = m.map_version
