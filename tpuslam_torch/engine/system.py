"""System facade — the public API (port of tpuslam/engine/system.py).

Mirrors the reference System (include/System.h:85-189): the constructor
wires the tracker, the local mapper and, with a vocabulary, the loop
closer (synchronous, or behind parallel/async_mapping.AsyncMapper's
worker thread), TrackMonocular / TrackStereo (a rectified pinhole pair
or a fisheye rig) / TrackRGBD, state queries, localization mode, resets,
Shutdown (which also joins a background global BA), the trajectory
savers, SaveDebugData and the map checkpoint. Tracking, mapping and
loop closing run on one explicit device; the map is host state. The
threads issue device work on the default stream, so their work serialises
there.
"""

from __future__ import annotations

import enum
import json

import numpy as np
import torch

from ..core import lie
from ..map.checkpoint import load_map, save_map
from ..map.store import SlamMap
from ..parallel import dist_ba
from ..parallel.async_mapping import AsyncMapper
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.timing import GLOBAL_TIMER
from .config import SlamConfig
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .tracking import Tracker


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


def _quat_rows(rows):
    """[(t, R cw, t cw)] -> [(t, x, y, z, qx, qy, qz, qw)] camera-to-world."""
    if not rows:
        return []
    t = [r[0] for r in rows]
    R = torch.as_tensor(np.stack([r[1] for r in rows]), dtype=torch.float64)
    tt = torch.as_tensor(np.stack([r[2] for r in rows]), dtype=torch.float64)
    Rwc, twc = lie.se3_inverse(R, tt)
    q = lie.rot_to_quat(Rwc).numpy()
    p = twc.numpy()
    return [(t[i], p[i, 0], p[i, 1], p[i, 2], q[i, 0], q[i, 1], q[i, 2], q[i, 3])
            for i in range(len(rows))]


class System:
    def __init__(self, camera, cfg: SlamConfig | None = None,
                 sensor: Sensor = Sensor.MONOCULAR, imu_calib=None, vocab=None,
                 bf: float = 0.0, async_mapping: bool = False, camera2=None, Tlr=None,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        """imu_calib: an imu.preintegration.ImuCalib, required by the
        inertial sensors (IMU_MONOCULAR, IMU_STEREO), which then take
        `imu=` sample batches per frame. vocab: a place.BinaryVocabulary;
        enables loop closing and BoW relocalization (ref: System ctor loads
        ORBvoc, System.cc:85).
        bf: fx * baseline in pixels (ref Camera.bf) for stereo / RGB-D.
        async_mapping: run local mapping and loop closing on a worker
        thread (the reference's LocalMapping / LoopClosing threads).
        camera2/Tlr: the right camera of a fisheye (KB8) stereo rig and the
        left<-right extrinsic 4x4 (ref Camera2.* + Tlr settings,
        src/Tracking.cc:95-134); they enable the fisheye stereo path.
        device: where extraction, matching, the solvers, the mapping
        kernels and BA run: the card by default, "cpu" where asked (without
        a card the default raises); dtype: the solvers' float
        type (f32, as on the card). The default sensor is MONOCULAR, as in
        tpuslam."""
        use_imu = sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
        if use_imu and imu_calib is None:
            raise ValueError("inertial sensor requires imu_calib")
        self.cfg = cfg or SlamConfig()
        self.camera = camera
        self.camera2 = camera2
        self.sensor = sensor
        self.device = resolve_device(device)
        self.map = SlamMap(self.cfg.orb.n_features, scale=self.cfg.orb.scale,
                           n_levels=self.cfg.orb.n_levels)
        mono = sensor in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
        imu_calib = imu_calib if use_imu else None
        self.local_mapper = LocalMapper(camera, self.cfg, self.map, bf=bf, imu_calib=imu_calib,
                                        mono=mono, device=self.device, dtype=dtype)
        self.loop_closer = None
        if vocab is not None:
            self.loop_closer = LoopCloser(camera, self.cfg, self.map, vocab,
                                          fix_scale=not mono or use_imu,
                                          local_mapper=self.local_mapper,
                                          device=self.device, dtype=dtype)
            self.local_mapper.loop_closer = self.loop_closer
        self.async_mapper = None
        mapper_for_tracker = self.local_mapper
        closer_for_tracker = self.loop_closer
        if async_mapping:
            self.async_mapper = AsyncMapper(self.local_mapper, self.loop_closer, self.map.lock)
            mapper_for_tracker = self.async_mapper
            closer_for_tracker = None  # the worker thread runs it
        self.tracker = Tracker(camera, self.cfg, self.map, mapper_for_tracker,
                               sensor="mono" if mono else "stereo", bf=bf,
                               loop_closer=closer_for_tracker, imu_calib=imu_calib,
                               camera2=camera2, Tlr=Tlr, device=self.device, dtype=dtype)

    # ------------------------------------------------------------------ API
    def _pose(self, frame):
        if frame.R is None:
            return None
        T = np.eye(4)
        T[:3, :3] = frame.R
        T[:3, 3] = frame.t
        return T

    def _check_sensor(self, entry, *sensors):
        if self.sensor not in sensors:
            raise ValueError(f"{entry} on a {self.sensor.name} System")

    def track_monocular(self, img, timestamp: float, imu=None):
        """Returns Tcw 4x4 (None before initialization); ref:
        System::TrackMonocular (System.cc:352). imu: [N,7] samples (t, wx,
        wy, wz, ax, ay, az) since the last frame, as the mono-inertial
        drivers pass them (ref src/main_vi.cpp:174)."""
        self._check_sensor("track_monocular", Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
        return self._pose(self.tracker.track(img, timestamp, imu=imu))

    def track_rgbd(self, img, depth, timestamp: float, imu=None):
        """ref: System::TrackRGBD (System.cc:294); depth in the units that
        SlamConfig.depth_map_factor scales to meters: metres with the
        default 1.0, the raw image with a settings file's 1 / DepthMapFactor
        (as run.py passes it). RGB-D frames take the host tracking path; on
        an IMU_STEREO System (tpuslam's inertial route for depth frames) they
        carry `imu=` samples."""
        self._check_sensor("track_rgbd", Sensor.RGBD, Sensor.IMU_STEREO)
        return self._pose(self.tracker.track(img, timestamp, depth=depth, imu=imu))

    def track_stereo(self, img_left, img_right, timestamp: float, imu=None):
        """Returns Tcw 4x4 (None before initialization); ref:
        System::TrackStereo (System.cc:228). With TrackingConfig(
        pipelined=True) a frame on the fused path is still in flight when
        this returns (None); its pose reaches the trajectory when the next
        frame completes it, or at shutdown(). imu: as for
        track_monocular, on an IMU_STEREO System."""
        self._check_sensor("track_stereo", Sensor.STEREO, Sensor.IMU_STEREO)
        return self._pose(self.tracker.track(img_left, timestamp, img_right=img_right, imu=imu))

    def get_tracking_state(self):
        return self.tracker.state

    def get_tracked_map_points(self):
        """Per-feature map-point ids of the last frame, -1 = untracked
        (ref: System::GetTrackedMapPoints System.h:170)."""
        f = self.tracker.last_frame
        if f is None or f.mp is None:
            return np.full(0, -1, np.int32)
        return f.mp.copy()

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints of the last frame
        (ref: System::GetTrackedKeyPointsUn System.h:171)."""
        f = self.tracker.last_frame
        if f is None:
            return np.zeros((0, 2))
        return f.feats.und_xy.copy()

    # --------------------------------------------------------------- modes
    def activate_localization_mode(self):
        """Freeze the map: tracking only, no keyframe insertion
        (ref: System::ActivateLocalizationMode System.h:122)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """ref: System::DeactivateLocalizationMode (System.h:124)."""
        self.tracker.only_tracking = False

    def reset(self):
        """Clear the whole Atlas and the tracker state (ref: System::Reset)."""
        self.tracker.reset()

    def reset_active_map(self):
        """ref: System::ResetActiveMap (System.h:132)."""
        self.tracker.reset_active_map()

    def change_dataset(self):
        """Multi-session runs: the next frame opens a new Atlas map
        (ref: System::ChangeDataset System.h:178)."""
        self.tracker._force_new_map = True

    def shutdown(self):
        """ref: System::Shutdown (System.cc:487) — settle the tracking
        pipeline, join the mapping worker and the background global BA.
        Worker errors stay in `async_mapper.errors` (AsyncMapper.flush
        raises them). On rank 0 of a process group of more than one rank it
        then releases the ranks serving the distributed solves
        (parallel/dist_ba.serve)."""
        self.tracker._flush_pipeline()
        self.tracker.last_frame = self.tracker._last_completed or self.tracker.last_frame
        if self.async_mapper is not None:
            self.async_mapper.shutdown()
        if self.loop_closer is not None:
            self.loop_closer.wait_gba()
        dist_ba.release_followers()

    # ------------------------------------------------------------ trajectory
    def _ref_pose(self, ref_kf: int):
        """Current world pose of a (possibly culled) reference KF: walk the
        spanning tree composing the stored cull-time relatives
        (ref: System::SaveTrajectoryTUM System.cc:525-540)."""
        m = self.map
        Ra = np.eye(3)
        ta = np.zeros(3)
        k = ref_kf
        while k >= 0 and not m.kf_valid[k] and m.kf_tcp[k] is not None:
            Rcp, tcp = m.kf_tcp[k]
            ta = Ra @ tcp + ta
            Ra = Ra @ Rcp
            k = int(m.kf_parent[k])
        if k < 0 or not m.kf_valid[k]:
            return None
        return Ra @ m.kf_R[k], Ra @ m.kf_t[k] + ta

    def _frame_poses(self):
        """[(t, Rcw, tcw)] of every logged frame, composed with its
        reference KF's CURRENT pose."""
        rows = []
        for (t, Rcr, tcr, ref_kf, _lost) in self.tracker.trajectory:
            ref = self._ref_pose(ref_kf)
            if ref is not None:
                Rr, tr_ = ref
                rows.append((t, Rcr @ Rr, Rcr @ tr_ + tcr))
        return rows

    def trajectory_tum(self):
        """[(t, x, y, z, qx, qy, qz, qw)] camera-to-world per tracked frame
        (ref format: System::SaveTrajectoryTUM System.cc:514)."""
        return _quat_rows(self._frame_poses())

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as fh:
            for row in self.trajectory_tum():
                fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")

    def save_trajectory_euroc(self, path: str):
        """EuRoC format: timestamp[ns] x y z qw qx qy qz
        (ref: System::SaveTrajectoryEuRoC System.cc:607)."""
        with open(path, "w") as fh:
            for (t, x, y, z, qx, qy, qz, qw) in self.trajectory_tum():
                fh.write(f"{int(round(t * 1e9))} {x:.9f} {y:.9f} {z:.9f} "
                         f"{qw:.9f} {qx:.9f} {qy:.9f} {qz:.9f}\n")

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the 12 entries of the 3x4 Twc matrix per line
        (ref: System::SaveTrajectoryKITTI System.cc:782)."""
        with open(path, "w") as fh:
            for (_t, R, tt) in self._frame_poses():
                Rwc = R.T
                row = np.concatenate([Rwc, (-Rwc @ tt)[:, None]], axis=1).reshape(-1)
                fh.write(" ".join(f"{v:.9e}" for v in row) + "\n")

    def keyframe_trajectory_tum(self):
        m = self.map
        return _quat_rows([(m.kf_time[k], m.kf_R[k], m.kf_t[k]) for k in m.valid_kf_ids()])

    def save_keyframe_trajectory_tum(self, path: str):
        """ref: System::SaveKeyFrameTrajectoryTUM (System.cc:574)."""
        with open(path, "w") as fh:
            for row in self.keyframe_trajectory_tum():
                fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")

    def save_keyframe_trajectory_euroc(self, path: str):
        """ref: System::SaveKeyFrameTrajectoryEuRoC (System.cc:730)."""
        with open(path, "w") as fh:
            for (t, x, y, z, qx, qy, qz, qw) in self.keyframe_trajectory_tum():
                fh.write(f"{int(round(t * 1e9))} {x:.9f} {y:.9f} {z:.9f} "
                         f"{qw:.9f} {qx:.9f} {qy:.9f} {qz:.9f}\n")

    def save_debug_data(self, path: str):
        """Debug dump of the run as JSON (ref: System::SaveDebugData
        System.cc:836-889): the mapper's IMU-init and VIBA events with their
        bias estimates, loops closed, map counters, stage timings."""
        m = self.map
        data = dict(
            imu_events=list(self.local_mapper.debug_events),
            loops_closed=self.loop_closer.n_loops_closed if self.loop_closer else 0,
            keyframes=int(len(m.valid_kf_ids(all_maps=True))),
            map_points=int(m.mp_valid[: m.n_mp].sum()),
            maps=[int(x) for x in m.map_ids()],
            imu_initialized=bool(m.imu_initialized),
            tracking_state=self.tracker.state.name,
            stage_ms=GLOBAL_TIMER.summary(),
        )
        with open(path, "w") as fh:
            json.dump(data, fh, indent=1)

    # ---------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str):
        """The map (every keyframe, point, observation and the covisibility
        graph) as one npz of host arrays (map/checkpoint.py)."""
        save_map(self.map, path)

    def load_checkpoint(self, path: str):
        load_map(self.map, path)
