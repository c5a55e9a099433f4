"""Two monocular sessions over one place, for the tests of the monocular
Atlas merge (tests/test_torch_mono_merge*.py) and
tests/make_mono_merge_data.py. Imports only the port and numpy.

The room: `SyntheticSequence(seed=0)` (376x240, fx = fy = 200, the forward
arc at 0.5 m/s), 10 fps, 650 features, a keyframe at least every 3 frames.
Session A is frames 0-19 from its own first camera; B is frames 16-29,
stamped from 100 s (after all of A's stamps), so it opens its map where A's
frame 16 was. A monocular map's unit is the median depth of its two-view
init; B initializes where the room's side wall is nearer than it was from
A's first camera, so B's units are smaller: the merge's Sim3 scale (B's
units per A unit) is 1.176 in both packages. The sessions' Horn scales,
each aligned alone, average a map's scale over all its frames: without a
merge they are 5.78 and 5.45 m per unit (the port on the CPU, a ratio of
1.061), after it 5.75 and 5.79.

At 700 features the two packages part on A's frame 13, where the
keyframe decision sits on its border (169 inliers against 0.9 x the
reference keyframe's tracked points, the maps one point apart since frame
9, the solvers in f32); at 650 they track alike to the merge.

The vocabulary is trained here on ORB descriptors of frames 0, 6, 12 and
18 and written in the reference's text format, which both packages load.
"""

import importlib.util
import os

import numpy as np
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine.config import LoopConfig, OrbConfig, SlamConfig, TrackingConfig
from tpuslam_torch.engine.frontend import Frontend
from tpuslam_torch.engine.system import Sensor, System
from tpuslam_torch.eval.ate import associate, horn_align
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.place import load_orbvoc, save_orbvoc_text, train_vocabulary

FPS, N_FEATURES, MAX_KF_FRAMES = 10.0, 650, 3
N_A, START_B, N_B, T0_B = 20, 16, 14, 100.0
VOCAB_FRAMES = (0, 6, 12, 18)
SCALE_RATIO = 1.10      # the merge's Sim3 scale is further than this from 1
SCALE_AGREE = 0.05      # each session's Horn scale after the merge, relative
ATE_GATE = 0.10         # tests/test_e2e_mono.py's scaled ATE on this room


def _script():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "make_synth_euroc_torch.py")
    spec = importlib.util.spec_from_file_location("make_synth_euroc_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def room():
    """(seq, frames, sessions): the sequence, its rendered frames and the
    two sessions (SessionViews of it)."""
    seq = SyntheticSequence(seed=0, n_frames=START_B + N_B, fps=FPS, speed=0.5)
    frames = [seq.frame(i) for i in range(seq.n_frames)]
    view = _script().SessionView
    return seq, frames, [view(seq, 0, N_A, 0.0), view(seq, START_B, N_B, T0_B)]


def camera_of(seq):
    return [seq.fx, seq.fy, seq.cx, seq.cy], seq.width, seq.height


def vocabulary(seq, frames, path):
    """Train the vocabulary on frames VOCAB_FRAMES and write it to path."""
    fe = Frontend(Pinhole(*camera_of(seq)), OrbConfig(n_features=N_FEATURES), device="cpu")
    bits = [f.bits[f.valid] for f in (fe.process(frames[i]) for i in VOCAB_FRAMES)]
    save_orbvoc_text(train_vocabulary(np.concatenate(bits), k=8, L=3, iters=5, device="cpu"),
                     path)
    return path


def config():
    return SlamConfig(orb=OrbConfig(n_features=N_FEATURES),
                      tracking=TrackingConfig(max_frames_between_kf=MAX_KF_FRAMES),
                      loop=LoopConfig(background_gba=False))


def port_system(seq, voc=None, dtype=torch.float32):
    """The port's MONOCULAR System on the CPU (synchronous GBA)."""
    cam, w, h = camera_of(seq)
    return System(Pinhole(cam, w, h), config(), sensor=Sensor.MONOCULAR, device="cpu",
                  dtype=dtype, vocab=load_orbvoc(voc) if voc else None)


def drive(slam, frames, sessions, stop_after_merge=False):
    """Feed session A, change_dataset(), then B. Returns the rows (session,
    frame, time, Tcw or None, state name, map ids, keyframes over all maps)
    and the merges [(frame number over both sessions, kf, cand, Sim3
    scale)]. stop_after_merge: stop on the frame of the first merge."""
    lc = slam.loop_closer
    rows, merges, n_seen = [], [], [0]
    if lc is not None:
        real = lc._correct_loop

        def correct(kf, cand, s, *a, merge=False, **kw):
            if merge:
                merges.append((n_seen[0], int(kf), int(cand), float(s)))
            return real(kf, cand, s, *a, merge=merge, **kw)

        lc._correct_loop = correct
    for s_i, sess in enumerate(sessions):
        if s_i:
            slam.change_dataset()
        for i, t in enumerate(sess.timestamps()):
            Tcw = slam.track_monocular(frames[sess.start + i], float(t))
            m = slam.map
            rows.append((s_i, i, float(t), None if Tcw is None else np.asarray(Tcw),
                         slam.get_tracking_state().name, m.map_ids(),
                         len(m.valid_kf_ids(all_maps=True))))
            n_seen[0] += 1
            if stop_after_merge and merges:
                return rows, merges
    slam.shutdown()
    return rows, merges


def gt_centers(sessions, times):
    """Ground-truth camera centres at the stamps, in the room's world frame."""
    out = []
    for t in times:
        sess = sessions[1] if t >= sessions[1].t0 else sessions[0]
        R, tt = sess.gt_pose_cw(t)
        out.append(-R.T @ tt)
    return np.asarray(out)


def session_gates(sessions, traj):
    """From trajectory rows (t, x, y, z, ...): the joint scaled ATE (one Sim3
    alignment of both sessions' rows to both trees' ground truth) and each
    session's Horn scale aligned alone, with the rows per session."""
    traj = np.asarray(traj, np.float64)
    t_gt = np.concatenate([s.timestamps() for s in sessions])
    i_e, i_g = associate(traj[:, 0], t_gt)
    assert len(i_e) == len(traj)
    est, gt = traj[:, 1:4], gt_centers(sessions, traj[:, 0])
    _, _, _, res = horn_align(est, gt, with_scale=True)
    out = dict(ate=float(np.sqrt((res ** 2).mean())), scales=[], rows=[])
    for sess in sessions:
        sel = (traj[:, 0] >= sess.t0) & (traj[:, 0] < sess.t0 + sess.n_frames / sess.fps)
        out["scales"].append(float(horn_align(est[sel], gt[sel], with_scale=True)[2]))
        out["rows"].append(int(sel.sum()))
    return out


def init_ba_on_its_points(real):
    """tpuslam's Tracker._initial_ba `real` held to the port's repair: it
    solves only the points of the two new keyframes (tpuslam's takes every
    valid point of the Atlas, so a young map's init solves the older maps'
    points too, each of their observations read as one of kf1's). The other
    points are hidden from it for the call."""
    def initial_ba(self, kf0, kf1):
        m = self.map
        hidden = np.setdiff1d(m.valid_mp_ids(), m.points_in_kfs([kf0, kf1]))
        m.mp_valid[hidden] = False
        try:
            return real(self, kf0, kf1)
        finally:
            m.mp_valid[hidden] = True

    return initial_ba
