"""Synthetic rendered sequences with exact ground truth
(port of tpuslam/io/synthetic.py, numpy only).

A ray-cast "textured room": the camera flies a smooth trajectory inside a
box whose five faces carry procedural textures; rendering is exact
perspective projection with bilinear texture sampling. For the same seed
and parameters the frames are bitwise equal to the JAX package's.

Ported: the textures, the room, the trajectory, the pinhole renderer and
`SyntheticSequence.frame` / `gt_pose_cw`. Not ported: the fisheye
(camera.unproject) rendering branch, the IMU samples with the trajectory
derivatives they need, and the on-disk render cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _smooth_texture(rng, n=512, octaves=5):
    """Multi-octave value noise + distinct landmark marks, in [0,255].

    Pure value noise is self-similar: every patch looks like every other
    patch, so BRIEF descriptors are weakly distinctive and the matchers'
    ratio tests (ref ORBmatcher mfNNratio) starve. Real indoor scenes —
    the reference's target domain — carry distinct structure (posters,
    outlets, furniture edges), so the synthetic world gets the same:
    high-contrast rectangles, discs and line segments scattered over the
    noise base, each with its own intensity. This makes descriptors
    locally unique without changing the renderer.
    """
    tex = np.zeros((n, n))
    for o in range(octaves):
        k = 8 << o
        coarse = rng.rand(k, k)
        # bilinear upsample to n x n
        yi = np.linspace(0, k - 1, n)
        xi = np.linspace(0, k - 1, n)
        y0 = np.clip(yi.astype(int), 0, k - 2)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        c = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        tex += c / (1 << o)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    # distinct landmark marks: rectangles, discs, line segments
    yy, xx = np.mgrid[0:n, 0:n]
    for _ in range(40):
        shape = rng.randint(3)
        cy_, cx_ = rng.randint(0, n, 2)
        val = rng.uniform(0.0, 1.0)
        alpha = rng.uniform(0.55, 0.95)
        if shape == 0:  # axis-aligned rectangle (poster/panel)
            hh, ww_ = rng.randint(6, 40, 2)
            m = (np.abs(yy - cy_) < hh) & (np.abs(xx - cx_) < ww_)
        elif shape == 1:  # disc
            rad = rng.randint(4, 24)
            m = (yy - cy_) ** 2 + (xx - cx_) ** 2 < rad * rad
        else:  # thick line segment
            ang = rng.uniform(0, np.pi)
            length = rng.randint(20, 90)
            thick = rng.randint(2, 5)
            d_par = (xx - cx_) * np.cos(ang) + (yy - cy_) * np.sin(ang)
            d_perp = -(xx - cx_) * np.sin(ang) + (yy - cy_) * np.cos(ang)
            m = (np.abs(d_par) < length) & (np.abs(d_perp) < thick)
        tex = np.where(m, (1 - alpha) * tex + alpha * val, tex)
    return (tex * 255.0).astype(np.float32)


@dataclasses.dataclass
class Plane:
    origin: np.ndarray  # a point on the plane
    normal: np.ndarray  # unit, pointing into the room
    u_axis: np.ndarray  # texture axes
    v_axis: np.ndarray
    extent_u: float
    extent_v: float
    texture: np.ndarray


def make_room(rng, size=(10.0, 6.0, 4.0)):
    """Box interior [0,sx]x[0,sy]x[0,sz]; camera flies inside looking +x."""
    sx, sy, sz = size
    planes = []

    def plane(origin, normal, ua, va, eu, ev):
        planes.append(
            Plane(
                np.array(origin, np.float64),
                np.array(normal, np.float64),
                np.array(ua, np.float64),
                np.array(va, np.float64),
                eu,
                ev,
                _smooth_texture(rng),
            )
        )

    plane([sx, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, 1], sy, sz)  # far wall
    plane([0, 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1], sx, sz)    # left wall
    plane([0, sy, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], sx, sz)  # right wall
    plane([0, 0, 0], [0, 0, 1], [1, 0, 0], [0, 1, 0], sx, sy)    # floor
    plane([0, 0, sz], [0, 0, -1], [1, 0, 0], [0, 1, 0], sx, sy)  # ceiling
    return planes


class Trajectory:
    """Smooth C^inf trajectory with closed-form derivatives.

    World frame: x forward, y left-ish, z up. Camera frame: z forward
    (optical axis), x right, y down — R_wc maps camera->world.
    """

    def __init__(self, kind="forward_arc", speed=0.5, room=(10.0, 6.0, 4.0)):
        self.kind = kind
        self.speed = speed
        self.room = room

    @property
    def _loop_params(self):
        sx, sy, sz = self.room
        r = 1.6
        w = self.speed / r
        return np.array([sx / 2, sy / 2]), r, w

    def pos(self, t):
        t = np.asarray(t, np.float64)
        sx, sy, sz = self.room
        if self.kind == "loop":
            c, r, w = self._loop_params
            x = c[0] + r * np.cos(w * t)
            y = c[1] + r * np.sin(w * t)
            z = sz / 2 + 0.1 * np.sin(0.3 * t)
            return np.stack([x, y, np.broadcast_to(z, np.shape(x))], -1)
        # vi_excite: ~0.7 m/s^2 peak accelerometer excitation, LATERAL.
        # Mono-VI scale observability needs accel * dT^2 well above the
        # visual pose noise over a KF interval — the old 0.35*sin(0.8t)
        # wobble peaked at 0.22 m/s^2, leaving scale SNR < 1 per edge on
        # short windows (round-5 init analysis; EuRoC MAV motion is
        # ~1 m/s^2). The wobble lives on Y (lateral), NOT the forward
        # axis: forward surge periodically cancels the net translation
        # and starves mono parallax (measured: x-axis wobble at matched
        # amplitude drove 7x scale inconsistency across map regions —
        # the same degeneracy the oblique-viewing note below describes).
        wob = 0.18 * np.sin(1.5 * t) if self.kind == "vi_excite" else 0.0
        x = 1.0 + self.speed * t
        y = sy / 2 + 0.6 * np.sin(0.4 * t) + wob
        z = sz / 2 + 0.3 * np.sin(0.3 * t + 1.0)
        return np.stack([x, y, z], -1)

    def yaw_pitch(self, t):
        t = np.asarray(t, np.float64)
        if self.kind == "loop":
            c, r, w = self._loop_params
            # look along the tangent of the circle
            return w * t + np.pi / 2, 0.03 * np.sin(0.2 * t)
        # constant oblique viewing direction (~26 deg off the direction of
        # travel) + wobble: pure forward-creep viewing gives near-zero
        # parallax on most of the image (depth errors 50-200% at half-pixel
        # noise), which no amount of solver quality can fix — mono SLAM is
        # then scale-unstable by geometry. The reference's benchmark
        # sequences (EuRoC machine hall) likewise carry rich view-oblique
        # motion.
        yaw = 0.45 + 0.08 * np.sin(0.25 * t)
        pitch = 0.05 * np.sin(0.2 * t + 0.5)
        return yaw, pitch

    def R_wc(self, t):
        """camera->world. Base orientation: optical axis +x(world), camera
        x right = -y(world), camera y down = -z(world)."""
        yaw, pitch = self.yaw_pitch(t)
        base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
        # yaw about world z, pitch about world y
        cz, sz_ = np.cos(yaw), np.sin(yaw)
        cy, sy_ = np.cos(pitch), np.sin(pitch)
        Rz = np.array([[cz, -sz_, 0], [sz_, cz, 0], [0, 0, 1]])
        Ry = np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]])
        return Rz @ Ry @ base

    def pose_cw(self, t):
        """Tcw (world->camera) as (R, t)."""
        Rwc = self.R_wc(t)
        p = self.pos(t)
        Rcw = Rwc.T
        return Rcw, -Rcw @ p


def render(planes, Rcw, tcw, height, width, fx, fy, cx, cy):
    """Exact pinhole ray-cast of the textured room -> [H,W] f32 image."""
    ys, xs = np.mgrid[0:height, 0:width]
    rays_c = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], -1
    )
    Rwc = Rcw.T
    origin = -Rwc @ tcw
    rays_w = rays_c @ Rwc.T  # [H,W,3]
    best_t = np.full((height, width), np.inf)
    img = np.zeros((height, width), np.float32)
    for pl in planes:
        denom = rays_w @ pl.normal
        num = (pl.origin - origin) @ pl.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num / denom
        t = np.nan_to_num(t, nan=-1.0, posinf=-1.0, neginf=-1.0)
        hit = (t > 0.05) & (t < best_t) & (np.abs(denom) > 1e-9)
        if not hit.any():
            continue
        P = origin[None, None] + rays_w * t[..., None]
        du = np.nan_to_num((P - pl.origin) @ pl.u_axis)
        dv = np.nan_to_num((P - pl.origin) @ pl.v_axis)
        inside = hit & (du >= 0) & (du <= pl.extent_u) & (dv >= 0) & (dv <= pl.extent_v)
        if not inside.any():
            continue
        n = pl.texture.shape[0]
        tu = np.clip(du / pl.extent_u * (n - 1), 0, n - 1.001)
        tv = np.clip(dv / pl.extent_v * (n - 1), 0, n - 1.001)
        u0 = tu.astype(int)
        v0 = tv.astype(int)
        fu = tu - u0
        fv = tv - v0
        tex = pl.texture
        val = (
            tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, np.minimum(u0 + 1, n - 1)] * fu * (1 - fv)
            + tex[np.minimum(v0 + 1, n - 1), u0] * (1 - fu) * fv
            + tex[np.minimum(v0 + 1, n - 1), np.minimum(u0 + 1, n - 1)] * fu * fv
        )
        img = np.where(inside, val, img)
        best_t = np.where(inside, t, best_t)
    return img


class SyntheticSequence:
    """Stereo pinhole sequence generator with ground-truth poses."""

    def __init__(self, seed=0, height=240, width=376, fx=200.0, fy=200.0,
                 cx=None, cy=None, fps=10.0, n_frames=40, speed=0.5,
                 baseline=0.1, kind="forward_arc", Trl=None):
        """Trl [4x4] right-from-left rig extrinsic (default: a pure
        x-baseline)."""
        rng = np.random.RandomState(seed)
        self.planes = make_room(rng)
        self.traj = Trajectory(kind=kind, speed=speed)
        self.height, self.width = height, width
        self.fx, self.fy = fx, fy
        self.cx = cx if cx is not None else width / 2.0
        self.cy = cy if cy is not None else height / 2.0
        self.fps = fps
        self.n_frames = n_frames
        self.baseline = baseline
        if Trl is None:
            Trl = np.eye(4)
            Trl[:3, 3] = [-baseline, 0.0, 0.0]
        self.Trl = np.asarray(Trl, np.float64)

    def gt_pose_cw(self, t):
        return self.traj.pose_cw(t)

    def frame(self, i, right=False):
        Rcw, tcw = self.traj.pose_cw(i / self.fps)
        if right:
            # right camera: Tc2w = Trl * Tcw
            R_rl, t_rl = self.Trl[:3, :3], self.Trl[:3, 3]
            Rcw, tcw = R_rl @ Rcw, R_rl @ tcw + t_rl
        return render(self.planes, Rcw, tcw, self.height, self.width,
                      self.fx, self.fy, self.cx, self.cy)
