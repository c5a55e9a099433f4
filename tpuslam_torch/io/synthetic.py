"""Synthetic rendered sequences with exact ground truth
(port of tpuslam/io/synthetic.py, on the host).

A ray-cast "textured room": the camera flies a smooth trajectory inside a
box whose five faces carry procedural textures; rendering is exact
projection with bilinear texture sampling, through a pinhole or any
camera model (a fisheye's rays come from camera.unproject on the pixel
grid, in f64 on the CPU). For the same seed and parameters the pinhole
frames are bitwise equal to the JAX package's; fisheye frames agree to
the rounding of the unprojection.

Ported: the textures, the room, the trajectory with its closed-form
derivatives, the renderer (pinhole or camera-model pixel rays, one ray
cast) with the exact depth output, the perfect IMU samples (`imu_between`, bitwise equal to
tpuslam's) and `SyntheticSequence.frame` / `frame_rgbd` / `timestamps` /
`gt_pose_cw`, with a camera pair and rig extrinsic for fisheye stereo.
Not ported: the on-disk render cache (a sequence keeps each camera's
pixel rays instead, so a frame costs only the ray cast).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GRAVITY = 9.81


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

    def vel(self, t):
        t = np.asarray(t, np.float64)
        z = np.zeros_like(t)
        if self.kind == "loop":
            c, r, w = self._loop_params
            return np.stack([
                -r * w * np.sin(w * t), r * w * np.cos(w * t),
                0.1 * 0.3 * np.cos(0.3 * t)], -1)
        dwob = 0.18 * 1.5 * np.cos(1.5 * t) if self.kind == "vi_excite" else z
        return np.stack(
            [self.speed + z,
             0.6 * 0.4 * np.cos(0.4 * t) + dwob,
             0.3 * 0.3 * np.cos(0.3 * t + 1.0)],
            -1,
        )

    def acc(self, t):
        t = np.asarray(t, np.float64)
        z = np.zeros_like(t)
        if self.kind == "loop":
            c, r, w = self._loop_params
            return np.stack([
                -r * w * w * np.cos(w * t), -r * w * w * np.sin(w * t),
                -0.1 * 0.09 * np.sin(0.3 * t)], -1)
        awob = -0.18 * 2.25 * np.sin(1.5 * t) if self.kind == "vi_excite" else z
        return np.stack(
            [z, -0.6 * 0.16 * np.sin(0.4 * t) + awob,
             -0.3 * 0.09 * np.sin(0.3 * t + 1.0)], -1
        )

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

    def yaw_pitch_rates(self, t):
        t = np.asarray(t, np.float64)
        if self.kind == "loop":
            c, r, w = self._loop_params
            return w + np.zeros_like(t), 0.03 * 0.2 * np.cos(0.2 * t)
        dyaw = 0.08 * 0.25 * np.cos(0.25 * t)
        dpitch = 0.05 * 0.2 * np.cos(0.2 * t + 0.5)
        return dyaw, dpitch

    def omega_world(self, t):
        dyaw, dpitch = self.yaw_pitch_rates(t)
        yaw, _ = self.yaw_pitch(t)
        # omega = dyaw * ez + dpitch * (Rz ey)
        ez = np.array([0.0, 0.0, 1.0])
        ey = np.array([0.0, 1.0, 0.0])
        cz, sz_ = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[cz, -sz_, 0], [sz_, cz, 0], [0, 0, 1]])
        return dyaw * ez + dpitch * (Rz @ ey)

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


def pixel_rays(height, width, fx, fy, cx, cy, camera=None):
    """[H,W,3] z = 1 camera-frame rays of the pixel grid: perspective rays
    from fx..cy, or camera.unproject of the grid (f64, CPU) for any other
    camera model (e.g. KannalaBrandt8)."""
    ys, xs = np.mgrid[0:height, 0:width]
    if camera is not None:
        uv = torch.as_tensor(np.stack([xs, ys], -1).astype(np.float64).reshape(-1, 2))
        return camera.unproject(uv).numpy().reshape(height, width, 3)
    return np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], -1)


def render(planes, rays_c, Rcw, tcw, return_depth=False):
    """Exact ray-cast of the textured room along the [H,W,3] camera-frame
    rays of `pixel_rays` from the pose Tcw -> [H,W] f32 image.
    return_depth: also return the exact per-pixel camera-frame z (the ray
    parameter equals z for z-normalized rays; 0 = no hit), as a perfect
    depth sensor would (the RGB-D path)."""
    height, width = rays_c.shape[:2]
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
    if return_depth:
        z = best_t * rays_c[..., 2]
        return img, np.where(np.isfinite(best_t), z, 0.0).astype(np.float32)
    return img


class SyntheticSequence:
    """Mono / stereo sequence generator with ground-truth poses and IMU."""

    def __init__(self, seed=0, height=240, width=376, fx=200.0, fy=200.0,
                 cx=None, cy=None, fps=10.0, n_frames=40, speed=0.5,
                 baseline=0.1, imu_rate=200.0, kind="forward_arc", camera=None,
                 camera2=None, Trl=None):
        """camera/camera2: an optional camera-model pair for non-pinhole
        (fisheye) rendering, which then sets the image size and
        intrinsics; Trl [4x4] right-from-left rig extrinsic (default: a
        pure x-baseline)."""
        rng = np.random.RandomState(seed)
        self.planes = make_room(rng)
        self.traj = Trajectory(kind=kind, speed=speed)
        self.height, self.width = height, width
        self.camera = camera
        self.camera2 = camera2
        if camera is not None:
            fx, fy = camera.fx, camera.fy
            cx, cy = camera.cx, camera.cy
            self.height, self.width = camera.height, camera.width
        self.fx, self.fy = fx, fy
        self.cx = cx if cx is not None else width / 2.0
        self.cy = cy if cy is not None else height / 2.0
        self.fps = fps
        self.n_frames = n_frames
        self.baseline = baseline
        self.imu_rate = imu_rate
        if Trl is None:
            Trl = np.eye(4)
            Trl[:3, 3] = [-baseline, 0.0, 0.0]
        self.Trl = np.asarray(Trl, np.float64)
        self._rays = {}

    def _rays_of(self, right):
        """The pixel rays of the left or right camera, computed once."""
        if right not in self._rays:
            cam = self.camera2 if right and self.camera2 is not None else self.camera
            self._rays[right] = pixel_rays(self.height, self.width, self.fx, self.fy, self.cx,
                                           self.cy, cam)
        return self._rays[right]

    def timestamps(self):
        return np.arange(self.n_frames) / self.fps

    def gt_pose_cw(self, t):
        return self.traj.pose_cw(t)

    def frame(self, i, right=False):
        Rcw, tcw = self.traj.pose_cw(i / self.fps)
        if right:
            # right camera: Tc2w = Trl * Tcw
            R_rl, t_rl = self.Trl[:3, :3], self.Trl[:3, 3]
            Rcw, tcw = R_rl @ Rcw, R_rl @ tcw + t_rl
        return render(self.planes, self._rays_of(right), Rcw, tcw)

    def frame_rgbd(self, i):
        """(image, depth) for the RGB-D path; depth is the renderer's exact
        camera-frame z."""
        Rcw, tcw = self.traj.pose_cw(i / self.fps)
        return render(self.planes, self._rays_of(False), Rcw, tcw, return_depth=True)

    def imu_between(self, t0, t1):
        """Perfect IMU samples in (t0, t1]: (t, gyro_body [3], acc_body [3]).

        The accelerometer measures specific force, a_body = R_cw (a_world -
        g) with g = (0, 0, -9.81), so at rest it reads +g up. Body frame ==
        camera frame (Tbc = I)."""
        dt = 1.0 / self.imu_rate
        ts = np.arange(np.floor(t0 / dt) * dt + dt, t1 + 1e-9, dt)
        out_t, out_w, out_a = [], [], []
        g_world = np.array([0.0, 0.0, -GRAVITY])
        for t in ts:
            Rcw, _ = self.traj.pose_cw(t)
            out_t.append(t)
            out_w.append(Rcw @ self.traj.omega_world(t))
            out_a.append(Rcw @ (self.traj.acc(t) - g_world))
        return np.array(out_t), np.array(out_w), np.array(out_a)
