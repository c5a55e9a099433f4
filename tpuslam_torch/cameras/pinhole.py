"""Pinhole camera with optional radial-tangential distortion
(port of tpuslam/cameras/pinhole.py).

params = [fx, fy, cx, cy]; distortion = [k1, k2, p1, p2(, k3)] kept
separately, like the reference's mDistCoef.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CameraModel


class Pinhole(CameraModel):
    kind = "pinhole"

    def __init__(self, params, width, height, dist=None):
        super().__init__(params[:4], width, height)
        self.dist = np.zeros(5, np.float32)
        if dist is not None:
            d = np.asarray(dist, np.float32).ravel()
            self.dist[: d.size] = d

    def project(self, Xc):
        z = Xc[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = self.fx * Xc[..., 0] * inv_z + self.cx
        v = self.fy * Xc[..., 1] * inv_z + self.cy
        return torch.stack([u, v], dim=-1)

    def project_np(self, Xc):
        Xc = np.asarray(Xc)
        z = Xc[..., 2]
        inv_z = 1.0 / np.where(np.abs(z) < 1e-9, 1e-9, z)
        return np.stack([self.fx * Xc[..., 0] * inv_z + self.cx,
                         self.fy * Xc[..., 1] * inv_z + self.cy], axis=-1)

    def unproject(self, uv):
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def project_jac(self, Xc):
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        inv_z2 = inv_z * inv_z
        zeros = torch.zeros_like(x)
        row0 = torch.stack([self.fx * inv_z, zeros, -self.fx * x * inv_z2], dim=-1)
        row1 = torch.stack([zeros, self.fy * inv_z, -self.fy * y * inv_z2], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    def has_distortion(self):
        return bool(np.any(self.dist != 0))

    def distort_normalized(self, xy):
        """Apply rad-tan distortion to normalized coords [...,2]."""
        k1, k2, p1, p2, k3 = [float(v) for v in self.dist]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def undistort_points(self, uv, iters: int = 24):
        """Pixels (distorted) -> pixels (ideal), cv::undistortPoints-style
        fixed-point iteration (ref: Frame.cc:738 UndistortKeyPoints)."""
        if not self.has_distortion():
            return uv
        xd = (uv[..., 0] - self.cx) / self.fx
        yd = (uv[..., 1] - self.cy) / self.fy
        tgt = torch.stack([xd, yd], dim=-1)
        xy = tgt
        for _ in range(iters):
            xy = xy + (tgt - self.distort_normalized(xy))
        return torch.stack(
            [self.fx * xy[..., 0] + self.cx, self.fy * xy[..., 1] + self.cy], dim=-1
        )

    def distort_points(self, uv):
        """Ideal pixels -> distorted pixels."""
        if not self.has_distortion():
            return uv
        xy = torch.stack([(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy],
                         dim=-1)
        d = self.distort_normalized(xy)
        return torch.stack(
            [self.fx * d[..., 0] + self.cx, self.fy * d[..., 1] + self.cy], dim=-1
        )
