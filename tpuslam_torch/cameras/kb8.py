"""Kannala-Brandt 4-coefficient equidistant fisheye model (port of
tpuslam/cameras/kb8.py; ref: src/CameraModels/KannalaBrandt8.cpp).

params = [fx, fy, cx, cy, k0, k1, k2, k3]. Projection is the theta
polynomial, unprojection a fixed 10 Newton steps on it (the reference's
precision 1e-6) returning z = 1 rays, the Jacobian analytic. The
functional forms take the 8 parameters as Python floats and work on
tensors of any float type and device.

z = 1 rays cannot represent directions beyond 90 degrees off axis
(tan(theta) changes sign there); like the reference's unproject, pixels
that far out come back as flipped rays.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import CameraModel


def kb8_project(params, Xc):
    """[..., 3] camera-frame points -> [..., 2] pixels."""
    fx, fy, cx, cy, k0, k1, k2, k3 = params
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    small = r < 1e-9
    inv_r = 1.0 / torch.where(small, 1e-9, r)
    sx = torch.where(small, 0.0, d * x * inv_r)
    sy = torch.where(small, 0.0, d * y * inv_r)
    return torch.stack([fx * sx + cx, fy * sy + cy], dim=-1)


def kb8_jac(params, Xc):
    """Analytic d(uv)/dXc [..., 2, 3] (ref: KannalaBrandt8.cpp projectJac)."""
    fx, fy, cx, cy, k0, k1, k2, k3 = params
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    R2 = torch.clamp(r2 + z * z, min=1e-18)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    fp = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + t2 * 9 * k3)))
    dt_dx = x * z / (R2 * r)
    dt_dy = y * z / (R2 * r)
    dt_dz = -r / R2
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    du_dx = fx * (fp * dt_dx * x * inv_r + f * (y * y) * inv_r3)
    du_dy = fx * (fp * dt_dy * x * inv_r - f * x * y * inv_r3)
    du_dz = fx * fp * dt_dz * x * inv_r
    dv_dx = fy * (fp * dt_dx * y * inv_r - f * x * y * inv_r3)
    dv_dy = fy * (fp * dt_dy * y * inv_r + f * (x * x) * inv_r3)
    dv_dz = fy * fp * dt_dz * y * inv_r
    row0 = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row1 = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def kb8_unproject(params, uv, iters: int = 10):
    """[..., 2] pixels -> [..., 3] z = 1 rays by Newton inversion of the
    theta polynomial (ref: KannalaBrandt8.cpp unproject)."""
    fx, fy, cx, cy, k0, k1, k2, k3 = params
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3)))) - d
        fp = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + t2 * 9 * k3)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-9, 1e-9, fp)
    small = d < 1e-9
    scale = torch.where(small, 1.0, torch.tan(theta) / torch.where(small, 1.0, d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


class KannalaBrandt8(CameraModel):
    kind = "kb8"

    def __init__(self, params, width, height, lapping=None):
        # the parameters are kept as f32 values, as tpuslam keeps them
        p = np.asarray(params, np.float32).ravel()
        super().__init__(p[:4], width, height)
        self.k = p[4:8].astype(np.float32)
        # lapping area [begin, end] in pixels for fisheye-stereo matching
        # (ref: KannalaBrandt8.h:95 mvLappingArea)
        self.lapping = (0, width) if lapping is None else (int(lapping[0]), int(lapping[1]))

    @property
    def spec(self):
        from ..solve.reproj import CamSpec

        return CamSpec(kind="kb8", k=tuple(float(v) for v in self.k))

    @property
    def full_params(self):
        """(fx, fy, cx, cy, k0..k3) as Python floats, for the functional
        forms and solve/reproj.py's CamSpec."""
        return tuple(float(v) for v in self.params[:4]) + tuple(float(v) for v in self.k)

    def project(self, Xc):
        return kb8_project(self.full_params, Xc)

    def project_np(self, Xc):
        """Host (numpy) projection, the same formula as kb8_project."""
        fx, fy, cx, cy, k0, k1, k2, k3 = self.full_params
        Xc = np.asarray(Xc)
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        r = np.sqrt(x * x + y * y)
        theta = np.arctan2(r, z)
        t2 = theta * theta
        d = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
        inv_r = 1.0 / np.where(r < 1e-9, 1e-9, r)
        sx = np.where(r < 1e-9, 0.0, d * x * inv_r)
        sy = np.where(r < 1e-9, 0.0, d * y * inv_r)
        return np.stack([fx * sx + cx, fy * sy + cy], axis=-1)

    def unproject(self, uv, iters: int = 10):
        return kb8_unproject(self.full_params, uv, iters)

    def project_jac(self, Xc):
        return kb8_jac(self.full_params, Xc)
