"""Batched Lie-group operations on SO(3) / SE(3) (port of the parts of
tpuslam/core/lie.py that the stereo System uses; ref: src/ImuTypes.cc
ExpSO3, Thirdparty/g2o/g2o/types/se3quat.h, src/Converter.cc).

Rotations are [...,3,3] tensors; SE(3) is the pair (R, t). Small-angle
branches use torch.where with Taylor expansions, so nothing branches on
data. The Sim(3) functions wait for loop closing.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: w [...,3] -> skew matrix [...,3,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Rodrigues formula, exp: so(3) [...,3] -> SO(3) [...,3,3], with the
    small-angle Taylor branch of the reference's ExpSO3."""
    theta2 = (w * w).sum(dim=-1)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(xi):
    """exp: se(3) [...,6] (rho, phi) -> (R, t), t = V(phi) @ rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = (phi * phi).sum(dim=-1)
    W = hat(phi)
    W2 = W @ W
    small = theta2 < _EPS
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    safe_t3 = safe_t2 * theta
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    V = _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def rot_to_quat(R):
    """Rotation matrix -> quaternion [...,4] (x, y, z, w), w >= 0: the
    branch-free Shepperd method over the four cases."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    sw = safe_sqrt(1.0 + tr) * 2.0
    qw0 = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], -1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    qx0 = torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    qy0 = torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], -1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    qz0 = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], -1)

    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, qw0, torch.where(cond_x, qx0, torch.where(cond_y, qy0, qz0)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)
