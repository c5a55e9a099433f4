"""Batched Lie-group operations on SO(3) / SE(3) / Sim(3) (port of
tpuslam/core/lie.py; ref: src/ImuTypes.cc ExpSO3/LogSO3,
Thirdparty/g2o/g2o/types/se3quat.h, sim3.h, src/Converter.cc).

Rotations are [...,3,3] tensors; SE(3) is the pair (R, t), Sim(3) the
triple (s, R, t). Small-angle branches use torch.where with Taylor
expansions, so nothing branches on data, and the square roots only see
values bounded away from zero: torch.func.jacfwd through exp/log at the
origin is exact (the pose graph and the Sim3 refinement rely on it).
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


def _where(cond, a, b):
    """torch.where that keeps the tensor operand's dtype for a Python
    scalar operand (under torch.func transforms a bare scalar promotes to
    f64)."""
    ref = b if torch.is_tensor(b) else a
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return torch.where(cond, a, b)


def so3_exp(w):
    """Rodrigues formula, exp: so(3) [...,3] -> SO(3) [...,3,3], with the
    small-angle Taylor branch of the reference's ExpSO3."""
    theta2 = (w * w).sum(dim=-1)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    theta2_safe = _where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = _where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = _where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_right_jacobian(w):
    """Right Jacobian of SO(3) (ref: RightJacobianSO3, ImuTypes.h:274)."""
    theta2 = (w * w).sum(dim=-1)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    safe_t2 = _where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    b = _where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = _where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (safe_t2 * theta))
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * W2


def se3_exp(xi):
    """exp: se(3) [...,6] (rho, phi) -> (R, t), t = V(phi) @ rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = (phi * phi).sum(dim=-1)
    W = hat(phi)
    W2 = W @ W
    small = theta2 < _EPS
    safe_t2 = _where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    safe_t3 = safe_t2 * theta
    b = _where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = _where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    V = _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def vee(W):
    """Inverse of hat: [...,3,3] -> [...,3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _mv(A, x):
    """Batched matrix-vector product [...,i,j] x [...,j] -> [...,i]."""
    return (A @ x[..., None])[..., 0]


def so3_log(R):
    """log: SO(3) [...,3,3] -> so(3) [...,3] (ref LogSO3), with the
    near-identity Taylor branch and the near-pi axis recovery."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5            # = sin(theta) * axis
    s2 = (w_skew * w_skew).sum(dim=-1)                     # = sin^2 theta
    small = cos_t > 1.0 - 1e-7
    near_pi = cos_t < -1.0 + 5e-7
    s2_safe = _where(small | near_pi, 1.0, s2)
    sin_t = torch.sqrt(s2_safe)
    theta_gen = torch.atan2(sin_t, cos_t)
    scale = _where(small, 1.0 + s2 / 6.0 + 3.0 * s2 * s2 / 40.0, theta_gen / sin_t)
    w_generic = scale[..., None] * w_skew
    theta = torch.arccos(_where(near_pi, torch.clamp(cos_t, min=-1.0), 0.0))
    # near pi: the axis from the diagonal of the symmetric part
    B = (R + R.transpose(-1, -2)) * 0.5
    d = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    one_m = _where(torch.abs(1.0 - cos_t) < 1e-12, 1.0, 1.0 - cos_t)
    axis2 = torch.clamp((d - cos_t[..., None]) / one_m[..., None], 0.0, 1.0)
    axis2_safe = _where(near_pi[..., None], torch.clamp(axis2, min=1e-12), 1.0)
    axis_abs = torch.sqrt(axis2_safe)
    k = torch.argmax(axis_abs, dim=-1)
    s01, s02, s12 = torch.sign(B[..., 0, 1]), torch.sign(B[..., 0, 2]), torch.sign(B[..., 1, 2])

    def nz(s):
        return _where(s == 0, 1.0, s)

    one = torch.ones_like(s01)
    # signs relative to the dominant axis k: (+, s01, s02), (s01, +, s12), (s02, s12, +)
    sel = torch.stack([torch.stack([one, nz(s01), nz(s02)], -1),
                       torch.stack([nz(s01), one, nz(s12)], -1),
                       torch.stack([nz(s02), nz(s12), one], -1)], dim=-2)
    signs = torch.take_along_dim(sel, k[..., None, None], dim=-2)[..., 0, :]
    axis_pi = axis_abs * signs
    dot = (axis_pi * w_skew).sum(dim=-1, keepdim=True)
    axis_pi = _where(dot < 0, -axis_pi, axis_pi)
    return _where(near_pi[..., None], theta[..., None] * axis_pi, w_generic)


def se3_log(R, t):
    """log: SE(3) -> [...,6] (rho, phi), rho = V(phi)^-1 t."""
    phi = so3_log(R)
    theta2 = (phi * phi).sum(dim=-1)
    W = hat(phi)
    W2 = W @ W
    small = theta2 < _EPS
    safe = _where(small, 1.0, theta2)
    half = torch.sqrt(safe) * 0.5
    # V^-1 = I - W/2 + c W^2, c = (1 - (t/2) cos(t/2) / sin(t/2)) / t^2
    c = _where(small, 1.0 / 12.0 + theta2 / 720.0,
               (1.0 - half * torch.cos(half) / (torch.sin(half) + 1e-30)) / safe)
    Vinv = _eye_like(W) - 0.5 * W + c[..., None, None] * W2
    return torch.cat([_mv(Vinv, t), phi], dim=-1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


# ---------------------------------------------------------------------------
# Sim(3): triples (s [...], R [...,3,3], t [...,3])  (ref: g2o sim3.h)
# ---------------------------------------------------------------------------


def sim3_apply(s, R, t, X):
    return s[..., None] * _mv(R, X) + t


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * _mv(Rt, t)


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) * (sb, Rb, tb)."""
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def _sim3_W(phi, sigma):
    """The Sim(3) 'V' matrix W(sigma, theta) with t = W rho (Strasdat's
    A*I + B*W + C*W^2 form), with its sigma -> 0 and theta -> 0 limits."""
    s = torch.exp(sigma)
    theta2 = (phi * phi).sum(dim=-1)
    W = hat(phi)
    W2 = W @ W
    eps_s = torch.abs(sigma) < 1e-6
    eps_t = theta2 < 1e-12
    sig_safe = _where(eps_s, 1.0, sigma)
    t2_safe = _where(eps_t, 1.0, theta2)
    theta = torch.sqrt(t2_safe)
    A = _where(eps_s, 1.0 + sigma / 2.0, (s - 1.0) / sig_safe)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    c2 = theta2 + sigma * sigma
    c2_safe = _where(c2 < 1e-12, 1.0, c2)
    B_gen = (a_ * sigma + (1.0 - b_) * theta) / (theta * c2_safe)
    C_gen = (A - ((b_ - 1.0) * sigma + a_ * theta) / c2_safe) / t2_safe
    B_s0 = _where(eps_t, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    C_s0 = _where(eps_t, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - torch.sin(theta)) / (t2_safe * theta))
    B_t0 = _where(eps_s, 0.5, (sig_safe * s - s + 1.0) / (sig_safe * sig_safe))
    C_t0 = _where(eps_s, 1.0 / 6.0,
                  (0.5 * sig_safe * sig_safe * s + s - 1.0 - sig_safe * s) / sig_safe ** 3)
    B = _where(eps_s, B_s0, _where(eps_t, B_t0, B_gen))
    C = _where(eps_s, C_s0, _where(eps_t, C_t0, C_gen))
    return A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * W2


def sim3_exp(xi):
    """exp: sim(3) [...,7] (rho, phi, sigma) -> (s, R, t), in the g2o
    generator order rho(3), phi(3), sigma(1)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(phi), _mv(_sim3_W(phi, sigma), rho)


def sim3_log(s, R, t):
    """log: Sim(3) -> [...,7] (rho, phi, sigma); the inverse of sim3_exp."""
    phi = so3_log(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve(_sim3_W(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


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
    q = _where(cond_w, qw0, _where(cond_x, qx0, _where(cond_y, qy0, qz0)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return _where(q[..., 3:4] < 0, -q, q)
