"""Inertial-only initialization: gravity direction, scale, biases and
velocities (port of tpuslam/imu/init.py).

The reference's IMU-init optimizations (Optimizer::InertialOptimization
src/Optimizer.cc:5303: 2-DoF gravity VertexGDir G2oTypes.h:271, VertexScale
:293, shared gyro / accelerometer biases, per-KF velocities, poses FIXED,
EdgeInertialGS :545) and the gyro-bias bootstrap (Tracking::ComputeGyroBias
src/Tracking.cc:724). One dense LM over the (9 + 3K)-dim state
[phi_g(2), log_s, bg(3), ba(3), v(3K)] with torch.func.jacfwd residual
Jacobians; tpuslam's `lax.scan` is a Python loop with masked accept /
reject, so no step waits on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lie import so3_exp, so3_log
from ..core.linalg import inv, spd_solve
from .preintegration import GRAVITY, corrected_delta


def _T(A):
    return A.transpose(-1, -2)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def gyro_bias_from_rotations(Rwb_pairs, pre_dR, pre_JRg):
    """Gyro bias by 3 GN steps on r = Log((dR Exp(JRg bg))^T Rwb1^T Rwb2)
    (ref Tracking::ComputeGyroBias Tracking.cc:724). Rwb_pairs: (Rwb1 [E,3,3],
    Rwb2 [E,3,3]); pre_dR / pre_JRg [E,3,3]. Returns bg [3]."""
    R1, R2 = Rwb_pairs

    def residuals(bg):
        return so3_log(_T(pre_dR @ so3_exp(_mv(pre_JRg, bg))) @ _T(R1) @ R2).reshape(-1)

    bg = torch.zeros(3, dtype=R1.dtype, device=R1.device)
    eye = torch.eye(3, dtype=R1.dtype, device=R1.device)
    for _ in range(3):
        J = torch.func.jacfwd(residuals)(bg)
        r = residuals(bg)
        bg = bg - spd_solve(J.T @ J + 1e-9 * eye, J.T @ r)
    return bg


def _gs_residuals(theta, Rwb, p, edges_a, edges_b, pre_stack, mono_scale, Rwg0):
    """Stacked 9-dim EdgeInertialGS residuals [E,9] of all edges.

    theta = [phi_g(2), log_s(1), bg(3), ba(3), v(K*3)]; gravity
    Gw = Rwg0 Exp([phi_x, phi_y, 0]) (0, 0, -G). The velocities live in the
    VISUAL (up-to-scale) frame and the scale multiplies both the position
    differences and the velocity terms, exactly EdgeInertialGS (ref
    G2oTypes.cc computeError) — with metric velocities the optimum slides to
    the degenerate s ~ 0 (tpuslam's measurement). Callers get metric
    velocities as s * v."""
    K = Rwb.shape[0]
    phi = torch.cat([theta[0:2], torch.zeros_like(theta[:1])])
    Rwg = Rwg0 @ so3_exp(phi)
    s = torch.exp(theta[2]) if mono_scale else torch.ones_like(theta[2])
    v = theta[9:].reshape(K, 3)
    g = _mv(Rwg, torch.tensor([0.0, 0.0, -GRAVITY], dtype=theta.dtype, device=theta.device))
    dT = pre_stack["dT"][:, None]
    dR, dV, dP = corrected_delta(pre_stack, theta[3:6], theta[6:9])
    R1T, R2 = _T(Rwb[edges_a]), Rwb[edges_b]
    v1, v2 = v[edges_a], v[edges_b]
    er = so3_log(_T(dR) @ R1T @ R2)
    ev = _mv(R1T, s * (v2 - v1) - g * dT) - dV
    ep = _mv(R1T, s * (p[edges_b] - p[edges_a] - v1 * dT) - 0.5 * g * dT * dT) - dP
    return torch.cat([er, ev, ep], dim=-1)


def linear_sgv_seed(Rwb, p, edges_a, edges_b, pre_list):
    """Closed-form (s, gravity, velocity) seed: with w = s v the
    EdgeInertialGS ev / ep equations are exactly linear in (s, g, w),
    ev: R1^T (w_b - w_a - g dT) = dV, ep: R1^T (s dp_vis - w_a dT - g dT^2/2)
    = dP, so one least-squares solve has no basins (tpuslam: without it the
    GN walk from s = 1 parks in a small-scale basin when the true scale is
    far). Host numpy in f64, as tpuslam. Returns (s, g [3], w [K,3])."""
    K = len(Rwb)
    E = len(edges_a)
    A = np.zeros((6 * E, 4 + 3 * K))
    rhs = np.zeros(6 * E)
    for e in range(E):
        a_, b_ = int(edges_a[e]), int(edges_b[e])
        pre = pre_list[e]
        dT = max(float(np.asarray(pre["dT"])), 1e-9)
        R1T = np.asarray(Rwb[a_], np.float64).T
        r0 = 6 * e
        A[r0:r0 + 3, 1:4] = -R1T * dT
        A[r0:r0 + 3, 4 + 3 * b_: 7 + 3 * b_] = R1T
        A[r0:r0 + 3, 4 + 3 * a_: 7 + 3 * a_] = -R1T
        rhs[r0:r0 + 3] = np.asarray(pre["dV"], np.float64)
        A[r0 + 3:r0 + 6, 0] = R1T @ (np.asarray(p[b_], np.float64) - np.asarray(p[a_], np.float64))
        A[r0 + 3:r0 + 6, 1:4] = -0.5 * R1T * dT * dT
        A[r0 + 3:r0 + 6, 4 + 3 * a_: 7 + 3 * a_] = -R1T * dT
        rhs[r0 + 3:r0 + 6] = np.asarray(pre["dP"], np.float64)
    x, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    return float(x[0]), x[1:4], x[4:].reshape(K, 3)


def inertial_init_solve(Rwb, p, v0, edges_a, edges_b, pre_stack, info9, prior_g: float = 1e2,
                        prior_a: float = 1e10, n_iters: int = 20, mono_scale: bool = True,
                        Rwg0=None, log_s0=0.0):
    """Estimate (Rwg, s, bg, ba, v) with the KF poses fixed.

    prior_g / prior_a: zero-mean bias priors (the reference's schedule
    passes 1e2 / 1e10 first, then 1e5, LocalMapping.cc:1244,1270). Rwg0:
    gravity-direction seed the 2-DoF updates multiply (ref VertexGDir);
    v0: visual-frame velocity seed. Returns dict(Rwg, scale, bg, ba,
    v [K,3] METRIC, cost, logs_sigma), tensors on the inputs' device; the
    last is the marginal std of log s from the final GN Hessian, which
    gates mono init on scale observability."""
    K = Rwb.shape[0]
    dtype, dev = Rwb.dtype, Rwb.device
    ea, eb = edges_a.long(), edges_b.long()
    if Rwg0 is None:
        Rwg0 = torch.eye(3, dtype=dtype, device=dev)
    theta = torch.cat([torch.zeros(2, dtype=dtype, device=dev),
                       torch.as_tensor(log_s0, dtype=dtype, device=dev).reshape(1),
                       torch.zeros(6, dtype=dtype, device=dev), v0.reshape(-1).to(dtype)])
    D = theta.shape[0]
    eyeD = torch.eye(D, dtype=dtype, device=dev)

    def res(th):
        return _gs_residuals(th, Rwb, p, ea, eb, pre_stack, mono_scale, Rwg0)

    def cost_terms(th):
        r = res(th)
        c = torch.einsum("ei,eij,ej->e", r, info9, r)
        pr = torch.stack([prior_g * (th[3:6] ** 2).sum(), prior_a * (th[6:9] ** 2).sum()])
        return torch.cat([c, pr])

    prior_diag = torch.zeros(D, dtype=dtype, device=dev)
    prior_diag[3:6] = prior_g
    prior_diag[6:9] = prior_a

    def normal_eqs(th):
        J = torch.func.jacfwd(res)(th)                       # [E,9,D]
        JW = torch.einsum("eij,eid->ejd", info9, J)
        return J, JW, torch.einsum("eid,eif->df", J, JW) + torch.diag(prior_diag)

    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    cost = cost_terms(theta).sum()
    for _ in range(n_iters):
        r = res(theta)
        _, JW, H = normal_eqs(theta)
        b = -torch.einsum("eid,ei->d", JW, r) - prior_diag * theta
        if not mono_scale:
            H = H.clone()
            H[2, :] = 0.0
            H[:, 2] = 0.0
            H[2, 2] = 1.0
            b = b.clone()
            b[2] = 0.0
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eyeD
        new = theta + spd_solve(H, b)
        # f32-safe acceptance: per-edge cost differences, then the sum
        delta = (cost_terms(new) - cost_terms(theta)).sum()
        accept = delta < 0
        theta = torch.where(accept, new, theta)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-9, 1e6)
        cost = cost + torch.where(accept, delta, 0.0)
    # scale observability: marginal std of log s from the final Hessian
    _, _, Hf = normal_eqs(theta)
    df = torch.diagonal(Hf)
    goodf = (df > 0) & torch.isfinite(df)
    sf = torch.where(goodf, torch.rsqrt(torch.where(goodf, df, 1.0)), 1.0)
    cov_n = inv(Hf * sf[:, None] * sf[None, :] + 1e-9 * eyeD)
    logs_var = cov_n[2, 2] * sf[2] * sf[2]
    phi = torch.cat([theta[0:2], torch.zeros_like(theta[:1])])
    s_fin = torch.exp(theta[2]) if mono_scale else torch.ones_like(theta[2])
    return dict(Rwg=Rwg0 @ so3_exp(phi), scale=s_fin, bg=theta[3:6], ba=theta[6:9],
                v=s_fin * theta[9:].reshape(K, 3), cost=cost,
                logs_sigma=torch.sqrt(torch.clamp(logs_var, min=0.0)))
