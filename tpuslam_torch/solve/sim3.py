"""Sim(3)/SE(3) alignment: batched Horn closed form, RANSAC, GN refinement
(port of tpuslam/solve/sim3.py; ref: src/Sim3Solver.cc ComputeSim3 :316,
CheckInliers, and Optimizer::OptimizeSim3 src/Optimizer.cc:3734).

RANSAC hypotheses are a batch dimension (one batched SVD), inliers one
masked reduction. tpuslam's `lax.scan` of the refinement is a Python loop
over its fixed iteration count with masked (torch.where) updates, so no
step waits on the device. The sample draw is explicit (`idx`, or
`draw_samples` from a torch.Generator).
"""

from __future__ import annotations

import torch

from ..cameras.kb8 import kb8_project
from ..core.lie import so3_exp
from ..core.linalg import spd_solve, svd
from ..utils import jacfwd


def draw_samples(n_valid: int, n_hyp: int, generator=None):
    """[n_hyp, 3] positions among the valid rows, uniform with
    replacement (jax.random.randint(key, (n_hyp, 3), 0, n_valid) in
    tpuslam); drawn on the host."""
    return torch.randint(0, max(int(n_valid), 1), (n_hyp, 3), generator=generator)


def horn_sim3(X1, X2, fix_scale: bool = False):
    """Closed-form (s, R, t) with X2 ~ s R X1 + t, batched over leading
    dims: X1, X2 [...,N,3] (Kabsch on the centred sets, ref ComputeSim3)."""
    c1 = X1.mean(-2, keepdim=True)
    c2 = X2.mean(-2, keepdim=True)
    d1, d2 = X1 - c1, X2 - c2
    M = torch.einsum("...ni,...nj->...ij", d2, d1)   # maps 1 -> 2
    U, _, Vt = svd(M)
    det = torch.linalg.det(U @ Vt)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=X1.dtype, device=X1.device),
                     det[..., None]], -1)
    R = (U * fix[..., None, :]) @ Vt
    Rd1 = torch.einsum("...ij,...nj->...ni", R, d1)
    if fix_scale:
        s = torch.ones(X1.shape[:-2], dtype=X1.dtype, device=X1.device)
    else:
        s = (d2 * Rd1).sum((-1, -2)) / torch.clamp((d1 * d1).sum((-1, -2)), min=1e-12)
    t = c2[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, c1[..., 0, :])
    return s, R, t


def _project(X, fx, fy, cx, cy, cam=None):
    """Pixels of camera-frame points: the KB8 model for a kb8 CamSpec, else
    pinhole."""
    if cam is not None and cam.kind == "kb8":
        return kb8_project((fx, fy, cx, cy) + tuple(cam.k), X)
    z = torch.clamp(X[..., 2], min=1e-6)
    return torch.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], -1)


def sim3_ransac(X1, X2, valid, uv1, uv2, inv_s2_1, inv_s2_2, fx, fy, cx, cy,
                idx=None, generator=None, n_hyp: int = 256, fix_scale: bool = False,
                th_chi2: float = 9.21, cam=None):
    """RANSAC Sim3 between matched 3D point sets, inliers by two-way
    reprojection (ref Sim3Solver::CheckInliers), then four LO refits on the
    grown inlier set. X1/X2 [N,3] points in camera frames 1/2; uv1/uv2
    [N,2] observed pixels; inv_s2_* [N]; idx [n_hyp, 3] positions among
    the valid rows; cam: a CamSpec (None: pinhole). Returns dict(s, R,
    t (2 <- 1), inliers [N], n_inliers)."""
    if idx is None:
        idx = draw_samples(int(valid.sum()), n_hyp, generator)
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid rows first
    pick = order[torch.as_tensor(idx, device=X1.device).long()]
    s, R, t = horn_sim3(X1[pick], X2[pick], fix_scale=fix_scale)

    def count(s, R, t):
        X1in2 = s[..., None, None] * torch.einsum("hij,nj->hni", R, X1) + t[:, None, :]
        si = 1.0 / torch.clamp(s, min=1e-12)
        X2in1 = si[..., None, None] * torch.einsum(
            "hij,hnj->hni", R.transpose(-1, -2), X2[None] - t[:, None, :])
        e2 = ((_project(X1in2, fx, fy, cx, cy, cam) - uv2) ** 2).sum(-1) * inv_s2_2
        e1 = ((_project(X2in1, fx, fy, cx, cy, cam) - uv1) ** 2).sum(-1) * inv_s2_1
        return ((e1 < th_chi2) & (e2 < th_chi2) & valid
                & (X1in2[..., 2] > 0) & (X2in1[..., 2] > 0))

    inl = count(s, R, t)  # [H,N]
    best = torch.argmax(inl.sum(-1))
    sB, RB, tB, inlB = s[best], R[best], t[best], inl[best]
    nB = inlB.sum()
    # LO-RANSAC: all-inlier Horn refit with inlier regrowth; outliers
    # collapse to the centroids (zero residual in the refit)
    for _ in range(4):
        m = inlB.to(X1.dtype)
        den = torch.clamp(m.sum(), min=3.0)
        c1 = (X1 * m[:, None]).sum(0) / den
        c2 = (X2 * m[:, None]).sum(0) / den
        Xe1 = torch.where(m[:, None] > 0, X1, c1)
        Xe2 = torch.where(m[:, None] > 0, X2, c2)
        sF, RF, tF = horn_sim3(Xe1[None], Xe2[None], fix_scale=fix_scale)
        inlF = count(sF, RF, tF)[0]
        better = inlF.sum() >= nB
        sB = torch.where(better, sF[0], sB)
        RB = torch.where(better, RF[0], RB)
        tB = torch.where(better, tF[0], tB)
        inlB = torch.where(better, inlF, inlB)
        nB = torch.maximum(inlF.sum(), nB)
    return dict(s=sB, R=RB, t=tB, inliers=inlB, n_inliers=inlB.sum())


def optimize_sim3(s0, R0, t0, X1, X2, valid, uv1, uv2, inv_s2_1, inv_s2_2,
                  fx, fy, cx, cy, n_iters: int = 10, fix_scale: bool = False,
                  th_chi2: float = 10.0, cam=None):
    """GN refinement of the Sim3 (2 <- 1) on two-way reprojection error
    (ref Optimizer::OptimizeSim3: EdgeSim3ProjectXYZ +
    EdgeInverseSim3ProjectXYZ). Right increments: s' = s e^sigma,
    R' = R Exp(phi), t' = t + R rho. Huber-like weights in the first half
    of the iterations, the chi2 gate after. Returns (s, R, t, inliers,
    n_inliers)."""
    dtype, dev = X1.dtype, X1.device
    sq1 = torch.sqrt(inv_s2_1)[:, None]
    sq2 = torch.sqrt(inv_s2_2)[:, None]

    def residuals(theta, s, R, t):
        # theta [1,7]: a batch of one, since under torch.func a 0-dim
        # tangent meeting a Python scalar promotes to f64
        s2 = s * torch.exp(theta[:, 6]) if not fix_scale else s.reshape(1)
        R2 = R @ so3_exp(theta[:, 3:6])                              # [1,3,3]
        t2 = t + (R @ theta[:, 0:3, None])[..., 0]                   # [1,3]
        X1in2 = (s2[:, None, None] * (X1 @ R2.transpose(-1, -2)) + t2[:, None])[0]
        X2in1 = ((1.0 / s2)[:, None, None] * ((X2 - t2[:, None]) @ R2))[0]
        r2 = (_project(X1in2, fx, fy, cx, cy, cam) - uv2) * sq2
        r1 = (_project(X2in1, fx, fy, cx, cy, cam) - uv1) * sq1
        return torch.cat([r1, r2], 0), (X1in2[:, 2] > 0) & (X2in1[:, 2] > 0)

    s = torch.as_tensor(s0, dtype=dtype, device=dev)
    R = torch.as_tensor(R0, dtype=dtype, device=dev)
    t = torch.as_tensor(t0, dtype=dtype, device=dev)
    z7 = torch.zeros(1, 7, dtype=dtype, device=dev)
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    keep = torch.ones(7, dtype=dtype, device=dev)
    if fix_scale:
        keep[6] = 0.0
    for it in range(n_iters):
        r, posz = residuals(z7, s, R, t)
        chi = (r.reshape(2, -1, 2) ** 2).sum(-1)  # [2,N]
        ok = (chi < th_chi2).all(0) & valid & posz
        if it >= n_iters // 2:
            w = ok.to(dtype)
        else:
            chi_max = torch.clamp(chi.max(0).values, min=1e-9)
            w = torch.clamp(torch.sqrt(th_chi2 / chi_max), max=1.0) * (valid & posz)
        J = jacfwd(lambda th: residuals(th, s, R, t)[0])(z7)   # [2N,2,1,7]
        w2 = torch.cat([w, w]).repeat_interleave(2)
        Jr = J.reshape(-1, 7)
        H = (Jr * w2[:, None]).T @ Jr
        b = -(Jr * w2[:, None]).T @ r.reshape(-1)
        # the fixed scale: its row and column become the identity
        H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
        b = b * keep
        H = H + 1e-8 * eye7 + 1e-6 * torch.diag(torch.diagonal(H))
        dth = spd_solve(H, b)
        if not fix_scale:
            s = s * torch.exp(dth[6])
        t = t + R @ dth[0:3]
        R = R @ so3_exp(dth[3:6])
    r, posz = residuals(z7, s, R, t)
    chi = (r.reshape(2, -1, 2) ** 2).sum(-1)
    inl = (chi < th_chi2).all(0) & valid & posz
    return s, R, t, inl, inl.sum()
