"""Batched PnP: camera pose from 3D-2D matches, RANSAC (port of
tpuslam/solve/pnp.py; fills the role of the reference's relocalization
solver, src/MLPnPsolver.cpp).

All RANSAC hypotheses are solved at once: each 6-point minimal set
through a DLT projection-matrix fit (batched eigh of the 12x12 normal
matrix), orthogonalized onto SO(3), cheirality-checked, inliers counted by
a masked reduction. The caller polishes the winner with the motion-only
pose LM. The sample draw is explicit (`idx`, or `draw_samples` from a
torch.Generator).
"""

from __future__ import annotations

import torch


def draw_samples(n_valid: int, n_hyp: int, generator=None):
    """[n_hyp, 6] positions among the valid rows, uniform with
    replacement (jax.random.randint(key, (n_hyp, 6), 0, n_valid) in
    tpuslam); drawn on the host."""
    return torch.randint(0, max(int(n_valid), 1), (n_hyp, 6), generator=generator)


def dlt_pose(X, xy):
    """DLT pose from n >= 6 correspondences, batched over leading dims.
    X [...,n,3] world points, xy [...,n,2] normalized image coords.
    Returns (R [...,3,3], t [...,3])."""
    ones = torch.ones_like(X[..., :1])
    zeros = torch.zeros_like(X[..., :1])
    u, v = xy[..., 0:1], xy[..., 1:2]

    def row(a, b, c):
        return torch.cat([a * X, a * ones, b * X, b * ones, c * X, c * ones], -1)

    A = torch.cat([row(ones, zeros, -u), row(zeros, ones, -v)], -2)  # [...,2n,12]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = vecs[..., 0].reshape(vecs.shape[:-2] + (3, 4))               # smallest eigenvalue
    sign = torch.where(torch.linalg.det(P[..., :3]) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    U, S, Vt = torch.linalg.svd(P[..., :3])
    scale = S.mean(-1)
    detR = torch.linalg.det(U @ Vt)
    fix = torch.cat([torch.ones(detR.shape + (2,), dtype=X.dtype, device=X.device),
                     detR[..., None]], -1)
    R = (U * fix[..., None, :]) @ Vt
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    return R, t


def pnp_ransac(X, xy, inv_s2, valid, idx=None, generator=None, n_hyp: int = 256,
               th_chi2: float = 5.991, focal2: float = 1.0):
    """RANSAC DLT-PnP. X [N,3], xy [N,2] normalized coords, inv_s2 [N]
    per-match information in pixels (focal2 = f^2 converts the normalized
    residual to pixels^2); idx [n_hyp, 6] positions among the valid rows.

    Returns dict(R, t, inliers [N], n_inliers)."""
    nv = int(valid.sum())
    if idx is None:
        idx = draw_samples(nv, n_hyp, generator)
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid rows first
    pick = order[torch.as_tensor(idx, device=X.device).long()]
    R, t = dlt_pose(X[pick], xy[pick])                            # [H,3,3], [H,3]
    Xc = torch.einsum("hij,nj->hni", R, X) + t[:, None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    chi2 = ((Xc[..., :2] / zs[..., None] - xy) ** 2).sum(-1) * inv_s2 * focal2
    inl = (chi2 < th_chi2) & (z > 0) & valid
    n_inl = inl.sum(-1)
    best = torch.argmax(n_inl)
    return dict(R=R[best], t=t[best], inliers=inl[best], n_inliers=n_inl[best])
