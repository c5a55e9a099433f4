"""Motion-only pose optimization, camera-generic (port of
tpuslam/solve/pose_opt.py; ref: Optimizer::PoseOptimization,
src/Optimizer.cc:854-1168).

4 rounds x 10 damped LM steps on one SE(3) pose with g2o's Levenberg
accept/reject: Huber kernel (deltaMono = sqrt(5.991), deltaStereo =
sqrt(7.815)) in every round but the last, chi2 re-classification of all
valid observations between rounds, early exit once an accepted step's
squared norm drops below `step_tol`. The JAX version's `lax.while_loop`
is a masked loop over the fixed step count here, so the solve never
waits on the device. Pinhole tracking goes through
`pose_opt_dispatch.pose_optimize_best` to the fused kernel instead.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..core.linalg import spd_solve
from ..core.robust import CHI2_MONO, CHI2_STEREO, huber_cost, huber_weight
from .reproj import PINHOLE, project_residuals

ROUNDS = 4
ITERS = 10


def pose_optimize(R0, t0, X, uvr, inv_sigma2, is_stereo, valid, fx, fy, cx, cy, bf,
                  n_rounds: int = ROUNDS, n_iters: int = ITERS, damping: float = 1e-4,
                  step_tol: float = 1e-16, cam=PINHOLE, is_right=None):
    """Returns (R, t, inlier_mask, chi2_per_obs); dtype of X."""
    dtype = X.dtype
    dev = X.device
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)

    def residuals(R, t):
        return project_residuals(R, t, X, uvr, is_stereo, fx, fy, cx, cy, bf, cam, is_right)

    def normal_eqs(R, t, use, robust):
        r, J, _, z = residuals(R, t)
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        w = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
        w = w * inv_sigma2 * use.to(dtype)
        w = torch.where(z > 0, w, 0.0)  # depth positivity (ref isDepthPositive)
        JW = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", JW, J)
        b = -torch.einsum("nij,ni->j", JW, r)
        return H, b

    def cost_terms(R, t, use, robust):
        r, _, _, z = residuals(R, t)
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        c = huber_cost(chi2, chi2_th) if robust else chi2
        return torch.where(use & (z > 0), c, 0.0)

    R, t = R0.to(dtype), t0.to(dtype)
    use = valid
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    for rnd in range(n_rounds):
        robust = rnd < n_rounds - 1  # last round: plain quadratic
        lam = torch.full((), damping, dtype=dtype, device=dev)
        sq = inf
        for _ in range(n_iters):
            active = sq > step_tol
            H, b = normal_eqs(R, t, use, robust)
            dx = spd_solve(H, b, damping=lam)
            dR, dt = lie.se3_exp(dx)
            Rn = dR @ R
            tn = dR @ t + dt
            # f32-safe acceptance: the sum of per-observation differences
            delta = (cost_terms(Rn, tn, use, robust) - cost_terms(R, t, use, robust)).sum()
            accept = delta < 0
            R = torch.where(active & accept, Rn, R)
            t = torch.where(active & accept, tn, t)
            lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
            lam = torch.where(active, lam_next, lam)
            sq = torch.where(active, torch.where(accept, (dx * dx).sum(), inf), sq)
        # outlier re-classification on ALL valid obs (ref Optimizer.cc:1100+)
        r, _, _, z = residuals(R, t)
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        use = valid & (chi2 <= chi2_th) & (z > 0)
    r, _, _, z = residuals(R, t)
    chi2 = (r * r).sum(dim=-1) * inv_sigma2
    inliers = valid & (chi2 <= chi2_th) & (z > 0)
    return R, t, inliers, chi2
