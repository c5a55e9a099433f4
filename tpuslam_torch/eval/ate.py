"""Absolute trajectory error via Horn alignment (port of
tpuslam/eval/ate.py, numpy only).

The metric of the reference harness (ref: evaluation/evaluate_ate_scale.py
align() at :50-60): SE(3), or Sim(3) for monocular, alignment of the
estimated onto the ground-truth positions, then the RMSE of the residual
translations.
"""

from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Align model -> data (both [N,3]): data ~ s * R @ model + t.
    Returns (R, t, s, residuals [N])."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    U, S, Vt = np.linalg.svd(mc.T @ dc)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ D @ Vt).T  # rotates model into the data frame
    s = float(np.trace(np.diag(S) @ D) / (mc ** 2).sum()) if with_scale else 1.0
    t = mu_d - s * R @ mu_m
    res = np.linalg.norm(s * model @ R.T + t - data, axis=1)
    return R, t, s, res


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = False):
    """RMSE ATE after alignment, and the alignment's scale (ref protocol:
    euroc_eval_examples.sh:9)."""
    _, _, s, res = horn_align(est_xyz, gt_xyz, with_scale)
    return float(np.sqrt((res ** 2).mean())), s


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Timestamp association (ref: evaluation/associate.py). Returns the
    index pairs (i_est, i_gt) within max_dt."""
    j = np.clip(np.searchsorted(t_gt, t_est), 1, len(t_gt) - 1)
    left = np.abs(t_gt[j - 1] - t_est)
    right = np.abs(t_gt[j] - t_est)
    best = np.where(left < right, j - 1, j)
    ok = np.abs(t_gt[best] - t_est) <= max_dt
    return np.nonzero(ok)[0], best[ok]
