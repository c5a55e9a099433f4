"""Robust cost weighting and chi-square gates (port of tpuslam/core/robust.py).

The reference uses g2o Huber kernels with per-edge deltas
(ref: src/Optimizer.cc:905-918 — deltaMono=sqrt(5.991), deltaStereo=sqrt(7.815)).
"""

from __future__ import annotations

import math

import torch

# 95% chi-square gates used throughout the reference
CHI2_MONO = 5.991  # 2 dof   (Optimizer.cc:905)
CHI2_STEREO = 7.815  # 3 dof (Optimizer.cc:917)


def _sqrt(v):
    return torch.sqrt(v) if torch.is_tensor(v) else math.sqrt(v)


def huber_weight(chi2, delta2):
    """IRLS weight rho'(e2) = min(1, delta/sqrt(e2)) of the Huber kernel."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.clamp(_sqrt(delta2) / e, max=1.0)


def huber_cost(chi2, delta2):
    """Robustified cost rho(chi2): chi2 inside the gate, linear outside."""
    delta = _sqrt(delta2)
    e = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * delta * e - delta2)


def cauchy_weight(chi2, delta2):
    """IRLS weight 1 / (1 + e2 / delta2) of the Cauchy kernel."""
    return 1.0 / (1.0 + chi2 / delta2)
