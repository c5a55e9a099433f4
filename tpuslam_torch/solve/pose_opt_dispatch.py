"""Routing of the motion-only pose solver (port of
tpuslam/solve/pose_opt_dispatch.py).

Pinhole solves go to `pose_opt_cuda.pose_optimize_fused`: the hand-written
CUDA kernel on CUDA tensors, its plain PyTorch version on CPU tensors.
The kernel is f32-only, so the inputs are cast to f32 here. Other camera
kinds go to the camera-generic `pose_opt.pose_optimize`. Both implement
the same LM semantics (ref: Optimizer::PoseOptimization,
src/Optimizer.cc:854-1168).
"""

from __future__ import annotations

import torch

from . import pose_opt_cuda
from .pose_opt import pose_optimize


def pose_optimize_best(R0, t0, X, uvr, inv_sigma2, is_stereo, valid, fx, fy, cx, cy, bf,
                       cam=None, is_right=None, **kw):
    """pose_optimize, routed to the fused kernel for pinhole cameras.
    Returns (R, t, inliers, chi2)."""
    if cam is not None and getattr(cam, "kind", "pinhole") != "pinhole":
        return pose_optimize(R0, t0, X, uvr, inv_sigma2, is_stereo, valid, fx, fy, cx, cy,
                             bf, cam=cam, is_right=is_right, **kw)
    f32 = torch.float32

    def c(x):
        return x.to(f32).contiguous()

    return pose_opt_cuda.pose_optimize_fused(
        c(R0), c(t0), c(X), c(uvr), c(inv_sigma2), is_stereo.contiguous(),
        valid.contiguous(), fx, fy, cx, cy, bf, **kw)
