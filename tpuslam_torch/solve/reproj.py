"""Reprojection residuals and analytic Jacobians (port of
tpuslam/solve/reproj.py, pinhole branch; ref: g2o's
EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZOnlyPose,
src/OptimizableTypes.h:31-196).

Pinhole rows are (u, v, uR), uR = uL - bf/z for stereo rows; mono rows
carry a zero third component so mono and stereo share one pipeline.
Pose convention: Tcw = (R, t), camera = R @ X_world + t, left-
multiplicative update Tcw' = exp(xi) * Tcw with xi = (rho, phi), so
dXc/d rho = I, dXc/d phi = -hat(Xc), dXc/dX_world = R.

The Kannala-Brandt (kb8) branch waits for the fisheye slice: a `CamSpec`
of another kind raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.lie import hat


@dataclasses.dataclass(frozen=True)
class CamSpec:
    """Static camera description for optimization residuals (the fields
    of tpuslam's CamSpec; pinhole intrinsics ride in the fx..bf scalars)."""

    kind: str = "pinhole"
    k: tuple = ()
    k2: tuple = ()
    Trl: tuple = ()


PINHOLE = CamSpec()


def _require_pinhole(cam: CamSpec):
    if cam.kind != "pinhole":
        raise NotImplementedError(
            f"camera kind {cam.kind!r}: only pinhole residuals are ported "
            "(fisheye is ROADMAP item 'Fisheye')")


def cam_uv_jac(Xc, is_stereo, fx, fy, cx, cy, bf, cam: CamSpec = PINHOLE, is_right=None):
    """Project camera-frame points and differentiate wrt Xc.

    Returns uvr [...,3] predicted (u, v, uR) (third row 0 for mono rows),
    Jproj [...,3,3] d(uvr)/dXc (third row zeroed where unused), z [...]."""
    _require_pinhole(cam)
    dtype = Xc.dtype
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy
    ur = u - bf * inv_z
    smask = is_stereo.to(dtype)
    uvr = torch.stack([u, v, ur * smask], dim=-1)
    zeros = torch.zeros_like(x)
    du = torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1)
    dv = torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zeros, zeros, bf * inv_z2], dim=-1)
    Jproj = torch.stack([du, dv, dur * smask[..., None]], dim=-2)
    return uvr, Jproj, z


def cam_residual(Xc, uvr, is_stereo, fx, fy, cx, cy, bf, cam: CamSpec = PINHOLE,
                 is_right=None):
    """(r [N,3], Jproj [N,3,3] = dr/dXc, z [N]) from camera-frame points and
    measured (u, v, uR). Third row zeroed for mono rows."""
    pred, Jproj, z = cam_uv_jac(Xc, is_stereo, fx, fy, cx, cy, bf, cam, is_right)
    meas_mask = torch.ones_like(pred)
    meas_mask[..., 2] = is_stereo.to(pred.dtype)
    r = (pred - uvr * meas_mask) * meas_mask
    return r, Jproj, z


def project_residuals(R, t, X, uvr, is_stereo, fx, fy, cx, cy, bf,
                      cam: CamSpec = PINHOLE, is_right=None):
    """Residuals and Jacobians for one pose (or one pose per observation).

    R [...,3,3], t [...,3]; X [N,3] world points; uvr [N,3]; is_stereo [N].
    Returns r [N,3], J_pose [N,3,6], J_point [N,3,3], z [N]."""
    Xc = (R @ X[..., None])[..., 0] + t
    r, Jproj, z = cam_residual(Xc, uvr, is_stereo, fx, fy, cx, cy, bf, cam, is_right)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(Xc.shape + (3,))
    dX_dxi = torch.cat([eye, -hat(Xc)], dim=-1)  # [N,3,6]
    J_pose = Jproj @ dX_dxi
    J_point = Jproj @ R
    return r, J_pose, J_point, z


def obs_chi2(r, inv_sigma2, is_stereo):
    """Per-observation chi2 with per-level information (ref: Optimizer.cc
    setInformation(I * invSigma2))."""
    return (r * r).sum(dim=-1) * inv_sigma2
