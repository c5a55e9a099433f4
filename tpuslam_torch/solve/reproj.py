"""Reprojection residuals and analytic Jacobians, generic over the camera
(port of tpuslam/solve/reproj.py; ref: g2o's EdgeSE3ProjectXYZ /
EdgeStereoSE3ProjectXYZOnlyPose, src/OptimizableTypes.h:31-196).

Every solver takes a static `CamSpec`:
  * ``pinhole``: (u, v, uR) rows, uR = uL - bf/z for stereo rows; mono
    rows carry a zero third component so mono and stereo share one
    pipeline.
  * ``kb8``: the Kannala-Brandt theta-polynomial projection. A fisheye rig
    shares no image plane, so its right camera is a second camera rigidly
    attached by Trl (ref EdgeSE3ProjectXYZOnlyPoseToBody,
    OptimizableTypes.h:59): rows flagged ``is_right`` project through it.
    The third row of a stereo row is the scaled inverse depth bf/z, not a
    disparity.
Pose convention: Tcw = (R, t), camera = R @ X_world + t, left-
multiplicative update Tcw' = exp(xi) * Tcw with xi = (rho, phi), so
dXc/d rho = I, dXc/d phi = -hat(Xc), dXc/dX_world = R.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cameras.kb8 import kb8_jac, kb8_project
from ..core.lie import hat


@dataclasses.dataclass(frozen=True)
class CamSpec:
    """Static camera description for optimization residuals.

    kind='pinhole': k/k2/Trl unused (the intrinsics ride in the fx..bf
    scalars every solver takes).
    kind='kb8': ``k`` = the left camera's (k0..k3); for a stereo rig ``k2``
    = the right camera's (fx2, fy2, cx2, cy2, k20..k23) and ``Trl`` = 12
    row-major floats of the right-from-left [R|t] (ref mTrl,
    OptimizableTypes.h:59)."""

    kind: str = "pinhole"
    k: tuple = ()
    k2: tuple = ()
    Trl: tuple = ()

    def right_rt(self, dtype, device=None):
        T = torch.tensor(self.Trl, dtype=dtype, device=device).reshape(3, 4)
        return T[:, :3], T[:, 3]


PINHOLE = CamSpec()


def make_kb8_spec(cam, cam2=None, Trl=None) -> CamSpec:
    """CamSpec of KannalaBrandt8 camera(s); Trl [3,4] or [4,4] right-from-
    left extrinsics (numpy)."""
    k2 = tuple(cam2.full_params) if cam2 is not None else ()
    trl = ()
    if Trl is not None:
        trl = tuple(np.asarray(Trl, np.float64)[:3, :4].reshape(-1).tolist())
    return CamSpec(kind="kb8", k=tuple(cam.full_params)[4:], k2=k2, Trl=trl)


def cam_uv_jac(Xc, is_stereo, fx, fy, cx, cy, bf, cam: CamSpec = PINHOLE, is_right=None):
    """Project camera-frame points and differentiate wrt Xc.

    Xc [...,3] in the LEFT camera frame; is_stereo [...] bool. Returns
    uvr [...,3] predicted (u, v, uR) for pinhole or (u, v, bf/z) for kb8
    (third row 0 where not stereo), Jproj [...,3,3] d(uvr)/dXc (third row
    zeroed where unused), z [...] the depth in the projecting camera (the
    right one for kb8 rig rows, ref isDepthPositive)."""
    dtype = Xc.dtype
    smask = is_stereo.to(dtype)
    if cam.kind == "pinhole":
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        inv_z = 1.0 / zs
        inv_z2 = inv_z * inv_z
        u = fx * x * inv_z + cx
        v = fy * y * inv_z + cy
        ur = u - bf * inv_z
        uvr = torch.stack([u, v, ur * smask], dim=-1)
        zeros = torch.zeros_like(x)
        du = torch.stack([fx * inv_z, zeros, -fx * x * inv_z2], dim=-1)
        dv = torch.stack([zeros, fy * inv_z, -fy * y * inv_z2], dim=-1)
        dur = du + torch.stack([zeros, zeros, bf * inv_z2], dim=-1)
        Jproj = torch.stack([du, dv, dur * smask[..., None]], dim=-2)
        return uvr, Jproj, z

    if cam.kind != "kb8":
        raise ValueError(f"unknown camera kind {cam.kind!r}")
    kl = (fx, fy, cx, cy) + tuple(cam.k)
    uv_l = kb8_project(kl, Xc)
    J_l = kb8_jac(kl, Xc)
    z_l = Xc[..., 2]
    if cam.Trl:
        Rrl, trl = cam.right_rt(dtype, Xc.device)
        Xr = (Rrl @ Xc[..., None])[..., 0] + trl
        uv_r = kb8_project(tuple(cam.k2), Xr)
        J_r = kb8_jac(tuple(cam.k2), Xr) @ Rrl  # chain rule through the rig
        right = is_right if is_right is not None else torch.zeros(
            Xc.shape[:-1], dtype=torch.bool, device=Xc.device)
        rm = right[..., None]
        uv = torch.where(rm, uv_r, uv_l)
        Jp2 = torch.where(rm[..., None], J_r, J_l)
        z = torch.where(right, Xr[..., 2], z_l)
    else:
        uv, Jp2, z = uv_l, J_l, z_l
    # third row: the scaled inverse depth bf/z of stereo rows (depth
    # triangulated across the rig), which pins metric scale as the pinhole
    # uR row does; its noise scales like the disparity row's
    zs_l = torch.where(torch.abs(z_l) < 1e-6, 1e-6, z_l)
    inv_zl = 1.0 / zs_l
    d_row = (bf * inv_zl * smask)[..., None]
    uvr = torch.cat([uv, d_row], dim=-1)
    zeros = torch.zeros_like(z_l)
    J_d = torch.stack([zeros, zeros, -bf * inv_zl * inv_zl * smask], dim=-1)[..., None, :]
    return uvr, torch.cat([Jp2, J_d], dim=-2), z


def cam_residual(Xc, uvr, is_stereo, fx, fy, cx, cy, bf, cam: CamSpec = PINHOLE,
                 is_right=None):
    """(r [N,3], Jproj [N,3,3] = dr/dXc, z [N]) from camera-frame points and
    measured (u, v, uR) (kb8 stereo rows measure bf/z there). Third row
    zeroed for mono rows."""
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
