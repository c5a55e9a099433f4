"""On-manifold IMU preintegration (Forster et al.), port of
tpuslam/imu/preintegration.py.

The reference's IMU::Preintegrated (src/ImuTypes.cc:255
IntegrateNewMeasurement): delta rotation / velocity / position, the
first-order bias Jacobians (JRg, JVg, JVa, JPg, JPa), the 15x15 covariance
(9 preintegration states + 6 bias random walk), the bias-update correction
(GetDeltaRotation/Velocity/Position, ImuTypes.h:216-233) and the IMU state
prediction (Tracking::PredictStateIMU, src/Tracking.cc:669).

tpuslam's `lax.scan` is a Python loop over the samples; the per-sample
rotations, right Jacobians and covariance step blocks that do not depend
on the running state are computed for all samples at once before it. A
sample with dt <= 0 is the identity update, as tpuslam's padding rows are.
The residual helpers broadcast over leading batch dimensions, so one call
serves a chain of edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.lie import hat, so3_exp, so3_log, so3_right_jacobian

GRAVITY = 9.81  # ref: ImuTypes.h:40 GRAVITY_VALUE

PRE_KEYS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C", "dT")


@dataclass
class ImuCalib:
    """Noise densities (continuous) and extrinsics (ref: IMU::Calib)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0
    Tbc: np.ndarray | None = None  # body<-camera 4x4 (None = identity)

    # camera <-> body extrinsic pieces (X_b = Rbc X_c + tbc; the YAML / ref
    # `Tbc` is the camera-to-body transform, IMU::Calib ImuTypes.h:87)
    @property
    def Rbc(self) -> np.ndarray:
        return np.eye(3) if self.Tbc is None else np.asarray(self.Tbc[:3, :3], np.float64)

    @property
    def tbc(self) -> np.ndarray:
        return np.zeros(3) if self.Tbc is None else np.asarray(self.Tbc[:3, 3], np.float64)

    @property
    def Rcb(self) -> np.ndarray:
        """X_c = Rcb X_b + tcb."""
        return self.Rbc.T

    @property
    def tcb(self) -> np.ndarray:
        return -self.Rbc.T @ self.tbc

    def body_from_cam(self, Rcw, tcw):
        """Camera pose Tcw -> body state (Rwb, p_wb): Twb = Twc o Tcb (ref
        KeyFrame::GetImuRotation / GetImuPosition)."""
        Rwc = np.asarray(Rcw).T
        Ow = -Rwc @ np.asarray(tcw)
        return Rwc @ self.Rcb, Rwc @ self.tcb + Ow

    def cam_from_body(self, Rwb, p):
        """Body state -> camera pose Tcw: Twc = Twb o Tbc."""
        Rwc = np.asarray(Rwb) @ self.Rbc
        Ow = np.asarray(Rwb) @ self.tbc + np.asarray(p)
        return Rwc.T, -Rwc.T @ Ow

    def discrete_cov(self):
        f = self.freq
        return (self.noise_gyro ** 2 * f, self.noise_acc ** 2 * f,
                self.walk_gyro ** 2 * f, self.walk_acc ** 2 * f)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


def preintegrate(w, a, dt, bg, ba, ng2, na2, wg2, wa2):
    """Integrate gyro w [N,3], accel a [N,3], steps dt [N] (<= 0: skipped)
    from biases bg, ba [3]. Noise parameters are DISCRETE variances.

    Returns a dict of tensors: dR [3,3], dV [3], dP [3], JRg, JVg, JVa,
    JPg, JPa [3,3], C [15,15], dT (total time)."""
    dtype, dev = w.dtype, w.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    dt = torch.clamp(dt, min=0.0)
    n = w.shape[0]
    # per-sample quantities that do not depend on the running state
    acc = a - ba
    Wacc = hat(acc)
    phi = (w - bg) * dt[:, None]
    dRi = so3_exp(phi)
    Jr_dt = so3_right_jacobian(phi) * dt[:, None, None]
    # covariance step blocks of ImuTypes.cc:269-290; the rows that need the
    # running rotation are filled inside the loop
    A0 = torch.zeros((n, 9, 9), dtype=dtype, device=dev)
    A0[:, 0:3, 0:3] = _T(dRi)
    A0[:, 3:6, 3:6] = eye
    A0[:, 6:9, 3:6] = eye * dt[:, None, None]
    A0[:, 6:9, 6:9] = eye
    B0 = torch.zeros((n, 9, 6), dtype=dtype, device=dev)
    B0[:, 0:3, 0:3] = Jr_dt
    noise = torch.tensor([ng2] * 3 + [na2] * 3, dtype=dtype, device=dev)
    dR = eye.clone()
    dV = torch.zeros(3, dtype=dtype, device=dev)
    dP = torch.zeros(3, dtype=dtype, device=dev)
    JRg, JVg, JVa, JPg, JPa = (torch.zeros((3, 3), dtype=dtype, device=dev) for _ in range(5))
    C9 = torch.zeros((9, 9), dtype=dtype, device=dev)
    for i in range(n):
        d = dt[i]
        Ra = dR @ acc[i]
        RW = dR @ Wacc[i]
        # position / velocity use the PRE-update rotation (ref :255 order)
        dP = dP + dV * d + 0.5 * Ra * d * d
        dV = dV + Ra * d
        A = A0[i].clone()
        A[3:6, 0:3] = -RW * d
        A[6:9, 0:3] = -0.5 * RW * d * d
        B = B0[i].clone()
        B[3:6, 3:6] = dR * d
        B[6:9, 3:6] = 0.5 * dR * d * d
        C9 = A @ C9 @ A.T + (B * noise) @ B.T
        # bias Jacobians (ref :296-301; JP before JV, both from the
        # pre-update JV / JR)
        RWJ = RW @ JRg
        JPa = JPa + JVa * d - 0.5 * dR * d * d
        JPg = JPg + JVg * d - 0.5 * RWJ * d * d
        JVa = JVa - dR * d
        JVg = JVg - RWJ * d
        JRg = _T(dRi[i]) @ JRg - Jr_dt[i]
        dR = dR @ dRi[i]
    C = torch.zeros((15, 15), dtype=dtype, device=dev)
    C[:9, :9] = C9
    # the bias random-walk blocks only accumulate
    C[9:12, 9:12] = eye * (wg2 * dt).sum()
    C[12:15, 12:15] = eye * (wa2 * dt).sum()
    return dict(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, C=C,
                dT=dt.sum())


def corrected_delta(pre, dbg, dba):
    """First-order bias-corrected deltas (ref: GetDeltaRotation / Velocity /
    Position, ImuTypes.h:216-233)."""
    dR = pre["dR"] @ so3_exp(_mv(pre["JRg"], dbg))
    dV = pre["dV"] + _mv(pre["JVg"], dbg) + _mv(pre["JVa"], dba)
    dP = pre["dP"] + _mv(pre["JPg"], dbg) + _mv(pre["JPa"], dba)
    return dR, dV, dP


def _gravity(ref):
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=ref.dtype, device=ref.device)


def predict_state(Rwb, p, v, pre, dbg=None, dba=None):
    """IMU-only state propagation over the preintegration interval (ref:
    Tracking::PredictStateIMU Tracking.cc:669). Gravity is (0, 0, -G)."""
    g = _gravity(pre["dV"])
    dT = pre["dT"]
    if dbg is None:
        dR, dV, dP = pre["dR"], pre["dV"], pre["dP"]
    else:
        dR, dV, dP = corrected_delta(pre, dbg, dba)
    return (Rwb @ dR, p + v * dT + 0.5 * g * dT * dT + _mv(Rwb, dP),
            v + g * dT + _mv(Rwb, dV))


def inertial_residual(Rwb1, p1, v1, Rwb2, p2, v2, bg, ba, bg0, ba0, pre):
    """9-dim preintegration residual (ref: EdgeInertial G2oTypes.h:492);
    (bg0, ba0) are the biases the preintegration ran at, (bg, ba) the
    current estimates, first-order corrected. Broadcasts over leading
    dimensions (pre["dT"] then has the batch shape)."""
    g = _gravity(pre["dV"])
    dT = pre["dT"][..., None]
    dR, dV, dP = corrected_delta(pre, bg - bg0, ba - ba0)
    R1T = _T(Rwb1)
    er = so3_log(_T(dR) @ R1T @ Rwb2)
    ev = _mv(R1T, v2 - v1 - g * dT) - dV
    ep = _mv(R1T, p2 - p1 - v1 * dT - 0.5 * g * dT * dT) - dP
    return torch.cat([er, ev, ep], dim=-1)


def information_from_cov(C9, eps=None):
    """Information matrix of the 9-dim residual (ref GetInformationMatrix:
    the inverse of the preintegration covariance, symmetrized), f32-robust:
    Jacobi-scaled before the inverse, with a regularizer RELATIVE to each
    diagonal (tpuslam's rationale: rotation and position covariances differ
    by ~1e4 and an absolute floor deflated short-window position
    information)."""
    dtype = C9.dtype
    if eps is None:
        eps = 1e-6 if dtype in (torch.float32, torch.bfloat16, torch.float16) else 1e-12
    Cs = 0.5 * (C9 + _T(C9))
    d = torch.diagonal(Cs, dim1=-2, dim2=-1)
    good = (d > 0) & torch.isfinite(d)
    s = torch.where(good, torch.rsqrt(torch.where(good, d, 1.0)), 1.0)
    eye = torch.eye(9, dtype=dtype, device=C9.device)
    In = torch.linalg.inv(Cs * s[..., :, None] * s[..., None, :] + eps * eye)
    In = 0.5 * (In + _T(In))
    return In * s[..., :, None] * s[..., None, :]


def merge_preintegrations(pre1, pre2):
    """Concatenate two preintegrations (ref: MergePrevious ImuTypes.cc:312),
    both integrated at the same bias."""
    dR1, dV1, dT2 = pre1["dR"], pre1["dV"], pre2["dT"]
    return dict(
        dR=dR1 @ pre2["dR"],
        dV=dV1 + _mv(dR1, pre2["dV"]),
        dP=pre1["dP"] + dV1 * dT2 + _mv(dR1, pre2["dP"]),
        JRg=_T(pre2["dR"]) @ pre1["JRg"] + pre2["JRg"],
        JVg=pre1["JVg"] + dR1 @ pre2["JVg"],  # approximate merge
        JVa=pre1["JVa"] + dR1 @ pre2["JVa"],
        JPg=pre1["JPg"] + pre1["JVg"] * dT2 + dR1 @ pre2["JPg"],
        JPa=pre1["JPa"] + pre1["JVa"] * dT2 + dR1 @ pre2["JPa"],
        C=pre1["C"] + pre2["C"],  # upper bound; exact propagation needs a re-run
        dT=pre1["dT"] + dT2,
    )


def pre_to(pre, device, dtype):
    """A preintegration (numpy or tensors) as tensors on `device` in `dtype`."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(
        device=device, dtype=dtype) for k, v in pre.items()}


def pre_stack(pres, device, dtype):
    """Stack preintegrations along a new leading edge dimension."""
    return {k: torch.stack([torch.as_tensor(np.asarray(p[k]) if not torch.is_tensor(p[k])
                                            else p[k]).to(device=device, dtype=dtype)
                            for p in pres]) for k in PRE_KEYS}
