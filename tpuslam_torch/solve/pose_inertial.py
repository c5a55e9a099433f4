"""Tracking-time visual-inertial frame optimization with a marginalization
prior (port of tpuslam/solve/pose_inertial.py; ref:
Optimizer::PoseInertialOptimizationLastKeyFrame src/Optimizer.cc:7479,
PoseInertialOptimizationLastFrame :7874, Marginalize :5187 and the 15-dim
prior ConstraintPoseImu / EdgePriorPoseImu src/G2oTypes.h:703-783).

One solver covers both variants:
  - anchor = last KEYFRAME, anchor_fixed=True: the anchor's 15-dim block
    is frozen (the LastKeyFrame variant);
  - anchor = last FRAME with a 15-dim prior (H, state) from the previous
    solve, anchor_fixed=False (LastFrame); the anchor block is then
    marginalized out of the final 30x30 Hessian into the next frame's prior.

State per vertex: 15 dims (dp, dphi, dv, dbg, dba), body-frame right
increments as in solve/inertial_ba.py, whose inertial-edge residual this
shares. Visual edges act on the current frame only ("only-pose" edges,
ref EdgeMonoOnlyPose G2oTypes.h:387) with analytic Jacobians through the
camera<-body extrinsic. 4 rounds x 10 LM iterations with per-round chi2
reclassification at the loosening schedule of Optimizer.cc:7537-7540,
Huber weights dropped on the last round. tpuslam's `fori_loop` is a Python
loop with masked accept / reject: nothing waits on the device.
"""

from __future__ import annotations

import torch

from ..core.lie import hat, so3_exp, so3_log
from ..core.linalg import solve, spd_solve
from ..core.robust import huber_cost, huber_weight
from .inertial_ba import _batch_of_one, _edge_residual_of_eps, edge_residual_and_jacobians
from .reproj import PINHOLE, cam_residual

CHI2_MONO_SCHED = (12.0, 7.5, 5.991, 5.991)
CHI2_STEREO_SCHED = (15.6, 9.8, 7.815, 7.815)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _visual_parts(Rwb, p, X, uvr, inv_sigma2, stereo, use, Rcb, tcb, fx, fy, cx, cy, bf,
                  chi2_mono, chi2_stereo, robust, cam=PINHOLE, is_right=None):
    """Only-pose reprojection residuals + Jacobians wrt the frame's (dp,
    dphi): X_b = Rwb^T (X - p), X_c = Rcb X_b + tcb, dXc/ddp = -Rcb,
    dXc/ddphi = Rcb hat(X_b). Returns (r, J [N,3,6], w, chi2, z)."""
    dtype = X.dtype
    Xb = (X - p) @ Rwb
    Xc = Xb @ Rcb.T + tcb
    r, Jproj, z = cam_residual(Xc, uvr, stereo, fx, fy, cx, cy, bf, cam, is_right)
    dXc = torch.cat([(-Rcb).expand(Xb.shape + (3,)), torch.einsum("ij,njk->nik", Rcb, hat(Xb))],
                    -1)
    J = Jproj @ dXc
    chi2 = (r * r).sum(-1) * inv_sigma2
    chi2_th = torch.where(stereo, chi2_stereo, chi2_mono).to(dtype)
    w_rob = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
    w = w_rob * inv_sigma2 * use.to(dtype) * (z > 0).to(dtype)
    return r, J, w, chi2, z


def _prior_residual_of_eps(eps, R, p, v, bg, ba, Rp, pp, vp, bgp, bap):
    """15-dim prior residual (ref EdgePriorPoseImu G2oTypes.h:748): the
    anchor state against the constraint's stored linearization state."""
    Rn = R @ so3_exp(eps[..., 3:6])
    RpT = Rp.transpose(-1, -2)
    er = so3_log(RpT @ Rn)
    ep = _mv(RpT, p + _mv(R, eps[..., 0:3]) - pp)
    return torch.cat([ep, er, v + eps[..., 6:9] - vp, bg + eps[..., 9:12] - bgp,
                      ba + eps[..., 12:15] - bap], -1)


def pose_inertial_solve(R1, p1, v1, bg1, ba1, R2, p2, v2, bg2, ba2, X, uvr, inv_sigma2, stereo,
                        valid, pre, info9, bg0, ba0, rw_info_g, rw_info_a, prior_H, prior_R,
                        prior_p, prior_v, prior_bg, prior_ba, anchor_fixed: bool, Rcb, tcb,
                        fx, fy, cx, cy, bf, n_rounds: int = 4, n_iters: int = 10, cam=PINHOLE,
                        is_right=None):
    """Anchor body state (R1..ba1: last KF or last frame), current-frame
    initial state (R2..ba2), its visual observations, the inertial edge
    anchor -> frame (preintegration dict, 9x9 information, its integration
    biases, the bias random-walk informations), the 15-dim prior on the
    anchor (zero prior_H disables it: the KF variant) and the camera<-body
    extrinsic + intrinsics.

    Returns (R2, p2, v2, bg2, ba2, inliers, H15, n_inliers); H15 is the
    frame's marginal information, the next frame's ConstraintPoseImu."""
    dtype, dev = X.dtype, X.device
    eyeD = torch.eye(30, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z15 = torch.zeros(15, dtype=dtype, device=dev)
    free1 = 0.0 if anchor_fixed else 1.0
    freeF = torch.cat([torch.full((15,), free1, dtype=dtype, device=dev),
                       torch.ones(15, dtype=dtype, device=dev)])
    prior_args = (prior_R, prior_p, prior_v, prior_bg, prior_ba)
    z1 = torch.zeros(1, 15, dtype=dtype, device=dev)

    def prior_jacobian(anchor):
        # a batch of one, as edge_residual_and_jacobians runs one edge
        return torch.func.jacfwd(_prior_residual_of_eps)(
            z1, *_batch_of_one(anchor + prior_args))[0, :, 0]

    def build(state, use, cm, cs, robust):
        R1_, p1_, v1_, bg1_, ba1_, R2_, p2_, v2_, bg2_, ba2_ = state
        H = torch.zeros((30, 30), dtype=dtype, device=dev)
        b = torch.zeros(30, dtype=dtype, device=dev)
        r, J, w, _, _ = _visual_parts(R2_, p2_, X, uvr, inv_sigma2, stereo, use, Rcb, tcb, fx, fy,
                                      cx, cy, bf, cm, cs, robust, cam, is_right)
        JW = J * w[:, None, None]
        H[15:21, 15:21] += torch.einsum("nij,nik->jk", JW, J)
        b[15:21] -= torch.einsum("nij,ni->j", JW, r)
        # inertial edge (the edge's bias = the anchor's, ref EdgeInertial)
        ri, J1, J2 = edge_residual_and_jacobians(R1_, p1_, v1_, bg1_, ba1_, R2_, p2_, v2_, bg0,
                                                 ba0, pre)
        J12 = torch.cat([J1, J2], 1)                                     # [9,30]
        JiW = J12.T @ info9
        H += JiW @ J12
        b -= JiW @ ri
        # bias random-walk edges anchor -> frame (ref EdgeGyroRW / EdgeAccRW)
        for s1, s2, diff, inf in ((slice(9, 12), slice(24, 27), bg2_ - bg1_, rw_info_g),
                                  (slice(12, 15), slice(27, 30), ba2_ - ba1_, rw_info_a)):
            Iw = inf * eye3
            H[s1, s1] += Iw
            H[s2, s2] += Iw
            H[s1, s2] -= Iw
            H[s2, s1] -= Iw
            b[s1] += inf * diff
            b[s2] -= inf * diff
        # prior edge on the anchor
        anchor = (R1_, p1_, v1_, bg1_, ba1_)
        rp = _prior_residual_of_eps(z15, *anchor, *prior_args)
        Jp = prior_jacobian(anchor)
        JpW = Jp.T @ prior_H
        H[:15, :15] += JpW @ Jp
        b[:15] -= JpW @ rp
        return H, b

    def apply_dx(state, dx):
        R1_, p1_, v1_, bg1_, ba1_, R2_, p2_, v2_, bg2_, ba2_ = state
        d1, d2 = dx[:15], dx[15:]
        return (R1_ @ so3_exp(d1[3:6]), p1_ + _mv(R1_, d1[0:3]), v1_ + d1[6:9],
                bg1_ + d1[9:12], ba1_ + d1[12:15],
                R2_ @ so3_exp(d2[3:6]), p2_ + _mv(R2_, d2[0:3]), v2_ + d2[6:9],
                bg2_ + d2[9:12], ba2_ + d2[12:15])

    def cost_terms(state, use, cm, cs, robust):
        """Per-term costs (visual obs, inertial edge, RW edges, prior): the
        f32-safe accept test differences per term before reducing."""
        R1_, p1_, v1_, bg1_, ba1_, R2_, p2_, v2_, bg2_, ba2_ = state
        _, _, _, chi2, z = _visual_parts(R2_, p2_, X, uvr, inv_sigma2, stereo, use, Rcb, tcb,
                                         fx, fy, cx, cy, bf, cm, cs, robust, cam, is_right)
        chi2_th = torch.where(stereo, cs, cm).to(dtype)
        c_v = torch.where(use & (z > 0), huber_cost(chi2, chi2_th) if robust else chi2, 0.0)
        ri = _edge_residual_of_eps(z15, z15, R1_, p1_, v1_, bg1_, ba1_, R2_, p2_, v2_, bg0, ba0,
                                   pre)
        rp = _prior_residual_of_eps(z15, R1_, p1_, v1_, bg1_, ba1_, *prior_args)
        return torch.cat([c_v, torch.stack([
            ri @ info9 @ ri, rw_info_g * ((bg2_ - bg1_) ** 2).sum(),
            rw_info_a * ((ba2_ - ba1_) ** 2).sum(), rp @ prior_H @ rp])])

    state = (R1, p1, v1, bg1, ba1, R2, p2, v2, bg2, ba2)
    use = valid
    for rnd in range(n_rounds):
        cm = CHI2_MONO_SCHED[min(rnd, len(CHI2_MONO_SCHED) - 1)]
        cs = CHI2_STEREO_SCHED[min(rnd, len(CHI2_STEREO_SCHED) - 1)]
        robust = rnd < n_rounds - 1
        # Levenberg-Marquardt with accept / reject (the reference runs plain
        # GN here in double; at f32 an undamped 30-dim step through the
        # mixed-scale H oscillates)
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        c_cur = cost_terms(state, use, cm, cs, robust)
        for _ in range(n_iters):
            H, b = build(state, use, cm, cs, robust)
            Hm = H * (freeF[:, None] * freeF[None, :]) + torch.diag(1.0 - freeF) + 1e-8 * eyeD
            new = apply_dx(state, spd_solve(Hm, b * freeF, damping=lam) * freeF)
            c_new = cost_terms(new, use, cm, cs, robust)
            accept = (c_new - c_cur).sum() < 0
            state = tuple(torch.where(accept, a, b_) for a, b_ in zip(new, state))
            c_cur = torch.where(accept, c_new, c_cur)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e2)
        # re-classify ALL valid observations with this round's threshold
        _, _, _, chi2, z = _visual_parts(state[5], state[6], X, uvr, inv_sigma2, stereo, valid,
                                         Rcb, tcb, fx, fy, cx, cy, bf, cm, cs, False, cam,
                                         is_right)
        use = valid & (chi2 <= torch.where(stereo, cs, cm).to(dtype)) & (z > 0)
    # final Hessian over the inliers (non-robust) -> marginalize the anchor
    H, _ = build(state, use, CHI2_MONO_SCHED[-1], CHI2_STEREO_SCHED[-1], False)
    H15 = _marginalize_anchor(H * (freeF[:, None] * freeF[None, :]))
    return state[5], state[6], state[7], state[8], state[9], use, H15, use.sum()


def _marginalize_anchor(H):
    """The frame's 15 x 15 prior from the [30, 30] Hessian: the Schur
    complement of the anchor block, Jacobi-scaled before factorizing (the
    anchor block mixes fx^2-scale and bias-prior-scale entries; the
    reference runs in double). Where the scaled block is singular, the
    prior is NaN, as jnp.linalg.solve's result is in tpuslam."""
    H11 = H[:15, :15]
    d11 = torch.diagonal(H11)
    good = (d11 > 0) & torch.isfinite(d11)
    s11 = torch.where(good, torch.rsqrt(torch.where(good, d11, 1.0)), 1.0)
    A = H11 * s11[:, None] * s11[None, :] + 1e-6 * torch.eye(15, dtype=H.dtype, device=H.device)
    B12 = s11[:, None] * H[:15, 15:]
    H15 = H[15:, 15:] - B12.T @ solve(A, B12)
    return 0.5 * (H15 + H15.T)
