"""Visual-inertial bundle adjustment (port of tpuslam/solve/inertial_ba.py;
ref: Optimizer::FullInertialBA src/Optimizer.cc:420, LocalInertialBA
:4574; vertices / edges of src/G2oTypes.h: VertexPose / VertexVelocity /
VertexGyroBias / VertexAccBias, EdgeInertial :492, EdgeGyroRW :632,
EdgeAccRW :668, EdgePriorGyro/Acc :784-833).

State per keyframe: 15 dims — body pose (Rwb, p; right-multiplicative
body-frame increments like ImuCamPose::Update), velocity v, gyro bias bg,
accelerometer bias ba. Landmarks are marginalized with the pair-scatter
Schur machinery of the visual BA; the reduced system is dense
[15K x 15K] with tridiagonal-block inertial coupling. Reprojection
Jacobians are analytic; the inertial-edge Jacobians come from
torch.func.jacfwd on the residual's increment parameterization: the
increments are shared by every edge (a batch of one), so one jacfwd yields
every edge's blocks. tpuslam's `lax.scan` over the LM steps is a Python
loop with masked accept / reject: no step waits on the device.
"""

from __future__ import annotations

import torch

from ..core.lie import hat, so3_exp
from ..core.linalg import spd_solve
from ..core.robust import CHI2_MONO, CHI2_STEREO, huber_cost, huber_weight
from ..imu.preintegration import inertial_residual
from ..utils import jacfwd
from .ba import _inv3x3
from .reproj import PINHOLE, cam_residual
from .schur_cg import _scatter_add


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _reproj_parts(Rwb, p, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fx, fy, cx, cy,
                  bf, Rcb=None, tcb=None, cam=PINHOLE, is_right=None, robust=True):
    """Residuals + Jacobians wrt the body-frame increments (dp, dphi) and X.

    Xb = Rwb^T (X - p); Xc = Rcb Xb + tcb (identity when Rcb / tcb are
    None). Updates p' = p + Rwb dp, Rwb' = Rwb Exp(dphi), so dXc/ddp = -Rcb,
    dXc/ddphi = Rcb hat(Xb), dXc/dX = Rcb Rwb^T. Returns (r, Jp [O,3,6],
    Jl [O,3,3], w, per-observation cost); robust=False drops the Huber
    kernel."""
    dtype = X.dtype
    Rk = Rwb[obs_kf]
    Xb = torch.einsum("oji,oj->oi", Rk, X[obs_pt] - p[obs_kf])   # Rwb^T (X - p)
    Xc = Xb if Rcb is None else Xb @ Rcb.T + tcb
    r, Jproj, z = cam_residual(Xc, uvr, stereo, fx, fy, cx, cy, bf, cam, is_right)
    if Rcb is None:
        eye = torch.eye(3, dtype=dtype, device=X.device).expand(Xb.shape + (3,))
        dXc_du = torch.cat([-eye, hat(Xb)], -1)
        Jl = Jproj @ Rk.transpose(-1, -2)
    else:
        dXc_du = torch.cat([(-Rcb).expand(Xb.shape + (3,)),
                            torch.einsum("ij,ojk->oik", Rcb, hat(Xb))], -1)
        Jl = Jproj @ torch.einsum("ij,okj->oik", Rcb, Rk)
    Jp = Jproj @ dXc_du
    chi2 = (r * r).sum(-1) * inv_sigma2
    chi2_th = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    w_rob = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
    w = w_rob * inv_sigma2 * valid.to(dtype) * (z > 0).to(dtype)
    cost = torch.where(valid & (z > 0), huber_cost(chi2, chi2_th) if robust else chi2, 0.0)
    return r, Jp, Jl, w, cost


def _edge_residual_of_eps(eps1, eps2, Rwb1, p1, v1, bg1, ba1, Rwb2, p2, v2, bg0, ba0, pre):
    """The inertial residual as a function of the two 15-dim increments
    (dp, dphi, dv, dbg, dba): the jacfwd target."""
    R1 = Rwb1 @ so3_exp(eps1[..., 3:6])
    P1 = p1 + _mv(Rwb1, eps1[..., 0:3])
    R2 = Rwb2 @ so3_exp(eps2[..., 3:6])
    P2 = p2 + _mv(Rwb2, eps2[..., 0:3])
    return inertial_residual(R1, P1, v1 + eps1[..., 6:9], R2, P2, v2 + eps2[..., 6:9],
                             bg1 + eps1[..., 9:12], ba1 + eps1[..., 12:15], bg0, ba0, pre)


def _batch_of_one(args):
    return tuple({k: v[None] for k, v in a.items()} if isinstance(a, dict) else a[None]
                 for a in args)


def edge_residual_and_jacobians(*args):
    """(r [...,9], J1 [...,9,15], J2 [...,9,15]) of _edge_residual_of_eps at
    zero increments; args as its arguments after the increments. One edge
    runs as a batch of one: torch.func.jacfwd promotes the tangent of a
    0-dim f32 intermediate to f64 when it meets a Python scalar, and a
    batch keeps every intermediate at least 1-dim."""
    batched = args[0].dim() == 3
    if not batched:
        args = _batch_of_one(args)
    z = torch.zeros(1, 15, dtype=args[0].dtype, device=args[0].device)
    r = _edge_residual_of_eps(z, z, *args)
    J1, J2 = jacfwd(_edge_residual_of_eps, argnums=(0, 1))(z, z, *args)
    J1, J2 = J1[:, :, 0], J2[:, :, 0]
    if not batched:
        r, J1, J2 = r[0], J1[0], J2[0]
    return r, J1, J2


def _inertial_parts(Rwb, p, v, bg, ba, edges_a, edges_b, pre_stack, bg0, ba0):
    """Residuals r [E,9] and Jacobians J1, J2 [E,9,15] of the inertial chain.
    The bias of an edge is its FIRST keyframe's (ref EdgeInertial uses
    VG1 / VA1)."""
    return edge_residual_and_jacobians(
        Rwb[edges_a], p[edges_a], v[edges_a], bg[edges_a], ba[edges_a],
        Rwb[edges_b], p[edges_b], v[edges_b], bg0[edges_a], ba0[edges_a], pre_stack)


def vi_ba_solve(Rwb, p, v, bg, ba, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid,
                edges_a, edges_b, pre_stack, info9, bg0, ba0, fixed_pose, pair_a, pair_b,
                fx, fy, cx, cy, bf, rw_info_g, rw_info_a, Rcb=None, tcb=None,
                prior_g: float = 0.0, prior_a: float = 0.0, n_iters: int = 10,
                cam=PINHOLE, is_right=None):
    """Damped GN loop for visual-inertial BA. Returns (Rwb, p, v, bg, ba, X,
    cost). fixed_pose [K] freezes the 6 pose dims of a KF (velocity and
    biases stay free, ref FullInertialBA fixes VertexPose only,
    Optimizer.cc:446-476); prior_g / prior_a: zero-mean bias priors (ref
    FullInertialBA priorG / priorA)."""
    K, P, D = Rwb.shape[0], X.shape[0], 15
    dtype, dev = X.dtype, X.device
    obs_kf, obs_pt = obs_kf.long(), obs_pt.long()
    ea, eb = edges_a.long(), edges_b.long()
    pair_a, pair_b = pair_a.long(), pair_b.long()
    ar = torch.arange(K, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    # bias random-walk edge blocks: r = b_next - b_prev (ref EdgeGyroRW /
    # EdgeAccRW)
    RW = torch.zeros((ea.shape[0], D, D), dtype=dtype, device=dev)
    RW[:, 9:12, 9:12] = rw_info_g[:, None, None] * eye3
    RW[:, 12:15, 12:15] = rw_info_a[:, None, None] * eye3
    free = torch.ones((K, D), dtype=torch.bool, device=dev)
    free[:, :6] = ~fixed_pose[:, None]
    freeF = free.reshape(K * D)

    def step(state, lam):
        Rwb, p, v, bg, ba, X = state
        r, Jp6, Jl, w, _ = _reproj_parts(Rwb, p, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo,
                                         valid, fx, fy, cx, cy, bf, Rcb, tcb, cam,
                                         is_right)
        Jl_w = Jl * w[:, None, None]
        Hll = _scatter_add(P, obs_pt, torch.einsum("oij,oik->ojk", Jl_w, Jl))
        bl = _scatter_add(P, obs_pt, -torch.einsum("oij,oi->oj", Jl_w, r))
        Jp_w = Jp6 * w[:, None, None]
        H = torch.zeros((K, K, D, D), dtype=dtype, device=dev)
        b = torch.zeros((K, D), dtype=dtype, device=dev)
        H[ar, ar, :6, :6] = _scatter_add(K, obs_kf, torch.einsum("oij,oik->ojk", Jp_w, Jp6))
        b[:, :6] = _scatter_add(K, obs_kf, -torch.einsum("oij,oi->oj", Jp_w, r))
        # inertial + random-walk edges
        ri, J1, J2 = _inertial_parts(Rwb, p, v, bg, ba, ea, eb, pre_stack, bg0, ba0)
        J1W = J1.transpose(1, 2) @ info9                                   # [E,15,9]
        J2W = J2.transpose(1, 2) @ info9
        H.index_put_((ea, ea), J1W @ J1 + RW, accumulate=True)
        H.index_put_((ea, eb), J1W @ J2 - RW, accumulate=True)
        H.index_put_((eb, ea), J2W @ J1 - RW, accumulate=True)
        H.index_put_((eb, eb), J2W @ J2 + RW, accumulate=True)
        diff = torch.cat([bg[eb] - bg[ea], ba[eb] - ba[ea]], -1)            # [E,6]
        rw = torch.cat([rw_info_g[:, None].expand(-1, 3), rw_info_a[:, None].expand(-1, 3)], -1)
        b = b.index_add(0, ea, -torch.einsum("eij,ej->ei", J1W, ri))
        b = b.index_add(0, eb, -torch.einsum("eij,ej->ei", J2W, ri))
        b[:, 9:15] = b[:, 9:15].index_add(0, ea, rw * diff).index_add(0, eb, -rw * diff)
        # zero-mean bias priors
        if prior_g > 0:
            H[ar, ar, 9:12, 9:12] += prior_g * eye3
            b[:, 9:12] -= prior_g * bg
        if prior_a > 0:
            H[ar, ar, 12:15, 12:15] += prior_a * eye3
            b[:, 12:15] -= prior_a * ba
        # landmark marginalization (Schur, pair scatter). Split damping: the
        # landmark blocks keep a 1e-3 floor (low-parallax depth is the flat
        # subspace that wanders at f32), the 15-dim system the raw lambda
        lam_ll = torch.clamp(lam, min=1e-3)
        Hll_d = (Hll + lam_ll * (eye3 * torch.diagonal(Hll, dim1=-2, dim2=-1)[..., None, :])
                 + 1e-9 * eye3)
        Hll_inv = _inv3x3(Hll_d)
        Wo = torch.einsum("oij,oik->ojk", Jp_w, Jl)                          # [O,6,3]
        Ao = Wo @ Hll_inv[obs_pt]
        S6 = torch.zeros((K, K, 6, 6), dtype=dtype, device=dev)
        S6.index_put_((obs_kf[pair_a], obs_kf[pair_b]), Ao[pair_a] @ Wo[pair_b].transpose(-1, -2),
                      accumulate=True)
        H[:, :, :6, :6] -= S6
        b[:, :6] -= _scatter_add(K, obs_kf, torch.einsum("oij,oj->oi", Ao, bl[obs_pt]))
        diag = torch.diagonal(H[ar, ar], dim1=-2, dim2=-1)
        H[ar, ar] += lam * eyeD * diag[:, None, :] + 1e-6 * eyeD
        S = H.permute(0, 2, 1, 3).reshape(K * D, K * D)
        S = torch.where(freeF[:, None] & freeF[None, :], S, 0.0)
        S = S + torch.diag(torch.where(freeF, 0.0, 1.0).to(dtype))
        dx = spd_solve(S, torch.where(freeF, b.reshape(K * D), 0.0)).reshape(K, D)
        # landmark back-substitution, then the increments
        WtDx = _scatter_add(P, obs_pt, torch.einsum("oij,oi->oj", Wo, dx[obs_kf, :6]))
        dx_pt = torch.einsum("pij,pj->pi", Hll_inv, bl - WtDx)
        return (Rwb @ so3_exp(dx[:, 3:6]), p + _mv(Rwb, dx[:, 0:3]), v + dx[:, 6:9],
                bg + dx[:, 9:12], ba + dx[:, 12:15], X + dx_pt)

    def cost_terms(state):
        """Per-term cost vector (obs, inertial edges, RW edges, priors): the
        f32-safe accept test differences per term before reducing."""
        Rwb, p, v, bg, ba, X = state
        c_v = _reproj_parts(Rwb, p, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fx, fy,
                            cx, cy, bf, Rcb, tcb, cam, is_right)[4]
        ri = _edge_residual_of_eps(
            torch.zeros(1, 15, dtype=dtype, device=dev), torch.zeros(1, 15, dtype=dtype, device=dev),
            Rwb[ea], p[ea], v[ea], bg[ea], ba[ea], Rwb[eb], p[eb], v[eb], bg0[ea], ba0[ea],
            pre_stack)
        c_i = torch.einsum("ei,eij,ej->e", ri, info9, ri)
        c_rw = (rw_info_g * ((bg[eb] - bg[ea]) ** 2).sum(-1)
                + rw_info_a * ((ba[eb] - ba[ea]) ** 2).sum(-1))
        c_pr = prior_g * (bg ** 2).sum(-1) + prior_a * (ba ** 2).sum(-1)
        return torch.cat([c_v, c_i, c_rw, c_pr])

    state = (Rwb, p, v, bg, ba, X)
    c_cur = cost_terms(state)
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    for _ in range(n_iters):
        new = step(state, lam)
        c_new = cost_terms(new)
        accept = (c_new - c_cur).sum() < 0
        state = tuple(torch.where(accept, a, b_) for a, b_ in zip(new, state))
        c_cur = torch.where(accept, c_new, c_cur)
        # the floor bounds the flat directions' wander at f32 (tpuslam)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e6)
    return state + (c_cur.sum(),)
