"""Bundle adjustment: batched LM with a blocked Schur complement (port of
tpuslam/solve/ba.py; the g2o replacement, ref: Thirdparty/g2o
core/block_solver.h BlockSolver_6_3 as used by
Optimizer::LocalBundleAdjustment, src/Optimizer.cc:1699).

  * observations as flat tensors (kf idx, pt idx, measurement), residuals
    and Jacobians batched;
  * Hpp / Hll / W blocks by index_add over the observations; landmarks
    marginalized with batched 3x3 inverses;
  * the pose-pose coupling W Hll^-1 W^T assembled from OBSERVATION PAIRS
    sharing a landmark (host-built index lists) into a dense [6K,6K]
    reduced camera system solved by `spd_solve`, or, past
    CG_MIN_PAIRS pair blocks, the matrix-free block-PCG of schur_cg.py;
  * LM damping with accept/reject, Huber IRLS weights, fixed poses by
    row/col masking.

The math is dtype-generic: f32 on the card, f64 where a caller asks. The
LM loop is a Python loop with one host read per trial (the accept flag
and the stall test), which the mapper can afford; tpuslam's
`lax.while_loop` has the same exits. tpuslam pads K, P, O and Q to shape
buckets to reuse compiled programs; padded poses are fixed and padded
observations invalid, so eager PyTorch runs the real sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import lie
from ..core.linalg import spd_solve
from ..core.robust import CHI2_MONO, CHI2_STEREO, huber_cost, huber_weight
from ..utils import DEFAULT_DEVICE, resolve_device
from .reproj import PINHOLE, project_residuals
from .schur_cg import _scatter_add, pcg_solve

# pair-scatter blocks (sum over points of degree^2) above which the
# matrix-free PCG replaces the dense reduced system
CG_MIN_PAIRS = 300_000


def build_obs_pairs(obs_pt: np.ndarray, n_points: int):
    """Host-side: all ordered pairs of observation indices sharing a point.
    Returns (pair_a [Q], pair_b [Q]) int32, Q = sum_j deg_j^2, vectorized
    per degree bucket."""
    obs_pt = np.asarray(obs_pt)
    order = np.argsort(obs_pt, kind="stable")
    sorted_pt = obs_pt[order]
    _, starts, counts = np.unique(sorted_pt, return_index=True, return_counts=True)
    pair_a = []
    pair_b = []
    for d in np.unique(counts):
        s = starts[counts == d]                                # [G] group starts
        block = order[(s[:, None] + np.arange(d)[None, :])]    # [G, d]
        pair_a.append(np.repeat(block, d, axis=1).ravel())
        pair_b.append(np.tile(block, (1, d)).ravel())
    if not pair_a:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate(pair_a).astype(np.int32),
            np.concatenate(pair_b).astype(np.int32))


@dataclass
class BAData:
    """One BA problem on the device (index tensors are int64)."""

    R: torch.Tensor          # [K,3,3] Tcw rotations
    t: torch.Tensor          # [K,3]
    X: torch.Tensor          # [P,3]
    obs_kf: torch.Tensor     # [O]
    obs_pt: torch.Tensor     # [O]
    uvr: torch.Tensor        # [O,3]
    inv_sigma2: torch.Tensor # [O]
    stereo: torch.Tensor     # [O] bool
    valid: torch.Tensor      # [O] bool
    fixed: torch.Tensor      # [K] bool
    pair_a: torch.Tensor     # [Q] obs indices
    pair_b: torch.Tensor     # [Q]
    right: torch.Tensor | None = None  # [O] bool: kb8 rig right-camera rows


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate)."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj / det[..., None, None]


def _residuals_weights(d: BAData, fx, fy, cx, cy, bf, robust: bool, cam=PINHOLE):
    r, Jp, Jl, z = project_residuals(d.R[d.obs_kf], d.t[d.obs_kf], d.X[d.obs_pt], d.uvr,
                                     d.stereo, fx, fy, cx, cy, bf, cam, d.right)
    chi2 = (r * r).sum(-1) * d.inv_sigma2
    chi2_th = torch.where(d.stereo, CHI2_STEREO, CHI2_MONO).to(r.dtype)
    w_rob = huber_weight(chi2, chi2_th) if robust else torch.ones_like(chi2)
    w = w_rob * d.inv_sigma2 * d.valid.to(r.dtype) * (z > 0).to(r.dtype)
    # per-observation cost terms: callers difference them before summing
    # (an f32-safe accept test needs the cancellation before the reduction)
    cost = torch.where(d.valid & (z > 0), huber_cost(chi2, chi2_th) if robust else chi2, 0.0)
    return r, Jp, Jl, w, cost


def _assemble_blocks(d: BAData, lam, fx, fy, cx, cy, bf, robust: bool, cam=PINHOLE):
    """Damped block diagonals + weighted coupling blocks (shared by the
    dense-pair and the matrix-free step)."""
    K = d.R.shape[0]
    P = d.X.shape[0]
    dtype = d.X.dtype
    r, Jp, Jl, w, cost = _residuals_weights(d, fx, fy, cx, cy, bf, robust, cam)
    Jp_w = Jp * w[:, None, None]
    Hpp = _scatter_add(K, d.obs_kf, torch.einsum("oij,oik->ojk", Jp_w, Jp))
    bp = _scatter_add(K, d.obs_kf, -torch.einsum("oij,oi->oj", Jp_w, r))
    Jl_w = Jl * w[:, None, None]
    Hll = _scatter_add(P, d.obs_pt, torch.einsum("oij,oik->ojk", Jl_w, Jl))
    bl = _scatter_add(P, d.obs_pt, -torch.einsum("oij,oi->oj", Jl_w, r))
    Wo = torch.einsum("oij,oik->ojk", Jp_w, Jl)  # [O,6,3]
    # LM damping (multiplicative on the block diagonals, g2o-style)
    eye6 = torch.eye(6, dtype=dtype, device=d.X.device)
    eye3 = torch.eye(3, dtype=dtype, device=d.X.device)
    Hpp_d = Hpp + lam * (eye6 * torch.diagonal(Hpp, dim1=-2, dim2=-1)[..., None, :]) + 1e-9 * eye6
    Hll_d = Hll + lam * (eye3 * torch.diagonal(Hll, dim1=-2, dim2=-1)[..., None, :]) + 1e-9 * eye3
    return Hpp_d, bp, _inv3x3(Hll_d), bl, Wo, cost


def _apply_step(d: BAData, dx_pose, Hll_inv, Wo, bl):
    """Back-substitute the landmarks and apply the SE(3) increments."""
    P = d.X.shape[0]
    WtDx = _scatter_add(P, d.obs_pt, torch.einsum("oij,oi->oj", Wo, dx_pose[d.obs_kf]))
    dx_pt = torch.einsum("pij,pj->pi", Hll_inv, bl - WtDx)
    dR, dt = lie.se3_exp(dx_pose)
    R_new = dR @ d.R
    t_new = torch.einsum("kij,kj->ki", dR, d.t) + dt
    R_new = torch.where(d.fixed[:, None, None], d.R, R_new)
    t_new = torch.where(d.fixed[:, None], d.t, t_new)
    return R_new, t_new, d.X + dx_pt


def _gn_step_cg(d: BAData, lam, fx, fy, cx, cy, bf, robust: bool, cam=PINHOLE,
                cg_iters: int = 30):
    """Damped GN step with the matrix-free Schur solve (no pair lists)."""
    Hpp_d, bp, Hll_inv, bl, Wo, cost = _assemble_blocks(d, lam, fx, fy, cx, cy, bf, robust,
                                                        cam)
    Ao = Wo @ Hll_inv[d.obs_pt]
    b_red = bp - _scatter_add(bp.shape[0], d.obs_kf,
                              torch.einsum("oij,oj->oi", Ao, bl[d.obs_pt]))
    free6 = (~d.fixed)[:, None].expand(-1, 6)
    dx_pose = pcg_solve(b_red, Hpp_d, Hll_inv, Wo, d.obs_kf, d.obs_pt, free6,
                        n_iters=cg_iters)
    return _apply_step(d, dx_pose, Hll_inv, Wo, bl)


def _gn_step(d: BAData, lam, fx, fy, cx, cy, bf, robust: bool, cam=PINHOLE):
    """One damped GN step (dense-pair reduced system + exact Cholesky)."""
    K = d.R.shape[0]
    dtype = d.X.dtype
    dev = d.X.device
    Hpp_d, bp, Hll_inv, bl, Wo, cost = _assemble_blocks(d, lam, fx, fy, cx, cy, bf, robust,
                                                        cam)
    Ao = Wo @ Hll_inv[d.obs_pt]  # [O,6,3]
    # reduced camera system S = Hpp - sum_pairs A_{o1} W_{o2}^T
    Mq = Ao[d.pair_a] @ Wo[d.pair_b].transpose(-1, -2)  # [Q,6,6]
    blk = d.obs_kf[d.pair_a] * K + d.obs_kf[d.pair_b]
    S = _scatter_add(K * K, blk, -Mq)
    diag = torch.arange(K, device=dev) * (K + 1)
    S = S.index_add_(0, diag, Hpp_d)
    S = S.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    b_red = bp - _scatter_add(K, d.obs_kf, torch.einsum("oij,oj->oi", Ao, bl[d.obs_pt]))
    b_red = b_red.reshape(K * 6)
    # fixed poses: identity rows/cols
    free6 = (~d.fixed).repeat_interleave(6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(dtype))
    b_red = torch.where(free6, b_red, 0.0)
    # LM damping is already in S through the block damping above
    dx_pose = spd_solve(S, b_red).reshape(K, 6)
    return _apply_step(d, dx_pose, Hll_inv, Wo, bl)


def _cost_terms(d: BAData, fx, fy, cx, cy, bf, robust: bool, cam=PINHOLE):
    """Per-observation cost terms [O]."""
    return _residuals_weights(d, fx, fy, cx, cy, bf, robust, cam)[4]


def ba_solve(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fixed, pair_a, pair_b,
             fx, fy, cx, cy, bf, n_iters: int = 10, robust: bool = True, lam0: float = 1e-4,
             cam=PINHOLE, right=None, use_cg: bool = False, cg_iters: int = 30):
    """LM loop with g2o iteration semantics: n_iters counts ACCEPTED steps
    (a rejected trial raises lambda and retries), with a 3x total-trial
    cap and a relative-gain stall exit. right [O] bool flags kb8 rig
    right-camera observations (None: all left). Returns (R, t, X,
    final_cost)."""
    dtype = X.dtype
    rel_tol = 1e-8
    obs_kf, obs_pt = obs_kf.long(), obs_pt.long()
    pair_a, pair_b = pair_a.long(), pair_b.long()

    def data(R, t, X):
        return BAData(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fixed,
                      pair_a, pair_b, right)

    cost = _cost_terms(data(R, t, X), fx, fy, cx, cy, bf, robust, cam).sum()
    lam = torch.tensor(lam0, dtype=dtype, device=X.device)
    n_acc = 0
    for _ in range(3 * n_iters):
        if n_acc >= n_iters:
            break
        d = data(R, t, X)
        if use_cg:
            R2, t2, X2 = _gn_step_cg(d, lam, fx, fy, cx, cy, bf, robust, cam, cg_iters)
        else:
            R2, t2, X2 = _gn_step(d, lam, fx, fy, cx, cy, bf, robust, cam)
        delta = (_cost_terms(data(R2, t2, X2), fx, fy, cx, cy, bf, robust, cam)
                 - _cost_terms(d, fx, fy, cx, cy, bf, robust, cam)).sum()
        accept = delta < 0
        R = torch.where(accept, R2, R)
        t = torch.where(accept, t2, t)
        X = torch.where(accept, X2, X)
        cost = cost + torch.where(accept, delta, 0.0)
        # the floor at 1e-3 pins the flat directions (depth of low-parallax
        # landmarks) to their initialization, as in tpuslam
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-3, 1e6)
        stalled = accept & (-delta < rel_tol * torch.clamp(cost, min=1e-20))
        acc, stop = torch.stack([accept, stalled]).tolist()  # the one host read
        n_acc += int(acc)
        if stop:
            break
    return R, t, X, cost


def ba_chi2(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, fx, fy, cx, cy, bf,
            cam=PINHOLE, right=None):
    """Per-observation chi2 + positive-depth flags (outlier pruning between
    BA phases, ref Optimizer.cc:2064-2120)."""
    obs_kf, obs_pt = obs_kf.long(), obs_pt.long()
    r, _, _, z = project_residuals(R[obs_kf], t[obs_kf], X[obs_pt], uvr, stereo,
                                   fx, fy, cx, cy, bf, cam, right)
    return (r * r).sum(-1) * inv_sigma2, z > 0


def ba_solve_np(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fixed,
                fx, fy, cx, cy, bf, n_iters=10, robust=True, cam=PINHOLE, right=None,
                device=DEFAULT_DEVICE, dtype=torch.float32):
    """Numpy-facing BA on `device` in `dtype`. Returns numpy (R, t, X,
    chi2 [O], pos_depth [O]) with chi2 evaluated at the solution."""
    device = resolve_device(device)
    P = len(X)
    obs_pt = np.asarray(obs_pt)
    deg = np.bincount(obs_pt, minlength=P).astype(np.int64)
    use_cg = float((deg ** 2).sum()) > CG_MIN_PAIRS
    if use_cg:
        pa = pb = np.zeros(1, np.int32)
    else:
        pa, pb = build_obs_pairs(obs_pt, P)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    args = (f(R), f(t), f(X), i(obs_kf), i(obs_pt), f(uvr), f(inv_sigma2), b(stereo))
    rt = None if right is None else b(right)
    Rf, tf, Xf, _ = ba_solve(*args, b(valid), b(fixed), i(pa), i(pb), fx, fy, cx, cy, bf,
                             n_iters=n_iters, robust=robust, cam=cam, right=rt, use_cg=use_cg)
    chi2, posz = ba_chi2(Rf, tf, Xf, *args[3:], fx, fy, cx, cy, bf, cam=cam, right=rt)

    def host(x):
        return x.cpu().numpy()

    return host(Rf).astype(np.float64), host(tf).astype(np.float64), \
        host(Xf).astype(np.float64), host(chi2).astype(np.float64), host(posz)
