"""Distributed bundle adjustment over the ranks of a torch.distributed group
(port of tpuslam/parallel/dist_ba.py).

Observations are sharded round-robin over the ranks (tpuslam's mesh axis
"obs"); each rank reduces its own slice into partial Hpp / Hll / W blocks,
and the reduced camera system is solved with the matrix-free PCG of
solve/schur_cg.py, whose per-iteration communication is one all-reduce of
[P,3] and one of [K,6] (tpuslam's psum). No dense [K,K,6,6] system and no
landmark-aligned sharding: cross-rank landmark sums ride the all-reduce.
Poses, points and lambda are replicated. The visual-inertial step
(FullInertialBA, ref Optimizer.cc:420) replicates the inertial chain, the
bias random walk and the priors (E = K-1 is tiny next to O) and shards the
visual blocks the same way.

LM semantics as tpuslam's: each trial step evaluates its post-step cost in
the same call, and the host accepts or rejects the current trial.

JAX drives a mesh from one controller; PyTorch runs one process per rank.
Every rank calls `dist_ba_solve` / `dist_viba_solve` with the whole
problem, packs the observations as tpuslam does and keeps its own slice.
In the engine only rank 0 runs a System: `dispatch` broadcasts each
problem to the other ranks, which wait in `serve` until
`release_followers` (System.shutdown) sends the stop.

Replicated state stays bitwise equal on every rank, so every rank takes
the same branches and makes the same collectives (a collective made on one
rank and not on another hangs until the group's timeout): the accept test
reads all-reduced costs (the replicated inertial cost enters on rank 0
only), the PCG runs a fixed iteration count, and rank 0's accepted state
is broadcast after each accepted step, because index_add_ on CUDA sums in
float atomics and replicated updates could otherwise differ in the last
bits.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..core import lie
from ..solve.ba import BAData, _cost_terms, _inv3x3, _residuals_weights
from ..solve.inertial_ba import _edge_residual_of_eps, _inertial_parts, _mv, _reproj_parts
from ..solve.reproj import PINHOLE
from ..solve.schur_cg import _scatter_add, pcg_solve, pcg_solve_vi
from ..utils import DEFAULT_DEVICE, resolve_device


class RouteCounter:
    """Distributed solves run in this process (each chunk of a chunked GBA
    is one), their LM trials and their accepted steps."""

    def __init__(self):
        self.ba = 0
        self.viba = 0
        self.trials = 0
        self.accepted = 0


counter = RouteCounter()


def multi_rank():
    """True when a torch.distributed process group of more than one rank is
    up (tpuslam's `len(jax.devices()) > 1`)."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _psum_fn(group):
    def psum(x):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x
    return psum


def _psum_many(psum, *xs):
    """psum of several tensors of one dtype in one collective."""
    flat = psum(torch.cat([x.reshape(-1) for x in xs]))
    return _split(flat, xs)


def _split(flat, like):
    out, i = [], 0
    for x in like:
        out.append(flat[i:i + x.numel()].reshape(x.shape))
        i += x.numel()
    return out


def _rank0(group):
    return 0 if group is None else dist.get_global_rank(group, 0)


def _from_rank0(group, *xs):
    """Every rank takes rank 0's values of xs (one broadcast)."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.broadcast(flat, src=_rank0(group), group=group)
    return _split(flat, xs)


def _local_blocks(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid,
                  fx, fy, cx, cy, bf, robust, cam=PINHOLE, right=None):
    """One rank's residual / Jacobian reduction over its observation slice:
    partial (Hpp, bp, Hll, bl), the LOCAL per-observation weighted Jacobian
    blocks Wo and the per-observation cost terms."""
    K, Pn = R.shape[0], X.shape[0]
    d = BAData(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, None, None, None,
               right)
    r, Jp, Jl, w, cost_terms = _residuals_weights(d, fx, fy, cx, cy, bf, robust, cam)
    Jp_w = Jp * w[:, None, None]
    Jl_w = Jl * w[:, None, None]
    Hpp = _scatter_add(K, obs_kf, torch.einsum("oij,oik->ojk", Jp_w, Jp))
    bp = _scatter_add(K, obs_kf, -torch.einsum("oij,oi->oj", Jp_w, r))
    Hll = _scatter_add(Pn, obs_pt, torch.einsum("oij,oik->ojk", Jl_w, Jl))
    bl = _scatter_add(Pn, obs_pt, -torch.einsum("oij,oi->oj", Jl_w, r))
    Wo = torch.einsum("oij,oik->ojk", Jp_w, Jl)
    return Hpp, bp, Hll, bl, Wo, cost_terms


def _cost_local(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid,
                fx, fy, cx, cy, bf, robust, cam=PINHOLE, right=None):
    """Per-observation cost terms of one rank's slice (padding rows add 0)."""
    d = BAData(R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, None, None, None,
               right)
    return _cost_terms(d, fx, fy, cx, cy, bf, robust, cam)


def make_dist_ba_step(group, fx, fy, cx, cy, bf, robust=True, cam=PINHOLE,
                      cg_iters: int = 30):
    """A damped-LM trial step with in-step acceptance over the ranks of
    `group` (None: the default group).

    Replicated: poses (R [K,3,3], t [K,3]), points X [P,3], fixed [K], lam.
    The rank's own slice: obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid
    (and right, the kb8 rig's right-camera rows).

    Returns step(R, t, X, fixed, lam, *obs, right=None) ->
        (R', t', X', cost_before, cost_after),
    (R', t', X') the trial and both costs all-reduced, so the caller
    accepts or rejects the current trial."""
    psum = _psum_fn(group)

    def step(R, t, X, fixed, lam, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid,
             right=None):
        K, Pn = R.shape[0], X.shape[0]
        dtype, dev = X.dtype, X.device
        Hpp, bp, Hll, bl, Wo, cost_terms = _local_blocks(
            R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fx, fy, cx, cy, bf,
            robust, cam, right)
        # the partial sums of every rank, in one collective
        cost0, Hll, bl, Hpp, bp = _psum_many(psum, cost_terms.sum()[None], Hll, bl, Hpp, bp)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hpp_d = Hpp + lam * (eye6 * torch.diagonal(Hpp, dim1=-2, dim2=-1)[..., None, :]) \
            + 1e-9 * eye6
        Hll_d = Hll + lam * (eye3 * torch.diagonal(Hll, dim1=-2, dim2=-1)[..., None, :]) \
            + 1e-9 * eye3
        Hll_inv = _inv3x3(Hll_d)
        # reduced rhs: b_red = bp - sum_o A_o bl[pt(o)]
        Ao = Wo @ Hll_inv[obs_pt]
        b_red = bp - psum(_scatter_add(K, obs_kf,
                                       torch.einsum("oij,oj->oi", Ao, bl[obs_pt])))
        free6 = (~fixed)[:, None].expand(-1, 6)
        dx_pose = pcg_solve(b_red, Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, free6,
                            n_iters=cg_iters, psum=psum)
        # landmark back-substitution
        WtDx = psum(_scatter_add(Pn, obs_pt, torch.einsum("oij,oi->oj", Wo, dx_pose[obs_kf])))
        dx_pt = torch.einsum("pij,pj->pi", Hll_inv, bl - WtDx)
        dR, dt = lie.se3_exp(dx_pose)
        R_new = torch.where(fixed[:, None, None], R, dR @ R)
        t_new = torch.where(fixed[:, None], t, torch.einsum("kij,kj->ki", dR, t) + dt)
        X_new = X + dx_pt
        cost1 = psum(_cost_local(R_new, t_new, X_new, obs_kf, obs_pt, uvr, inv_sigma2, stereo,
                                 valid, fx, fy, cx, cy, bf, robust, cam, right).sum()[None])
        return R_new, t_new, X_new, cost0[0], cost1[0]

    return step


def make_dist_viba_step(group, fx, fy, cx, cy, bf, Rcb, tcb, prior_g: float = 0.0,
                        prior_a: float = 0.0, robust=True, cam=PINHOLE, cg_iters: int = 30):
    """The distributed FullInertialBA trial step (ref Optimizer.cc:420, the
    solve the reference's GBA runs on inertial maps, LoopClosing.cc:2437):
    15-dim keyframe states (body pose, velocity, gyro / acc bias),
    landmarks marginalized matrix-free, the inertial chain, bias random
    walk and priors replicated, the visual observation blocks sharded as in
    make_dist_ba_step. Per CG iteration: one all-reduce of [P,3] and one of
    [K,6].

    Replicated inputs: Rwb [K,3,3], p / v / bg / ba [K,3], X [P,3], fixed
    [K], lam, edges_a / edges_b [E], pre_stack (dict of [E,...]), info9
    [E,9,9], bg0 / ba0 [K,3], rw_g / rw_a [E]. The rank's own slice:
    obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid. Returns (Rwb', p', v',
    bg', ba', X', cost_before, cost_after)."""
    D = 15
    psum = _psum_fn(group)
    lead = dist.get_rank(group) == 0

    def inertial_system(Rwb, p, v, bg, ba, ea, eb, pre_stack, info9, bg0, ba0, rw_g, rw_a):
        """Replicated: diagonal blocks [K,15,15], chain off-diagonals
        [E,15,15], rhs and cost of the inertial, random-walk and prior terms."""
        K, E = Rwb.shape[0], ea.shape[0]
        dtype, dev = Rwb.dtype, Rwb.device
        ri, J1, J2 = _inertial_parts(Rwb, p, v, bg, ba, ea, eb, pre_stack, bg0, ba0)
        J1W = J1.transpose(1, 2) @ info9
        J2W = J2.transpose(1, 2) @ info9
        Hdiag = _scatter_add(K, ea, J1W @ J1).index_add(0, eb, J2W @ J2)
        Hoff = J1W @ J2                         # block (a, b) per edge
        b15 = _scatter_add(K, ea, -torch.einsum("eij,ej->ei", J1W, ri)).index_add(
            0, eb, -torch.einsum("eij,ej->ei", J2W, ri))
        cost = torch.einsum("ei,eij,ej->e", ri, info9, ri).sum()
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        dbg, dba = bg[eb] - bg[ea], ba[eb] - ba[ea]
        for s0, diff, info_rw in ((9, dbg, rw_g), (12, dba, rw_a)):
            Iw = torch.zeros((E, D, D), dtype=dtype, device=dev)
            Iw[:, s0:s0 + 3, s0:s0 + 3] = info_rw[:, None, None] * eye3
            g = torch.zeros((E, D), dtype=dtype, device=dev)
            g[:, s0:s0 + 3] = info_rw[:, None] * diff
            Hdiag = Hdiag.index_add(0, ea, Iw).index_add(0, eb, Iw)
            Hoff = Hoff - Iw
            b15 = b15.index_add(0, ea, g).index_add(0, eb, -g)
        cost = cost + (rw_g[:, None] * dbg ** 2).sum() + (rw_a[:, None] * dba ** 2).sum()
        if prior_g > 0:
            Hdiag[:, 9:12, 9:12] += prior_g * eye3
            b15[:, 9:12] -= prior_g * bg
            cost = cost + prior_g * (bg ** 2).sum()
        if prior_a > 0:
            Hdiag[:, 12:15, 12:15] += prior_a * eye3
            b15[:, 12:15] -= prior_a * ba
            cost = cost + prior_a * (ba ** 2).sum()
        return Hdiag, Hoff, b15, cost

    def inertial_cost(Rwb, p, v, bg, ba, ea, eb, pre_stack, info9, bg0, ba0, rw_g, rw_a):
        z = torch.zeros((1, D), dtype=Rwb.dtype, device=Rwb.device)
        ri = _edge_residual_of_eps(z, z, Rwb[ea], p[ea], v[ea], bg[ea], ba[ea], Rwb[eb],
                                   p[eb], v[eb], bg0[ea], ba0[ea], pre_stack)
        dbg, dba = bg[eb] - bg[ea], ba[eb] - ba[ea]
        cost = (torch.einsum("ei,eij,ej->e", ri, info9, ri).sum()
                + (rw_g[:, None] * dbg ** 2).sum() + (rw_a[:, None] * dba ** 2).sum())
        if prior_g > 0:
            cost = cost + prior_g * (bg ** 2).sum()
        if prior_a > 0:
            cost = cost + prior_a * (ba ** 2).sum()
        return cost

    def step(Rwb, p, v, bg, ba, X, fixed, lam, edges_a, edges_b, pre_stack, info9, bg0, ba0,
             rw_g, rw_a, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid):
        dtype, dev = X.dtype, X.device
        K, Pn = Rwb.shape[0], X.shape[0]
        inertial = (edges_a, edges_b, pre_stack, info9, bg0, ba0, rw_g, rw_a)
        # the rank's visual blocks (body-frame Jacobians + the Tbc extrinsic)
        r, Jp6, Jl, w, cost_v = _reproj_parts(Rwb, p, X, obs_kf, obs_pt, uvr, inv_sigma2,
                                              stereo, valid, fx, fy, cx, cy, bf, Rcb, tcb,
                                              cam, robust=robust)
        Jl_w = Jl * w[:, None, None]
        Jp_w = Jp6 * w[:, None, None]
        Hdiag, Hoff, b15, cost_i = inertial_system(Rwb, p, v, bg, ba, *inertial)
        cost0, Hll, bl, Hpp6, bp6 = _psum_many(
            psum, (cost_v.sum() + (cost_i if lead else 0.0))[None],
            _scatter_add(Pn, obs_pt, torch.einsum("oij,oik->ojk", Jl_w, Jl)),
            _scatter_add(Pn, obs_pt, -torch.einsum("oij,oi->oj", Jl_w, r)),
            _scatter_add(K, obs_kf, torch.einsum("oij,oik->ojk", Jp_w, Jp6)),
            _scatter_add(K, obs_kf, -torch.einsum("oij,oi->oj", Jp_w, r)))
        Hdiag[:, :6, :6] += Hpp6
        b15[:, :6] += bp6
        eyeD = torch.eye(D, dtype=dtype, device=dev)
        diag = torch.diagonal(Hdiag, dim1=-2, dim2=-1)
        Hdiag_d = Hdiag + lam * (eyeD * diag[:, None, :]) + 1e-6 * eyeD
        # split damping (as solve/inertial_ba.py): the landmark blocks keep
        # the 1e-3 flat-direction floor, the 15-dim state system the raw
        # lambda so the stiff inertial chain converges at LM rate
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        lam_ll = torch.clamp(lam, min=1e-3)
        Hll_d = Hll + lam_ll * (eye3 * torch.diagonal(Hll, dim1=-2, dim2=-1)[..., None, :]) \
            + 1e-9 * eye3
        Hll_inv = _inv3x3(Hll_d)
        Wo = torch.einsum("oij,oik->ojk", Jp_w, Jl)
        # reduced rhs: subtract A_o bl on the pose dims
        Ao = Wo @ Hll_inv[obs_pt]
        b_red = b15.clone()
        b_red[:, :6] -= psum(_scatter_add(K, obs_kf, torch.einsum("oij,oj->oi", Ao, bl[obs_pt])))
        # fixed KFs freeze the pose dims only (ref FullInertialBA fixes
        # VertexPose, Optimizer.cc:446-476)
        free = torch.ones((K, D), dtype=torch.bool, device=dev)
        free[:, :6] = ~fixed[:, None]
        dx = pcg_solve_vi(b_red, Hdiag_d, Hoff, edges_a, edges_b, Hll_inv, Wo, obs_kf, obs_pt,
                          free, n_iters=cg_iters, psum=psum)
        WtDx = psum(_scatter_add(Pn, obs_pt, torch.einsum("oij,oi->oj", Wo, dx[obs_kf, :6])))
        dx_pt = torch.einsum("pij,pj->pi", Hll_inv, bl - WtDx)
        new = (Rwb @ lie.so3_exp(dx[:, 3:6]), p + _mv(Rwb, dx[:, 0:3]), v + dx[:, 6:9],
               bg + dx[:, 9:12], ba + dx[:, 12:15], X + dx_pt)
        # post-step cost in the same call (in-step acceptance)
        Rn, pn, vn, bgn, ban, Xn = new
        cost_v1 = _reproj_parts(Rn, pn, Xn, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid,
                                fx, fy, cx, cy, bf, Rcb, tcb, cam, robust=robust)[4].sum()
        cost_i1 = inertial_cost(Rn, pn, vn, bgn, ban, *inertial) if lead else 0.0
        cost1 = psum((cost_v1 + cost_i1)[None])
        return new + (cost0[0], cost1[0])

    return step


def shard_observations(obs_pt, n_shards, pad_multiple=256):
    """Round-robin observation sharding with padding.

    The matrix-free Schur solve psums landmark partials, so observations
    of one landmark MAY span shards — no landmark alignment needed.
    Plain strided round-robin balances load exactly. Returns
    (shards: list[list[int]], per: padded per-shard length)."""
    O = len(np.asarray(obs_pt))
    shards = [list(range(s, O, n_shards)) for s in range(n_shards)]
    per = int(np.ceil(max(max(len(s) for s in shards), 1)
                      / pad_multiple)) * pad_multiple
    return shards, per


def pack_sharded(arr, shards, per, fill):
    """[O,...] -> [n_shards*per, ...] padded per-shard layout."""
    arr = np.asarray(arr)
    out = np.full((len(shards), per) + arr.shape[1:], fill, arr.dtype)
    for s, idx in enumerate(shards):
        out[s, : len(idx)] = arr[idx]
    return out.reshape((len(shards) * per,) + arr.shape[1:])


class LocalRows:
    """This rank's rows of tpuslam's packed per-shard observation layout
    (shard_observations + pack_sharded), as tensors on `device` (floats in
    `dtype`)."""

    def __init__(self, group, obs_pt, device, dtype):
        n_shards = dist.get_world_size(group)
        shards, per = shard_observations(obs_pt, n_shards)
        self.mine = [shards[dist.get_rank(group)]]
        self.per, self.device, self.dtype = per, device, dtype

    def __call__(self, arr, fill, np_dtype):
        packed = pack_sharded(np.asarray(arr, np_dtype), self.mine, self.per, fill)
        t = torch.as_tensor(packed, device=self.device)
        return t.to(self.dtype) if np_dtype == np.float64 else t

    def observations(self, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid):
        return (self(obs_kf, 0, np.int64), self(obs_pt, 0, np.int64),
                self(uvr, 0.0, np.float64), self(inv_sigma2, 0.0, np.float64),
                self(stereo, False, bool), self(valid, False, bool))


def _tensor_fn(device, dtype):
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    return f


def _host(x):
    return x.cpu().numpy().astype(np.float64)


def dist_ba_solve(group, R, t, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid, fixed,
                  fx, fy, cx, cy, bf, n_iters=10, robust=True, cam=PINHOLE,
                  cg_iters: int = 30, right=None, device=DEFAULT_DEVICE,
                  dtype=torch.float32):
    """Host-driven LM loop over the sharded trial step, called by every
    rank of `group` (None: the default group) with the whole problem.

    Inputs numpy; returns numpy (R, t, X) and the cost. One iteration is
    one ACCEPTED step (g2o semantics) with a 3x trial cap, the acceptance
    evaluated on the current trial's post-step cost. right [O] bool flags
    kb8 rig right-camera rows (None: all left). The solve runs on `device`
    in `dtype`."""
    device = resolve_device(device)
    f = _tensor_fn(device, dtype)
    mine = LocalRows(group, obs_pt, device, dtype)
    obs = mine.observations(obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid)
    rt = None if right is None else mine(right, False, bool)
    step = make_dist_ba_step(group, fx, fy, cx, cy, bf, robust, cam, cg_iters)
    Rj, tj, Xj = f(R), f(t), f(X)
    fixedj = torch.as_tensor(np.asarray(fixed, bool), device=device)
    lam = 1e-4
    cost = None
    n_acc = n_tot = 0
    while n_acc < n_iters and n_tot < 3 * n_iters:
        R2, t2, X2, c0, c1 = step(Rj, tj, Xj, fixedj, torch.tensor(lam, dtype=dtype,
                                                                    device=device), *obs, rt)
        c0f, c1f = torch.stack([c0, c1]).tolist()
        cost = c0f if cost is None else cost
        n_tot += 1
        if c1f < c0f:   # in-step acceptance on the CURRENT trial
            Rj, tj, Xj = _from_rank0(group, R2, t2, X2)
            # the same flat-direction floor as ba.py's LM loop (lambda is
            # all that pins low-parallax landmark depths)
            lam = max(lam * 0.5, 1e-3)
            cost = c1f
            n_acc += 1
            if (c0f - c1f) < 1e-8 * max(c0f, 1e-20):
                break
        else:
            lam = min(lam * 4.0, 1e6)
    counter.ba += 1
    counter.trials += n_tot
    counter.accepted += n_acc
    return _host(Rj), _host(tj), _host(Xj), cost


def dist_viba_solve(group, Rwb, p, v, bg, ba, X, obs_kf, obs_pt, uvr, inv_sigma2, stereo,
                    valid, edges_a, edges_b, pre_stack, info9, bg0, ba0, rw_g, rw_a, fixed,
                    fx, fy, cx, cy, bf, Rcb, tcb, prior_g=0.0, prior_a=0.0, n_iters=10,
                    robust=True, cam=PINHOLE, cg_iters: int = 150, device=DEFAULT_DEVICE,
                    dtype=torch.float32):
    """Host-driven LM loop over the sharded VI trial step (the distributed
    FullInertialBA), called by every rank with the whole problem. Inputs
    numpy (pre_stack a dict of [E,...] arrays); returns numpy (Rwb, p, v,
    bg, ba, X) and the cost. cg_iters is generous: a CG iteration costs two
    small all-reduces against the O(O) local reduction, and the VI valley
    needs tight solves (see pcg_solve_vi)."""
    device = resolve_device(device)
    f = _tensor_fn(device, dtype)
    mine = LocalRows(group, obs_pt, device, dtype)
    obs = mine.observations(obs_kf, obs_pt, uvr, inv_sigma2, stereo, valid)
    step = make_dist_viba_step(group, fx, fy, cx, cy, bf, f(Rcb), f(tcb),
                               prior_g=float(prior_g), prior_a=float(prior_a), robust=robust,
                               cam=cam, cg_iters=cg_iters)
    state = [f(x) for x in (Rwb, p, v, bg, ba, X)]
    rep = [torch.as_tensor(np.asarray(e, np.int64), device=device) for e in (edges_a, edges_b)]
    rep += [{k: f(a) for k, a in pre_stack.items()}] + [f(x) for x in (info9, bg0, ba0, rw_g,
                                                                       rw_a)]
    fixedj = torch.as_tensor(np.asarray(fixed, bool), device=device)
    lam = 1e-4
    cost = None
    n_acc = n_tot = 0
    while n_acc < n_iters and n_tot < 3 * n_iters:
        out = step(*state, fixedj, torch.tensor(lam, dtype=dtype, device=device), *rep, *obs)
        c0f, c1f = torch.stack(out[6:]).tolist()
        cost = c0f if cost is None else cost
        n_tot += 1
        if c1f < c0f:
            state = _from_rank0(group, *out[:6])
            # the VI floor is LOWER than the visual 1e-3: the inertial chain
            # and the random-walk / prior edges pin what visual BA leaves
            # flat, and recovery to mm level needs the damping to decay. No
            # early stop: near the optimum the weakly observable scale / bias
            # valley descends in tiny steps that still move the poses
            lam = max(lam * 0.5, 1e-9)
            cost = c1f
            n_acc += 1
        else:
            lam = min(lam * 4.0, 1e6)
    counter.viba += 1
    counter.trials += n_tot
    counter.accepted += n_acc
    return tuple(_host(x) for x in state) + (cost,)


# ------------------------------------------------------------ rank 0 drives
SOLVERS = {"ba": dist_ba_solve, "viba": dist_viba_solve}


class _Lead:
    """Rank 0's side: one lock, so a GBA thread and a mapper thread never
    interleave collectives on the group, and whether the followers were
    released (a process-wide fact, as the process group is)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.released = False


_lead = _Lead()


def route_open():
    """The engine's gate (tpuslam's `len(jax.devices()) > 1`): a group of
    more than one rank is up and its followers have not been released."""
    return multi_rank() and not _lead.released


def dispatch(kind, *args, device=DEFAULT_DEVICE, group=None, **kw):
    """Rank 0: broadcast the problem to the followers waiting in `serve`,
    then solve it with them; `kind` is "ba" (dist_ba_solve) or "viba"
    (dist_viba_solve), args / kw theirs after the group. Returns what the
    solver returns."""
    solve = SOLVERS[kind]
    with _lead.lock:
        if dist.get_rank(group) != 0:
            raise RuntimeError("only rank 0 drives the distributed solves; the other ranks "
                               "serve")
        if _lead.released:
            raise RuntimeError("the followers were released")
        dist.broadcast_object_list([(kind, args, kw)], src=_rank0(group), group=group)
        return solve(group, *args, device=device, **kw)


def release_followers(group=None):
    """Rank 0: send the stop to the ranks in `serve` (System.shutdown);
    nothing outside a group of more than one rank, or on another rank."""
    with _lead.lock:
        if _lead.released or not multi_rank() or dist.get_rank(group) != 0:
            return
        dist.broadcast_object_list([("stop", (), {})], src=_rank0(group), group=group)
        _lead.released = True


def serve(group=None, device=DEFAULT_DEVICE) -> int:
    """A follower rank's loop: receive each problem rank 0 dispatches,
    solve it with the other ranks on `device`, until the stop. Returns the
    number of problems served."""
    n = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=_rank0(group), group=group)
        kind, args, kw = msg[0]
        if kind == "stop":
            return n
        SOLVERS[kind](group, *args, device=device, **kw)
        n += 1
