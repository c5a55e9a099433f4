"""Sim(3) pose-graph optimization: the essential graph (port of
tpuslam/solve/pose_graph.py; ref: Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:2347 — loop + spanning-tree + strong-covisibility edges,
7 DoF for mono, scale fixed for stereo/RGB-D).

Per-edge 7-dim residuals with block Jacobians from torch.func.jacfwd
(the increments are shared by all edges, so one jacfwd gives every
edge's block); then either a dense blocked [7K, 7K] system solved by
`spd_solve`, or, past 256 vertices, a matrix-free block-Jacobi PCG over
the edge blocks. tpuslam's `lax.scan` loops are Python loops over their
fixed counts with masked (torch.where) accept/reject, so no iteration
waits on the device.

On an IMU-initialized map the graph is the 4-DoF variant
(OptimizeEssentialGraph4DoF, Optimizer.cc:8305): gravity pins pitch and
roll and the scale is metric, so only yaw and translation relax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lie import (se3_compose, se3_inverse, se3_log, sim3_compose, sim3_exp,
                        sim3_inverse, sim3_log)
from ..core.linalg import inv, spd_solve
from ..utils import DEFAULT_DEVICE, resolve_device


def _index_add(n, index, src):
    out = torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, index, src)


def _graph_pcg(Hd, Bij, ei, ej, b, free, n_cg: int):
    """Matrix-free PCG on the pose-graph normal equations. Hd [K,D,D]
    damped diagonal blocks; Bij [E,D,D] off-diagonal blocks (H_ij =
    Ji^T W Jj, H_ji = Bij^T); b [K,D]; free [K,D] bool. Preconditioner:
    block-Jacobi."""
    K, D = b.shape
    fmask = free.to(b.dtype)
    eye = torch.eye(D, dtype=b.dtype, device=b.device)
    Hdm = Hd * fmask[:, :, None] * fmask[:, None, :] + (1.0 - fmask)[:, :, None] * eye[None]
    Minv = inv(Hdm + 1e-8 * eye[None])

    def matvec(x):
        y = torch.einsum("kij,kj->ki", Hdm, x)
        coup = _index_add(K, ei, torch.einsum("eij,ej->ei", Bij, x[ej]))
        coup = coup + _index_add(K, ej, torch.einsum("eji,ej->ei", Bij, x[ei]))
        return y + coup * fmask

    def safe(v):
        return torch.where(torch.abs(v) < 1e-30, 1e-30, v)

    r = b * fmask
    x = torch.zeros_like(r)
    z = torch.einsum("kij,kj->ki", Minv, r)
    p = z
    rz = (r * z).sum()
    for _ in range(n_cg):
        Ap = matvec(p)
        alpha = rz / safe((p * Ap).sum())
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("kij,kj->ki", Minv, r)
        rz_new = (r * z).sum()
        p = z + (rz_new / safe(rz)) * p
        rz = rz_new
    return torch.where(torch.isfinite(x).all(), x, 0.0) * fmask


def _edge_residuals(eps_i, eps_j, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """r = log(S_meas_ji o S_i o S_j^-1) per edge, with LEFT increments
    S' = exp(eps) o S (g2o VertexSim3Expmap::oplusImpl). eps [1,7] is
    shared by all edges: jacfwd with respect to it yields every edge's
    block (a batch of one, since under torch.func a 0-dim tangent meeting a
    Python scalar promotes to f64)."""
    dsi, dRi, dti = sim3_exp(eps_i)
    dsj, dRj, dtj = sim3_exp(eps_j)
    si2, Ri2, ti2 = sim3_compose(dsi, dRi, dti, si, Ri, ti)
    sj2, Rj2, tj2 = sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
    s1, R1, t1 = sim3_compose(si2, Ri2, ti2, *sim3_inverse(sj2, Rj2, tj2))
    return sim3_log(*sim3_compose(sm, Rm, tm, s1, R1, t1))


def pose_graph_solve(s, R, t, edges_i, edges_j, s_m, R_m, t_m, edge_w, fixed,
                     n_iters: int = 20, fix_scale: bool = False, lam: float = 1e-6,
                     use_cg: bool = False, n_cg: int = 150):
    """Optimize Scw per keyframe. Edges: i (from), j (to), measured S_ji
    (j <- i), scalar weight; fixed [K] pins vertices; fix_scale freezes the
    7th DoF. LM with mu x0.3 on accept and x5 on reject, clipped to
    [1e-9, 1e6]. Returns (s, R, t, cost)."""
    K, D = s.shape[0], 7
    dtype, dev = t.dtype, t.device
    ei, ej = edges_i.long(), edges_j.long()
    z7 = torch.zeros(1, D, dtype=dtype, device=dev)
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    w = edge_w.to(dtype)

    def edge_args(state):
        s_, R_, t_ = state
        return (s_[ei], R_[ei], t_[ei], s_[ej], R_[ej], t_[ej], s_m, R_m, t_m)

    def cost_terms(state):
        return w * (_edge_residuals(z7, z7, *edge_args(state)) ** 2).sum(-1)

    free = (~fixed)[:, None].expand(K, D).clone()
    if fix_scale:
        free[:, 6] = False
    freeF = free.reshape(K * D)
    state = (s, R, t)
    mu = torch.tensor(1e-5, dtype=dtype, device=dev)
    cost = cost_terms(state).sum()
    for _ in range(n_iters):
        args = edge_args(state)
        r = _edge_residuals(z7, z7, *args)                               # [E,7]
        Ji, Jj = (J[:, :, 0] for J in torch.func.jacfwd(_edge_residuals, argnums=(0, 1))(
            z7, z7, *args))                                              # [E,7,7]
        JiT = Ji.transpose(1, 2) * w[:, None, None]
        JjT = Jj.transpose(1, 2) * w[:, None, None]
        Hii = _index_add(K, ei, JiT @ Ji) + _index_add(K, ej, JjT @ Jj)  # diagonal blocks
        b = (_index_add(K, ei, -torch.einsum("eij,ej->ei", JiT, r))
             + _index_add(K, ej, -torch.einsum("eij,ej->ei", JjT, r)))
        diag = torch.diagonal(Hii, dim1=-2, dim2=-1)
        Hd = Hii + mu * eyeD * diag[:, None, :] + lam * eyeD
        if use_cg:
            dx = _graph_pcg(Hd, JiT @ Jj, ei, ej, b, free, n_cg)
        else:
            H = torch.zeros((K, K, D, D), dtype=dtype, device=dev)
            H[torch.arange(K, device=dev), torch.arange(K, device=dev)] = Hd
            H.index_put_((ei, ej), JiT @ Jj, accumulate=True)
            H.index_put_((ej, ei), JjT @ Ji, accumulate=True)
            S = H.permute(0, 2, 1, 3).reshape(K * D, K * D)
            S = torch.where(freeF[:, None] & freeF[None, :], S, 0.0)
            S = S + torch.diag(torch.where(freeF, 0.0, 1.0).to(dtype))
            rhs = torch.where(freeF, b.reshape(-1), 0.0)
            dx = spd_solve(S, rhs).reshape(K, D)
        new = sim3_compose(*sim3_exp(dx), *state)
        # f32-safe acceptance: per-edge cost differences, then the sum
        delta = (cost_terms(new) - cost_terms(state)).sum()
        accept = delta < 0
        state = tuple(torch.where(accept, a, b_) for a, b_ in zip(new, state))
        mu = torch.clamp(torch.where(accept, mu * 0.3, mu * 5.0), 1e-9, 1e6)
        cost = cost + torch.where(accept, delta, 0.0)
    return state + (cost,)


def _rz(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _edge4_residual(eps_i, eps_j, Ri, ti, Rj, tj, Rm, tm):
    """6-dim SE(3) residual with 4-dim world-frame increments (tau[3], yaw)
    per vertex (ref Edge4DoF / VertexPose4DoF src/G2oTypes.h:833,152):
    Tcw' = Tcw o G^-1, G = (Rz(yaw), tau). eps [1,4] is shared by every
    edge, so one jacfwd yields each edge's blocks."""
    def corr(eps, R, t):
        Rn = R @ _rz(eps[..., 3]).transpose(-1, -2)
        return Rn, t - (Rn @ eps[..., :3, None])[..., 0]

    Ri2, ti2 = corr(eps_i, Ri, ti)
    Rj2, tj2 = corr(eps_j, Rj, tj)
    R1, t1 = se3_compose(Ri2, ti2, *se3_inverse(Rj2, tj2))
    return se3_log(*se3_compose(Rm, tm, R1, t1))


def pose_graph_solve_4dof(R, t, edges_i, edges_j, R_m, t_m, edge_w, fixed, n_iters: int = 20,
                          lam: float = 1e-6, use_cg: bool = False, n_cg: int = 150):
    """4-DoF (yaw + translation) essential graph for inertial maps (ref
    OptimizeEssentialGraph4DoF Optimizer.cc:8305): the blocked structure of
    the Sim3 solve with D = 4. Returns (R, t, cost)."""
    K, D = R.shape[0], 4
    dtype, dev = t.dtype, t.device
    ei, ej = edges_i.long(), edges_j.long()
    z4 = torch.zeros(1, D, dtype=dtype, device=dev)
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    w = edge_w.to(dtype)

    def edge_args(state):
        R_, t_ = state
        return (R_[ei], t_[ei], R_[ej], t_[ej], R_m, t_m)

    def cost_terms(state):
        return w * (_edge4_residual(z4, z4, *edge_args(state)) ** 2).sum(-1)

    free = (~fixed)[:, None].expand(K, D)
    freeF = free.reshape(K * D)
    state = (R, t)
    mu = torch.tensor(1e-5, dtype=dtype, device=dev)
    cost = cost_terms(state).sum()
    for _ in range(n_iters):
        args = edge_args(state)
        r = _edge4_residual(z4, z4, *args)                                 # [E,6]
        Ji, Jj = (J[:, :, 0] for J in torch.func.jacfwd(_edge4_residual, argnums=(0, 1))(
            z4, z4, *args))                                                # [E,6,4]
        JiT = Ji.transpose(1, 2) * w[:, None, None]
        JjT = Jj.transpose(1, 2) * w[:, None, None]
        Hii = _index_add(K, ei, JiT @ Ji) + _index_add(K, ej, JjT @ Jj)
        b = (_index_add(K, ei, -torch.einsum("eij,ej->ei", JiT, r))
             + _index_add(K, ej, -torch.einsum("eij,ej->ei", JjT, r)))
        diag = torch.diagonal(Hii, dim1=-2, dim2=-1)
        Hd = Hii + mu * eyeD * diag[:, None, :] + lam * eyeD
        if use_cg:
            dx = _graph_pcg(Hd, JiT @ Jj, ei, ej, b, free, n_cg)
        else:
            H = torch.zeros((K, K, D, D), dtype=dtype, device=dev)
            H[torch.arange(K, device=dev), torch.arange(K, device=dev)] = Hd
            H.index_put_((ei, ej), JiT @ Jj, accumulate=True)
            H.index_put_((ej, ei), JjT @ Ji, accumulate=True)
            S = H.permute(0, 2, 1, 3).reshape(K * D, K * D)
            S = torch.where(freeF[:, None] & freeF[None, :], S, 0.0)
            S = S + torch.diag(torch.where(freeF, 0.0, 1.0).to(dtype))
            dx = spd_solve(S, torch.where(freeF, b.reshape(-1), 0.0)).reshape(K, D)
        Rn = state[0] @ _rz(dx[:, 3]).transpose(-1, -2)
        new = (Rn, state[1] - (Rn @ dx[:, :3, None])[..., 0])
        # f32-safe acceptance: per-edge cost differences, then the sum
        delta = (cost_terms(new) - cost_terms(state)).sum()
        accept = delta < 0
        state = tuple(torch.where(accept, a, b_) for a, b_ in zip(new, state))
        mu = torch.clamp(torch.where(accept, mu * 0.3, mu * 5.0), 1e-9, 1e6)
        cost = cost + torch.where(accept, delta, 0.0)
    return state + (cost,)


def optimize_essential_graph(m, loop_edges, corrected, fix_kf, fix_scale: bool = False,
                             min_covis_weight=100, n_iters: int = 20, old_poses=None,
                             four_dof: bool = False, fix_kfs=None, device=DEFAULT_DEVICE,
                             dtype=torch.float64):
    """Host-side graph assembly + solve over the map `m` (ref
    OptimizeEssentialGraph edge selection: loop edges + spanning tree +
    covisibility weight >= 100).

    loop_edges: [(kf_a, kf_b, (s, R, t) Sim3 b <- a measured)];
    corrected: {kf: (s, R, t)} corrected Scw seeds; the others seed from
    their pose with s = 1. Relative measurements come from `old_poses`
    (the pre-correction poses, ref NonCorrectedSim3) where given. Writes the
    poses back, translation rescaled by 1/s (ref :2610-2635), and returns
    {kf: (s, R, t)} for the map-point correction. `device`/`dtype`: where
    and in what float type the solve runs. four_dof: the inertial map's
    graph (yaw + translation; the Sim3 seeds and measurements collapse to
    SE(3), t / s; ref LoopClosing.cc:1218-1224)."""
    device = resolve_device(device)
    kfs = list(m.valid_kf_ids())
    idx = {int(k): i for i, k in enumerate(kfs)}
    K = len(kfs)
    s0 = np.ones(K)
    R0 = np.zeros((K, 3, 3))
    t0 = np.zeros((K, 3))
    for k in kfs:
        i = idx[int(k)]
        if int(k) in corrected:
            s0[i], R0[i], t0[i] = corrected[int(k)]
        else:
            R0[i] = m.kf_R[k]
            t0[i] = m.kf_t[k]

    def pose_of(k):
        if old_poses is not None and k in old_poses:
            return old_poses[k]
        return m.kf_R[k], m.kf_t[k]

    def rel(ka, kb):
        """S_b <- a from the pre-correction poses, scale 1."""
        Ra, ta = pose_of(ka)
        Rb, tb = pose_of(kb)
        Rba = Rb @ Ra.T
        return 1.0, Rba, tb - Rba @ ta

    ei, ej, sm, Rm, tm, ew = [], [], [], [], [], []
    seen = set()

    def add_edge(ka, kb, meas, w=1.0):
        key = (min(ka, kb), max(ka, kb))
        if key in seen or ka == kb:
            return
        seen.add(key)
        ei.append(idx[ka])
        ej.append(idx[kb])
        sm.append(meas[0])
        Rm.append(meas[1])
        tm.append(meas[2])
        ew.append(w)

    for (ka, kb, meas) in loop_edges:
        if ka in idx and kb in idx:
            add_edge(int(ka), int(kb), meas, w=1.0)
    for k in kfs:
        k = int(k)
        parent = int(m.kf_parent[k])
        if parent >= 0 and parent in idx:
            add_edge(k, parent, rel(k, parent))
        for o, w in m.covis[k].items():
            if w >= min_covis_weight and int(o) in idx:
                add_edge(k, int(o), rel(k, int(o)))
    if not ei:
        return {}
    fixed = np.zeros(K, bool)
    if fix_kf in idx:
        fixed[idx[fix_kf]] = True
    # fix_kfs pins a whole side: an Atlas merge keeps the merge map's frame
    # (ref MergeLocal vpFixedKFs, LoopClosing.cc:1760-1830)
    for k in (fix_kfs or ()):
        if int(k) in idx:
            fixed[idx[int(k)]] = True

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # past ~256 vertices the dense [7K x 7K] factorization is the cost:
    # matrix-free PCG (the reference's sparse-Cholesky role)
    use_cg = K > 256
    n_cg = int(min(max(2 * K, 100), 400))
    fixed_t = torch.as_tensor(fixed, device=device)
    if four_dof:
        Rf, tf, _ = pose_graph_solve_4dof(
            f(R0), f(t0 / s0[:, None]), i(ei), i(ej), f(np.stack(Rm)),
            f(np.stack(tm) / np.array(sm)[:, None]), f(ew), fixed_t, n_iters=n_iters,
            use_cg=use_cg, n_cg=n_cg)
        Rf = Rf.cpu().numpy().astype(np.float64)
        tf = tf.cpu().numpy().astype(np.float64)
        out = {}
        for k in kfs:
            i_ = idx[int(k)]
            out[int(k)] = (1.0, Rf[i_], tf[i_])
            m.kf_R[k] = Rf[i_]
            m.kf_t[k] = tf[i_]
        return out
    sf, Rf, tf, _ = pose_graph_solve(
        f(s0), f(R0), f(t0), i(ei), i(ej), f(sm), f(np.stack(Rm)), f(np.stack(tm)), f(ew),
        fixed_t, n_iters=n_iters, fix_scale=fix_scale, use_cg=use_cg, n_cg=n_cg)
    sf = sf.cpu().numpy().astype(np.float64)
    Rf = Rf.cpu().numpy().astype(np.float64)
    tf = tf.cpu().numpy().astype(np.float64)
    out = {}
    for k in kfs:
        i_ = idx[int(k)]
        out[int(k)] = (float(sf[i_]), Rf[i_], tf[i_])
        m.kf_R[k] = Rf[i_]
        m.kf_t[k] = tf[i_] / sf[i_]   # [R | t/s] (ref Optimizer.cc:2621)
    return out
