"""Matrix-free Schur-complement solve via preconditioned CG (port of
`pcg_solve` and its helpers from tpuslam/solve/schur_cg.py; ref: g2o's
BlockSolver_6_3 + sparse Cholesky, Thirdparty/g2o core/block_solver.h).

The reduced camera system S = Hpp - W Hll^-1 W^T is never materialized:

    (S v)[k] = Hpp_d[k] v[k] - sum_{o: kf(o)=k} W_o Hll_inv[pt(o)] y[pt(o)],
    y[j]     = sum_{o: pt(o)=j} W_o^T v[kf(o)],

two scatter-adds over the observations per matvec, O(O) work. The
preconditioner is the exact block-Jacobi of S. The JAX version's
`lax.while_loop` is a masked loop over the fixed iteration count: once
the residual falls below the tolerance the state stops changing, so the
result is the same and the solve never waits on the device. The 15-dim
visual-inertial variant (`vi_matvec`, `pcg_solve_vi`) is the solver of
the distributed FullInertialBA (parallel/dist_ba.py).

With observations sharded over ranks, each rank reduces its own slice and
`psum` (an all-reduce over the ranks) sums the partial landmark, pose and
diagonal blocks; the CG iterations act on replicated [K,6] / [P,3] state.
Every rank leaves the loop after the same iteration (see _pcg), so every
rank makes the same collectives.
"""

from __future__ import annotations

import torch


def _scatter_add(n, index, src):
    out = torch.zeros((n,) + src.shape[1:], dtype=src.dtype, device=src.device)
    return out.index_add_(0, index, src)


def _inv_blocks(A):
    """Batched SPD inverse via Cholesky."""
    L, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.cholesky_solve(eye, L)


# sharded PCG: iterations between two reads of the all-reduced stop flag
STOP_EVERY = 10


def _apply(psum, x):
    return x if psum is None else psum(x)


def schur_matvec(v, Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, psum=None):
    """(S v) for v [K,6]. Wo [O,6,3] (weight-scaled), Hll_inv [P,3,3],
    Hpp_d [K,6,6]. psum: the collective applied to the cross-landmark
    partial sums (sharded mode)."""
    K = Hpp_d.shape[0]
    P = Hll_inv.shape[0]
    y = _apply(psum, _scatter_add(P, obs_pt, torch.einsum("oij,oi->oj", Wo, v[obs_kf])))
    z = torch.einsum("pij,pj->pi", Hll_inv, y)
    out = _apply(psum, _scatter_add(K, obs_kf, torch.einsum("oij,oj->oi", Wo, z[obs_pt])))
    return torch.einsum("kij,kj->ki", Hpp_d, v) - out


def schur_diag(Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, psum=None):
    """Exact 6x6 diagonal blocks of S: Hpp_d[k] - sum_{o in k} W_o Hll_inv W_o^T."""
    M = torch.einsum("oij,ojk,olk->oil", Wo, Hll_inv[obs_pt], Wo)
    return Hpp_d - _apply(psum, _scatter_add(Hpp_d.shape[0], obs_kf, M))


def _pcg(A, M, b, n_iters, tol, psum):
    """Preconditioned CG from x = 0 as a masked loop over n_iters: once the
    residual falls below tol * |b|^2 the state stops changing. Sharded
    (psum given), the ranks leave the loop together once none is active,
    read on an all-reduced flag every STOP_EVERY iterations, so every rank
    makes the same collectives; the result is the masked loop's."""
    x = torch.zeros_like(b)
    r = b
    p = M(r)
    rz = (r * p).sum()
    bnorm = torch.clamp((b * b).sum(), min=1e-30)
    for i in range(n_iters):
        active = (r * r).sum() > tol * bnorm
        if psum is not None and i % STOP_EVERY == 0 and \
                float(psum(active.to(b.dtype)[None])) == 0:
            break
        Ap = A(p)
        denom = (p * Ap).sum()
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, 0.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = M(r_n)
        rz_n = (r_n * z).sum()
        beta = torch.where(torch.abs(rz) > 1e-30, rz_n / rz, 0.0)
        p_n = z + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
    return x


def pcg_solve(b, Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, free6, n_iters: int = 30,
              tol: float = 1e-8, psum=None):
    """Block-Jacobi preconditioned CG on S dx = b. b [K,6]; free6 [K,6]
    bool (False rows pinned to zero: fixed poses). Returns dx [K,6]."""
    dtype = b.dtype
    D = schur_diag(Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, psum)
    fmask = free6.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=b.device)
    # pin fixed rows: identity blocks, zero rhs (keeps D SPD)
    D = D * fmask[:, :, None] * fmask[:, None, :] + eye6 * (1.0 - fmask)[:, None, :] * eye6
    D = D + 1e-9 * eye6
    Dinv = _inv_blocks(D)
    b = b * fmask

    def A(v):
        return schur_matvec(v * fmask, Hpp_d, Hll_inv, Wo, obs_kf, obs_pt, psum) * fmask

    def M(r):
        return torch.einsum("kij,kj->ki", Dinv, r) * fmask

    return _pcg(A, M, b, n_iters, tol, psum)


# --------------------------------------------------------------------------
# 15-dim visual-inertial reduced system (the distributed FullInertialBA's)
# --------------------------------------------------------------------------


def vi_matvec(x, Hdiag, Hoff, edges_a, edges_b, Hll_inv, Wo, obs_kf, obs_pt, psum=None):
    """(S x) for the 15-dim VI reduced system: block-diagonal Hdiag
    [K,15,15] (visual pose blocks + inertial / RW / prior diagonals +
    damping), the inertial chain off-diagonals Hoff [E,15,15] (block a->b;
    its transpose couples b->a), minus the visually marginalized landmark
    term on the 6 pose dims (ref FullInertialBA's BlockSolverX system,
    Optimizer.cc:430, here matrix-free)."""
    K = Hdiag.shape[0]
    P = Hll_inv.shape[0]
    out = torch.einsum("kij,kj->ki", Hdiag, x)
    out = out.index_add(0, edges_a, torch.einsum("eij,ej->ei", Hoff, x[edges_b]))
    out = out.index_add(0, edges_b, torch.einsum("eji,ej->ei", Hoff, x[edges_a]))
    y = _apply(psum, _scatter_add(P, obs_pt, torch.einsum("oij,oi->oj", Wo, x[:, :6][obs_kf])))
    z = torch.einsum("pij,pj->pi", Hll_inv, y)
    o6 = _apply(psum, _scatter_add(K, obs_kf, torch.einsum("oij,oj->oi", Wo, z[obs_pt])))
    return torch.cat([out[:, :6] - o6, out[:, 6:]], dim=1)


def pcg_solve_vi(b, Hdiag, Hoff, edges_a, edges_b, Hll_inv, Wo, obs_kf, obs_pt, free,
                 n_iters: int = 100, tol: float = 1e-12, psum=None):
    """Block-Jacobi PCG on the 15-dim VI reduced system; b / free [K,15].
    The tolerance is tight by default: the VI system's weakly observable
    scale / bias valley converges last in CG, and a loosely truncated step
    walks LM to another point of the valley (tpuslam's measurement)."""
    dtype = b.dtype
    K, Dm = b.shape
    M6 = torch.einsum("oij,ojk,olk->oil", Wo, Hll_inv[obs_pt], Wo)
    D = torch.cat([torch.cat([Hdiag[:, :6, :6] - _apply(psum, _scatter_add(K, obs_kf, M6)),
                              Hdiag[:, :6, 6:]], 2), Hdiag[:, 6:, :]], 1)
    fmask = free.to(dtype)
    eyeD = torch.eye(Dm, dtype=dtype, device=b.device)
    D = D * fmask[:, :, None] * fmask[:, None, :] + eyeD * (1.0 - fmask)[:, None, :] * eyeD
    Dinv = _inv_blocks(D + 1e-9 * eyeD)
    b = b * fmask

    def A(v):
        return vi_matvec(v * fmask, Hdiag, Hoff, edges_a, edges_b, Hll_inv, Wo, obs_kf,
                         obs_pt, psum) * fmask

    def M(r):
        return torch.einsum("kij,kj->ki", Dinv, r) * fmask

    return _pcg(A, M, b, n_iters, tol, psum)
