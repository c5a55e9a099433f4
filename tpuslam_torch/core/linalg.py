"""f32-robust dense SPD solve for normal equations (port of
tpuslam/core/linalg.py:30).

The card solves in f32 while the reference runs g2o in double
(Thirdparty/g2o linear_solver_eigen.h). Reprojection normal matrices are
conditioned at 1e6-1e9, so `spd_solve`:
  * Jacobi-scales H to unit diagonal (D^-1/2 H D^-1/2);
  * damps the scaled system, i.e. Marquardt's relative lambda * diag(H);
  * solves by Cholesky, with one step of iterative refinement;
  * returns dx = 0 where the factorization failed or the result is not
    finite (torch.linalg.cholesky_ex reports a failure instead of raising,
    so the solve never waits on the device).
"""

from __future__ import annotations

import torch


def spd_solve(H, b, damping=0.0, refine: bool = True):
    """Solve (H + damping*diag(H)) dx = b for SPD H [..., n, n], b [..., n].

    `damping` is RELATIVE (Marquardt-style), a float or a tensor that
    broadcasts against the batch. Non-finite results become zeros."""
    dtype = H.dtype
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    # non-positive / non-finite diagonals mark dead variables: scale by 1
    # here, zero their dx below
    good = (d > 0) & torch.isfinite(d)
    s = torch.where(good, torch.rsqrt(torch.where(good, d, 1.0)), 1.0)
    Hs = H * s[..., :, None] * s[..., None, :]
    n = H.shape[-1]
    eye = torch.eye(n, dtype=dtype, device=H.device)
    base = 1e-7 if dtype in (torch.float32, torch.bfloat16, torch.float16) else 1e-13
    damp = torch.as_tensor(damping, dtype=dtype, device=H.device)
    Hs = Hs + (damp[..., None, None] + base) * eye
    bs = (b * s)[..., None]
    L, info = torch.linalg.cholesky_ex(Hs)
    y = torch.cholesky_solve(bs, L)
    if refine:
        y = y + torch.cholesky_solve(bs - Hs @ y, L)
    dx = y[..., 0] * s * good.to(dtype)
    ok = torch.isfinite(dx).all(dim=-1, keepdim=True) & (info == 0)[..., None]
    return torch.where(ok, torch.where(torch.isfinite(dx), dx, 0.0), 0.0)
