"""Motion-only pose LM in one kernel launch
(port of tpuslam/solve/pose_opt_pallas.py; ref: src/Optimizer.cc:854-1168).

`pose_optimize_fused` launches the CUDA kernel of csrc/pose_opt.cu on CUDA
tensors and runs `pose_optimize_plain` on CPU tensors. Both compute what
the Pallas kernel computes: 4 rounds x <= 10 LM steps, Huber weights in
every round but the last, a Jacobi-scaled damped 6x6 Cholesky with the
kernel's 1e-30/1e-7/1e-20 guards and no iterative refinement, the 1e-6
depth guard, acceptance on the sum of per-observation cost deltas, and
chi2 re-classification between rounds. Both follow the CUDA kernel's
schedule: one evaluation per LM step, at the trial pose, with the cost
terms, H and g at the current pose kept from the evaluation that produced
it (the arithmetic of the Pallas kernel, which evaluates at both poses;
only the order of the sums differs). The plain version's early exit is a
mask over a fixed number of steps, so it never waits on the device.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.robust import CHI2_MONO, CHI2_STEREO

MAX_OBS = 5000  # 10 f32 planes of N observations in shared memory (<= 227 KB)


counter = _build.LaunchCounter()


def _residuals(P, X, uvr, smask, info, fx, fy, cx, cy, bf):
    """P [12] = row-major R | t. Returns per-observation terms."""
    x = P[0] * X[:, 0] + P[1] * X[:, 1] + P[2] * X[:, 2] + P[9]
    y = P[3] * X[:, 0] + P[4] * X[:, 1] + P[5] * X[:, 2] + P[10]
    z = P[6] * X[:, 0] + P[7] * X[:, 1] + P[8] * X[:, 2] + P[11]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    ru = u - uvr[:, 0]
    rv = v - uvr[:, 1]
    rur = (ur - uvr[:, 2]) * smask
    chi2 = (ru * ru + rv * rv + rur * rur) * info
    return x, y, z, iz, iz2, ru, rv, rur, chi2


def _chol6_solve(H, b, damping):
    """Jacobi-scaled, damped 6x6 Cholesky solve (the guards of the Pallas
    kernel's _chol6_solve)."""
    sc = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
    H = H * sc[:, None] * sc[None, :]
    b = b * sc
    A = H + torch.diag((damping + 1e-7).expand(6))
    L = torch.zeros_like(H)
    for j in range(6):
        s = A[j, j] - (L[j, :j] * L[j, :j]).sum()
        L[j, j] = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j + 1:, j] = (A[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
    y = torch.zeros_like(b)
    for i in range(6):
        y[i] = (b[i] - (L[i, :i] * y[:i]).sum()) / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(6)):
        x[i] = (y[i] - (L[i + 1:, i] * x[i + 1:]).sum()) / L[i, i]
    return x * sc


def _se3_exp(dx):
    """se(3) (rho, phi) -> (R [3,3], t [3]); small-angle series below 1e-8."""
    rho, phi = dx[:3], dx[3:]
    t2 = (phi * phi).sum()
    small = t2 < 1e-8
    safe_t2 = torch.where(small, 1.0, t2)
    th = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    bb = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / safe_t2)
    cc = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (th - torch.sin(th)) / (safe_t2 * th))
    z = torch.zeros_like(t2)
    W = torch.stack([torch.stack([z, -phi[2], phi[1]]),
                     torch.stack([phi[2], z, -phi[0]]),
                     torch.stack([-phi[1], phi[0], z])])
    W2 = W @ W
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    R = eye + a * W + bb * W2
    V = eye + bb * W + cc * W2
    return R, V @ rho


def pose_optimize_plain(R0, t0, X, uvr, inv_sigma2, is_stereo, valid,
                        fx, fy, cx, cy, bf, n_rounds: int = 4, n_iters: int = 10,
                        damping: float = 1e-4, step_tol: float = 1e-16, *, rounds=None):
    """Plain PyTorch version of the fused pose LM, on the kernel's
    schedule: each round starts with one evaluation at P (after the chi2
    re-classification, in rounds after the first); each step evaluates the
    cost terms, H and g once, at the trial pose Pn, and keeps those at P
    for the accept test and for a rejected step. Returns (R [3,3], t [3],
    inliers [N] bool, chi2 [N]).

    rounds: a list to which each round appends the work a measurement
    counts (reading it waits for the device): {"steps": its LM steps,
    "mono": and "stereo": its observations in use}."""
    f32 = torch.float32
    dev = X.device
    X = X.to(f32)
    uvr = uvr.to(f32)
    info = inv_sigma2.to(f32)
    smask = is_stereo.to(f32)
    vmask = valid.to(f32)
    chi2_th = torch.where(smask > 0.5, CHI2_STEREO, CHI2_MONO).to(f32)
    cam = (fx, fy, cx, cy, bf)

    def res(P):
        return _residuals(P, X, uvr, smask, info, *cam)

    def evaluate(r, use, robust):
        """Cost terms [N], H [6,6] and g [6] from the residual terms r."""
        x, y, z, iz, iz2, ru, rv, rur, chi2 = r
        c = chi2
        if robust:
            e = torch.sqrt(torch.clamp(chi2, min=0.0))
            c = torch.where(chi2 <= chi2_th, chi2, 2.0 * torch.sqrt(chi2_th) * e - chi2_th)
        c = torch.where((z > 0) & (use > 0.5), c, 0.0)
        w = torch.ones_like(chi2)
        if robust:
            w = torch.clamp(torch.sqrt(chi2_th) / torch.sqrt(torch.clamp(chi2, min=1e-12)),
                            max=1.0)
        w = torch.where(z > 0, w * info * use, 0.0)
        zero = torch.zeros_like(iz)
        du = (fx * iz, zero, -fx * x * iz2)
        dv = (zero, fy * iz, -fy * y * iz2)
        dur = (du[0], du[1], du[2] + bf * iz2)

        def pose_row(d):  # J = Jproj @ [I | -hat(Xc)]
            return torch.stack([d[0], d[1], d[2], d[1] * (-z) + d[2] * y,
                                d[0] * z + d[2] * (-x), d[0] * (-y) + d[1] * x], dim=1)

        Ju, Jv, Jur = pose_row(du), pose_row(dv), pose_row(dur)
        ws = w * smask
        H = ((w[:, None] * Ju).T @ Ju + (w[:, None] * Jv).T @ Jv
             + (ws[:, None] * Jur).T @ Jur)
        g = -((w * ru)[:, None] * Ju + (w * rv)[:, None] * Jv
              + (ws * rur)[:, None] * Jur).sum(dim=0)
        return c, H, g

    def trial(P, H, g, lam):
        dx = _chol6_solve(H, g, lam)
        dR, dt = _se3_exp(dx)
        Rn = dR @ P[:9].reshape(3, 3)
        tn = dR @ P[9:] + dt
        return torch.cat([Rn.reshape(9), tn]), (dx * dx).sum()

    P = torch.cat([R0.reshape(9), t0.reshape(3)]).to(f32)
    use = vmask
    inf = torch.full((), float("inf"), dtype=f32, device=dev)
    for rnd in range(n_rounds):
        robust = rnd < n_rounds - 1
        r = res(P)
        if rnd > 0:  # chi2 re-classification at the round's start pose
            use = vmask * ((r[8] <= chi2_th) & (r[2] > 0)).to(f32)
        c, H, g = evaluate(r, use, robust)
        lam = torch.full((), damping, dtype=f32, device=dev)
        sq = inf
        active = torch.ones((), dtype=torch.bool, device=dev)
        n_active = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_iters):
            active = active & (sq > step_tol)
            n_active = n_active + active
            Pn, sq_step = trial(P, H, g, lam)
            cn, Hn, gn = evaluate(res(Pn), use, robust)
            accept = (cn - c).sum() < 0
            take = active & accept
            P = torch.where(take, Pn, P)
            H = torch.where(take, Hn, H)
            g = torch.where(take, gn, g)
            c = torch.where(take, cn, c)
            lam_next = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-7, 1e2)
            lam = torch.where(active, lam_next, lam)
            sq = torch.where(active, torch.where(accept, sq_step, inf), sq)
        if rounds is not None:
            rounds.append({"steps": int(n_active), "mono": int((use * (1.0 - smask)).sum()),
                           "stereo": int((use * smask).sum())})
    _, _, z, _, _, _, _, _, chi2 = res(P)
    inliers = valid & (chi2 <= chi2_th) & (z > 0)
    return P[:9].reshape(3, 3), P[9:], inliers, chi2


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch(R0, t0, X, uvr, inv_sigma2, is_stereo, valid, fx, fy, cx, cy, bf,
            n_rounds, n_iters, damping, step_tol):
    dev = X.device
    n = X.shape[0]
    if n > MAX_OBS:
        raise ValueError(f"at most {MAX_OBS} observations, got {n}")
    f32 = torch.float32
    _check("X", X, f32, (n, 3), dev)
    _check("uvr", uvr, f32, (n, 3), dev)
    _check("inv_sigma2", inv_sigma2, f32, (n,), dev)
    _check("is_stereo", is_stereo, torch.bool, (n,), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    _check("R0", R0, f32, (3, 3), dev)
    _check("t0", t0, f32, (3,), dev)
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty((3,), dtype=f32, device=dev)
    inl = torch.empty((n,), dtype=torch.bool, device=dev)
    chi2 = torch.empty((n,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().pose_lm(
        X.data_ptr(), uvr.data_ptr(), inv_sigma2.data_ptr(), is_stereo.data_ptr(),
        valid.data_ptr(), n, R0.data_ptr(), t0.data_ptr(), float(fx), float(fy),
        float(cx), float(cy), float(bf), float(damping), float(step_tol),
        int(n_rounds), int(n_iters), R.data_ptr(), t.data_ptr(), inl.data_ptr(),
        chi2.data_ptr(), stream)
    _build.check(err, "pose_lm")
    counter.launches += 1
    return R, t, inl, chi2


def pose_optimize_fused(R0, t0, X, uvr, inv_sigma2, is_stereo, valid,
                        fx, fy, cx, cy, bf, n_rounds: int = 4, n_iters: int = 10,
                        damping: float = 1e-4, step_tol: float = 1e-16):
    """Motion-only pose LM. Returns (R [3,3], t [3], inliers [N] bool,
    chi2 [N]) like tpuslam's pose_optimize_fused.

    CUDA tensors: the hand-written kernel (or an error). CPU tensors: the
    plain version."""
    args = (R0, t0, X, uvr, inv_sigma2, is_stereo, valid, fx, fy, cx, cy, bf,
            n_rounds, n_iters, damping, step_tol)
    if X.device.type == "cpu":
        return pose_optimize_plain(*args)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    return _launch(*args)
