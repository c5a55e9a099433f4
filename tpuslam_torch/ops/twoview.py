"""Two-view reconstruction for monocular initialization (port of
tpuslam/ops/twoview.py; ref: src/TwoViewReconstruction.cc, invoked through
GeometricCamera::ReconstructWithTwoViews at Tracking.cc:1522).

Parallel homography and fundamental RANSAC (200 hypotheses x 8-point DLT)
as one batched pipeline (batched torch.linalg.svd), model selection by the
score ratio RH > 0.4, the motion hypotheses (4 from E, 8 from H by
Faugeras' SVD method), cheirality + parallax checks and triangulation of
the winner. Points are normalized camera rays (z = 1).

The sample draw is explicit: `reconstruct_two_views` takes the [200, 8]
sample indices, or draws them with `draw_samples` from a torch.Generator.
The SVD null vector's sign is free, so H, F and E agree with tpuslam's
only up to sign; what callers consume (the chosen R21, t21, X, good,
success, used_h) does not depend on it.
"""

from __future__ import annotations

import torch

from ..core.linalg import inv, spd_solve, svd

N_HYP = 200  # ref: TwoViewReconstruction ctor mMaxIterations=200
SIGMA = 1.0


def draw_samples(valid, generator=None, n_hyp: int = N_HYP):
    """[n_hyp, 8] match indices drawn with replacement, uniformly over the
    valid matches (jax.random.choice with p = valid / sum(valid) in
    tpuslam). Drawn on the host from `generator` (seed 0 when None, as
    tpuslam's PRNGKey(0) per attempt)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p = torch.as_tensor(valid).cpu().to(torch.float64)
    idx = torch.multinomial(p, n_hyp * 8, replacement=True, generator=generator)
    return idx.reshape(n_hyp, 8)


def _dlt_h(x1, x2, w=None):
    """Batched homography DLT. x1, x2 [B,n,2] -> H [B,3,3]; optional row
    weights w [B,n] (0 disables a correspondence)."""
    B = x1.shape[0]
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u)
    o = torch.ones_like(u)
    r1 = torch.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1)
    r2 = torch.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)
    A = torch.cat([r1, r2], dim=1)  # [B,2n,9]
    if w is not None:
        A = A * torch.cat([w, w], dim=1)[..., None]
    _, _, Vt = svd(A, full_matrices=True)
    return Vt[..., -1, :].reshape(B, 3, 3)


def _dlt_f(x1, x2, w=None):
    """Batched 8-point fundamental, rank 2. x1, x2 [B,n,2] -> F [B,3,3]."""
    B = x1.shape[0]
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], -1)
    if w is not None:
        A = A * w[..., None]
    _, _, Vt = svd(A, full_matrices=True)
    F = Vt[..., -1, :].reshape(B, 3, 3)
    U, S, Vt2 = svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., :, None] * Vt2)


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _score_h(H, x1, x2, sigma2, valid):
    """Symmetric transfer error score (ref CheckHomography). x [N,2]."""
    def transfer(H, a, b):
        p = _hom(a) @ H.transpose(-1, -2)
        w = torch.where(torch.abs(p[..., 2:3]) < 1e-9, 1e-9, p[..., 2:3])
        return ((p[..., :2] / w - b) ** 2).sum(-1)

    Hinv = inv(H)
    d12 = transfer(H, x1[None], x2[None]) / sigma2
    d21 = transfer(Hinv, x2[None], x1[None]) / sigma2
    th = 5.991
    good = (d12 < th) & (d21 < th) & valid[None]
    score = torch.where(d12 < th, th - d12, 0.0) + torch.where(d21 < th, th - d21, 0.0)
    return (score * valid[None]).sum(-1), good


def _score_f(F, x1, x2, sigma2, valid):
    """Epipolar distance score (ref CheckFundamental)."""
    x1h, x2h = _hom(x1), _hom(x2)
    l2 = x1h[None] @ F.transpose(-1, -2)   # lines in image 2 [B,N,3]
    num2 = (l2 * x2h[None]).sum(-1) ** 2
    d2 = num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    l1 = x2h[None] @ F
    num1 = (l1 * x1h[None]).sum(-1) ** 2
    d1 = num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    th, thscore = 3.841, 5.991
    good = (d1 < th) & (d2 < th) & valid[None]
    score = torch.where(d1 < th, thscore - d1, 0.0) + torch.where(d2 < th, thscore - d2, 0.0)
    return (score * valid[None]).sum(-1), good


def triangulate_batch(R1, t1, R2, t2, x1, x2, n_refine: int = 2):
    """Linear (DLT) triangulation of ray pairs + batched GN refinement
    (ref TwoViewReconstruction::Triangulate). Poses map world -> cam;
    x1, x2 [N,2] normalized coords. Returns X [N,3] world. The two GN steps
    on the normalized reprojection residuals restore f64-grade depths in
    f32, where near-parallel rays make the DLT SVD ill-conditioned."""
    P1 = torch.cat([R1, t1[:, None]], dim=1)  # [3,4]
    P2 = torch.cat([R2, t2[:, None]], dim=1)
    rows = []
    for x, P in ((x1, P1), (x2, P2)):
        rows.append(x[..., 0:1] * P[2][None] - P[0][None])
        rows.append(x[..., 1:2] * P[2][None] - P[1][None])
    A = torch.stack(rows, dim=-2)  # [N,4,4]
    _, _, Vt = svd(A)
    Xh = Vt[..., -1, :]
    w = torch.where(torch.abs(Xh[..., 3:]) < 1e-12, 1e-12, Xh[..., 3:])
    X = Xh[..., :3] / w

    for _ in range(n_refine):
        rs, Js = [], []
        for R, t, x in ((R1, t1, x1), (R2, t2, x2)):
            Xc = X @ R.T + t
            z = torch.where(torch.abs(Xc[..., 2:]) < 1e-9, 1e-9, Xc[..., 2:])
            rs.append(Xc[..., :2] / z - x)
            iz = 1.0 / z[..., 0]
            zero = torch.zeros_like(iz)
            Jc = torch.stack([
                torch.stack([iz, zero, -Xc[..., 0] * iz * iz], -1),
                torch.stack([zero, iz, -Xc[..., 1] * iz * iz], -1),
            ], -2)                                    # [N,2,3]
            Js.append(Jc @ R)
        r, J = torch.cat(rs, -1), torch.cat(Js, -2)   # [N,4], [N,4,3]
        H = torch.einsum("nij,nik->njk", J, J)
        b = -torch.einsum("nij,ni->nj", J, r)
        X = X + spd_solve(H, b, damping=1e-6)
    return X


def _check_rt(R, t, x1, x2, good, sigma2):
    """Cheirality check of one (R, t) hypothesis (ref CheckRT). Returns
    (n_good, parallax of the 50th-best ray pair in degrees, X [N,3], ok)."""
    dt = x1.dtype
    eye = torch.eye(3, dtype=dt, device=x1.device)
    X = triangulate_batch(eye, torch.zeros(3, dtype=dt, device=x1.device), R, t, x1, x2)
    finite = torch.isfinite(X).all(-1)
    O2 = -R.T @ t
    n2 = X - O2[None]
    cosp = (X * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    z1 = X[:, 2]
    Xc2 = X @ R.T + t
    z2 = Xc2[:, 2]
    p1 = X[:, :2] / torch.where(torch.abs(z1[:, None]) < 1e-9, 1e-9, z1[:, None])
    p2 = Xc2[:, :2] / torch.where(torch.abs(z2[:, None]) < 1e-9, 1e-9, z2[:, None])
    e1 = ((p1 - x1) ** 2).sum(-1)
    e2 = ((p2 - x2) ** 2).sum(-1)
    th = 4.0 * sigma2
    ok = good & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th) & (e2 < th)
    n_good = ok.sum()
    cs = torch.sort(torch.where(ok, cosp, 1.0)).values
    idx = torch.clamp(n_good - 1, min=0, max=49)
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cs[idx], -1.0, 1.0)))
    return n_good, parallax, X, ok


def _decompose_e(E):
    """E -> 4 (R, t) hypotheses (ref DecomposeE)."""
    U, _, Vt = svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, 2]
    tu = tu / torch.clamp(torch.linalg.norm(tu), min=1e-12)
    return [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]


def _decompose_h(H):
    """H -> 8 (R, t) hypotheses, Faugeras' SVD method (ref ReconstructH)."""
    U, S, Vt = svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    d1, d3 = d1 / d2, d3 / d2
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - 1.0) * (1.0 - d3 * d3), min=0.0))
    x1a = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / (d1 * d1 - d3 * d3), min=0.0))
    x3a = torch.sqrt(torch.clamp((1.0 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    zero = 0.0 * d1
    hyps = []

    def hyp(Rp, tp):
        t = U @ tp
        hyps.append((s * U @ Rp @ Vt, t / torch.clamp(torch.linalg.norm(t), min=1e-12)))

    # d' > 0
    sin_t = aux1 / (d1 + d3)
    cos_t = (d1 * d3 + 1.0) / (d1 + d3)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -st]),
                              torch.stack([zero, zero + 1.0, zero]),
                              torch.stack([st, zero, cos_t])])
            hyp(Rp, torch.stack([e1 * x1a, zero, -e3 * x3a]) * (d1 - d3))
    # d' < 0
    sin_p = aux1 / (d1 - d3)
    cos_p = (d1 * d3 - 1.0) / (d1 - d3)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            sp = e1 * e3 * sin_p
            Rp = torch.stack([torch.stack([cos_p, zero, sp]),
                              torch.stack([zero, zero - 1.0, zero]),
                              torch.stack([sp, zero, -cos_p])])
            hyp(Rp, torch.stack([e1 * x1a, zero, e3 * x3a]) * (d1 + d3))
    return hyps


def reconstruct_two_views(x1, x2, valid, idx=None, generator=None):
    """Mono-init reconstruction on normalized coords.

    x1, x2 [N,2] matched normalized (z = 1) coords; valid [N] bool; idx
    [200, 8] sample indices (drawn by `draw_samples(valid, generator)` when
    None). Returns dict: success, R21, t21 (cam1 -> cam2), X [N,3] (cam1
    frame), good [N] triangulated-inlier mask, used_h, n_good (tensors on
    x1's device)."""
    dtype, dev = x1.dtype, x1.device
    sigma2 = (SIGMA / 400.0) ** 2  # px sigma on the normalized plane
    if idx is None:
        idx = draw_samples(valid, generator)
    idx = torch.as_tensor(idx, device=dev).long()
    s1, s2 = x1[idx], x2[idx]

    # fit + score both models, batched over the hypotheses
    Hs = _dlt_h(s1, s2)
    Fs = _dlt_f(s1, s2)
    score_h, good_h = _score_h(Hs, x1, x2, sigma2, valid)
    score_f, good_f = _score_f(Fs, x1, x2, sigma2, valid)
    score_h = torch.where(torch.isfinite(Hs.reshape(N_HYP, -1)).all(-1), score_h, -1.0)
    score_f = torch.where(torch.isfinite(Fs.reshape(N_HYP, -1)).all(-1), score_f, -1.0)
    bi_h = torch.argmax(score_h)
    bi_f = torch.argmax(score_f)
    good_h_best = good_h[bi_h] & valid
    good_f_best = good_f[bi_f] & valid
    # least-squares refit on the best hypothesis' inliers, twice
    for _ in range(2):
        H = _dlt_h(x1[None], x2[None], good_h_best[None].to(dtype))[0]
        F = _dlt_f(x1[None], x2[None], good_f_best[None].to(dtype))[0]
        sh, gh = _score_h(H[None], x1, x2, sigma2, valid)
        sf, gf = _score_f(F[None], x1, x2, sigma2, valid)
        good_h_best, good_f_best = gh[0], gf[0]
    SH, SF = sh[0], sf[0]
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40  # ref Reconstruct 'if(RH>0.40)'

    # decompose both, evaluate every candidate (R, t) with cheirality;
    # normalized coords, so F is E
    cands = _decompose_e(F) + _decompose_h(H)  # 4 + 8
    which_good = [good_f_best] * 4 + [good_h_best] * 8
    checks = [_check_rt(R, t, x1, x2, g, sigma2) for (R, t), g in zip(cands, which_good)]
    ns = torch.stack([c[0] for c in checks])
    pars = torch.stack([c[1] for c in checks])
    # select among the active model's hypotheses only
    model_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)]).to(ns.dtype)
    ns_m = ns * model_mask
    best = torch.argmax(ns_m)
    n_best = ns_m[best]
    n_inliers = torch.where(use_h, good_h_best.sum(), good_f_best.sum())
    second = torch.sort(ns_m).values[-2]
    # acceptance (ref ReconstructF: nGood > 0.9 nInliers, a clear winner,
    # minParallax = 1 deg, TwoViewReconstruction.cc:114)
    success = ((n_best > 30)
               & (n_best.to(dtype) > 0.75 * n_inliers.to(dtype))
               & (second.to(dtype) < 0.75 * n_best.to(dtype))
               & (pars[best] > 1.0))
    return dict(
        success=success,
        R21=torch.stack([c[0] for c in cands])[best],
        t21=torch.stack([c[1] for c in cands])[best],
        X=torch.stack([c[2] for c in checks])[best],
        good=torch.stack([c[3] for c in checks])[best],
        used_h=use_h,
        n_good=n_best,
    )
