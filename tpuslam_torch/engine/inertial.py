"""Inertial engine glue: sample windows, preintegration, IMU initialization
and the inertial local / full BA drivers (port of tpuslam/engine/inertial.py).

The reference's IMU plumbing spread across Tracking (GrabImuData /
PreintegrateIMU src/Tracking.cc:546-667, PredictStateIMU :669) and
LocalMapping (InitializeIMU :1213-1394, the VIBA1 / VIBA2 schedule
:180-205, LocalInertialBA :149). The map is host state (numpy); the
preintegrations, the init solve and the VI BA run on the given device.
Precision follows tpuslam's casts: windows preintegrate in f32, their
information and the init solve in f64, the VI BA in the caller's dtype.
tpuslam pads samples, keyframes, edges and points to shape buckets so
compiled programs are reused; eager PyTorch runs the real sizes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.lie import so3_exp
from ..imu.init import inertial_init_solve, linear_sgv_seed
from ..imu.preintegration import (PRE_KEYS, ImuCalib, information_from_cov, pre_stack,
                                  preintegrate)
from ..parallel import dist_ba
from ..solve import ba as B
from ..solve.inertial_ba import vi_ba_solve
from ..utils import DEFAULT_DEVICE, resolve_device
from ..utils.verbose import print_mess

# full / window inertial BA routes through the obs-sharded distributed
# solver (parallel/dist_ba.py) when a group of more than one rank is up and
# the visual part has at least this many observations
DIST_VIBA_MIN_OBS = 20_000


def _no_lock():
    return contextlib.nullcontext()


def _to_numpy(pre):
    """A preintegration's tensors as host numpy, in one device copy."""
    flat = torch.cat([pre[k].reshape(-1) for k in PRE_KEYS]).cpu().numpy()
    out, i = {}, 0
    for k in PRE_KEYS:
        shape = tuple(pre[k].shape)
        n = int(np.prod(shape)) if shape else 1
        out[k] = flat[i:i + n].reshape(shape)
        i += n
    return out


def _preintegrate_np(w, a, dt, bg, ba, calib: ImuCalib, device):
    """preintegrate in f32 (tpuslam's cast) on `device`; numpy out."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    ng2, na2, wg2, wa2 = calib.discrete_cov()
    return _to_numpy(preintegrate(f32(np.reshape(w, (-1, 3))), f32(np.reshape(a, (-1, 3))),
                                  f32(dt), f32(bg), f32(ba), ng2, na2, wg2, wa2))


def preintegrate_window(samples, t0: float, t1: float, bg, ba, calib: ImuCalib,
                        device=DEFAULT_DEVICE):
    """Preintegrate samples ([t, wx..wz, ax..az] rows) covering (t0, t1]; the
    last sample stretches to t1 (ref Tracking.cc:612 boundary handling).
    Returns (pre as numpy, (w, a, dt) raw f64 arrays)."""
    device = resolve_device(device)
    s = np.asarray(samples, np.float64).reshape(-1, 7)
    s = s[(s[:, 0] > t0) & (s[:, 0] <= t1 + 1e-12)]
    if len(s) == 0:
        w, a, dt = np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
    else:
        w, a, ts = s[:, 1:4], s[:, 4:7], s[:, 0]
        dt = np.diff(np.concatenate([[t0], ts]))
        tail = t1 - ts[-1]
        if tail > 1e-9:
            w = np.concatenate([w, w[-1:]])
            a = np.concatenate([a, a[-1:]])
            dt = np.concatenate([dt, [tail]])
    return _preintegrate_np(w, a, dt, bg, ba, calib, device), (w, a, dt)


def reintegrate_kf(m, kf: int, calib: ImuCalib, device=DEFAULT_DEVICE):
    """Re-run the stored raw window's preintegration at the KF's current bias
    estimate (ref Preintegrated::Reintegrate ImuTypes.cc:246)."""
    raw = m.kf_imu[kf]
    if raw is None:
        return
    prev = int(m.kf_prev[kf])
    bg = m.kf_bg[prev] if prev >= 0 else m.kf_bg[kf]
    ba = m.kf_ba[prev] if prev >= 0 else m.kf_ba[kf]
    m.kf_preint[kf] = _preintegrate_np(*raw, bg, ba, calib, resolve_device(device))
    m.kf_bg0[kf] = bg
    m.kf_ba0[kf] = ba


def _info9(C9s, device):
    """f64 information of stacked 9x9 covariances (tpuslam's cast), numpy."""
    C = torch.as_tensor(np.stack(C9s).astype(np.float64), device=device)
    return information_from_cov(C).cpu().numpy()


def chain_edges(m, chain, calib: ImuCalib, device=DEFAULT_DEVICE):
    """Edges (a, b, pre, info9, rw_g, rw_a, bg0, ba0) between consecutive
    chain KFs that have a stored preintegration."""
    device = resolve_device(device)
    edges = []
    _, _, wg2, wa2 = calib.discrete_cov()
    for a, b in zip(chain[:-1], chain[1:]):
        pre = m.kf_preint[b]
        if pre is None and m.kf_imu[b] is not None:
            reintegrate_kf(m, b, calib, device)   # rebuilt after chain splicing
            pre = m.kf_preint[b]
        if pre is None:
            continue
        dT = max(float(pre["dT"]), 1e-6)
        edges.append(dict(a=a, b=b, pre=pre, rw_g=1.0 / (wg2 * dT), rw_a=1.0 / (wa2 * dT),
                          bg0=m.kf_bg0[b].copy(), ba0=m.kf_ba0[b].copy()))
    if edges:
        infos = _info9([e["pre"]["C"][:9, :9] for e in edges], device)
        for e, inf in zip(edges, infos):
            e["info9"] = inf
    return edges


def _rwg_from_dir(dirG):
    """Rotation taking (0, 0, -1) onto the direction dirG (identity when
    undefined)."""
    nG = np.linalg.norm(dirG)
    if nG <= 1e-9:
        return np.eye(3)
    dirG = dirG / nG
    gI = np.array([0.0, 0.0, -1.0])
    vcr = np.cross(gI, dirG)
    nv = np.linalg.norm(vcr)
    if nv <= 1e-9:
        return np.eye(3)
    ang = float(np.arccos(np.clip(gI @ dirG, -1.0, 1.0)))
    return so3_exp(torch.as_tensor(vcr / nv * ang, dtype=torch.float64)).numpy()


def run_imu_init(m, calib: ImuCalib, mono: bool = True, prior_g: float = 1e2,
                 prior_a: float = 1e10, opt_bias: bool = True, vis_rot_sigma: float = 2e-3,
                 vis_pos_sigma: float = 5e-3, max_logs_sigma: float = 0.25,
                 device=DEFAULT_DEVICE):
    """ref LocalMapping::InitializeIMU (:1213): inertial-only optimization
    with the poses fixed, then gravity-align and rescale the map. With
    opt_bias=False this is the periodic ScaleRefinement (ref :1396): the
    biases stay at the preintegrations' integration values, only scale,
    gravity and velocities move. Returns True on success."""
    device = resolve_device(device)
    chain = m.temporal_chain()
    if not opt_bias:
        # refinement treats the preintegration's bias as the truth: make it
        # the CURRENT estimate first
        for k in chain:
            prev = int(m.kf_prev[k])
            if prev < 0 or m.kf_imu[k] is None:
                continue
            if (np.linalg.norm(m.kf_bg[prev] - m.kf_bg0[k]) > 1e-4
                    or np.linalg.norm(m.kf_ba[prev] - m.kf_ba0[k]) > 1e-3):
                reintegrate_kf(m, k, calib, device)
    edges = chain_edges(m, chain, calib, device)
    if len(edges) < 2:
        return False
    idx = {k: i for i, k in enumerate(chain)}
    K = len(chain)
    bodies = [calib.body_from_cam(m.kf_R[k], m.kf_t[k]) for k in chain]
    Rwb = np.stack([b[0] for b in bodies])
    p = np.stack([b[1] for b in bodies])
    ia = [idx[e["a"]] for e in edges]
    ib = [idx[e["b"]] for e in edges]
    # POSES-FIXED solve: inflate each edge covariance with the visual pose
    # noise the fixed poses carry (the er residual sees two visual
    # rotations, ep two visual positions)
    infl = np.diag([2 * vis_rot_sigma ** 2] * 3 + [0.0] * 3 + [2 * vis_pos_sigma ** 2] * 3)
    info9 = _info9([e["pre"]["C"][:9, :9].astype(np.float64) + infl for e in edges], device)
    # seeds: the closed-form linear (s, g, w) solve, else the reference's
    # finite-difference velocities + preintegrated-dV gravity direction
    log_s0 = 0.0
    seeded = False
    if not m.imu_initialized and mono:
        try:
            s_lin, g_lin, w_lin = linear_sgv_seed(Rwb, p, ia, ib, [e["pre"] for e in edges])
        except np.linalg.LinAlgError:
            s_lin = -1.0
        if (np.isfinite(s_lin) and 1e-3 < s_lin < 1e3 and np.isfinite(g_lin).all()
                and np.isfinite(w_lin).all()):
            v0 = w_lin / s_lin
            Rwg0 = _rwg_from_dir(g_lin)
            log_s0 = float(np.log(s_lin))
            seeded = True
    if not seeded:
        if m.imu_initialized:
            v0 = np.stack([m.kf_vel[k] for k in chain]).astype(np.float64)
        else:
            v0 = np.zeros((K, 3))
            for e in edges:
                dv = (p[idx[e["b"]]] - p[idx[e["a"]]]) / max(float(e["pre"]["dT"]), 1e-6)
                v0[idx[e["b"]]] = dv
                if idx[e["a"]] == 0:
                    v0[0] = dv
        dirG = np.zeros(3)
        for e in edges:
            dirG -= Rwb[idx[e["a"]]] @ np.asarray(e["pre"]["dV"], np.float64)
        Rwg0 = _rwg_from_dir(dirG)
    if not opt_bias:
        prior_g = prior_a = 1e14   # pin the bias deltas at zero

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    # 120 LM steps: the scale / gravity valley takes ~100 steps to walk
    out = inertial_init_solve(
        f64(Rwb), f64(p), f64(v0), torch.as_tensor(ia, device=device),
        torch.as_tensor(ib, device=device),
        pre_stack([e["pre"] for e in edges], device, torch.float64), f64(info9),
        prior_g=prior_g, prior_a=prior_a, n_iters=120, mono_scale=mono, Rwg0=f64(Rwg0),
        log_s0=log_s0)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    s = float(out["scale"])
    if not np.isfinite(s) or s > 1e2:
        return False
    if s < 1e-1:
        # degenerate metric scale (ref LocalMapping.cc:1314; ScaleRefinement
        # :1404 sets mbBadImu): flag the active map for a reset
        m.bad_imu = True
        return False
    if mono and opt_bias and not m.imu_initialized:
        if float(out["logs_sigma"]) > max_logs_sigma:
            # scale unidentifiable from this window: defer, more KFs come
            print_mess(f"[imu_init] deferred: log-scale sigma "
                       f"{float(out['logs_sigma']):.3f} > {max_logs_sigma}")
            return False
        # velocity-consistency gate: the solved visual-frame velocities
        # must track the visual position finite differences (a wrong global
        # scale can be absorbed by distorting the velocity chain)
        v_vis = out["v"] / max(s, 1e-9)
        devs = []
        for e in edges:
            fd = (p[idx[e["b"]]] - p[idx[e["a"]]]) / max(float(e["pre"]["dT"]), 1e-6)
            nfd = np.linalg.norm(fd)
            if nfd > 1e-6:
                devs.append(np.linalg.norm(v_vis[idx[e["a"]]] - fd) / nfd)
        if devs and float(np.median(devs)) > 0.5:
            print_mess(f"[imu_init] deferred: velocity/finite-difference deviation "
                       f"{np.median(devs):.2f} > 0.5 (s={s:.2f})")
            return False
    vel = np.zeros((m.n_kf, 3))
    for i, k in enumerate(chain):
        vel[k] = out["v"][i]
    m.apply_scaled_rotation(out["Rwg"], s, velocities=vel)
    if opt_bias:
        m.kf_bg[: m.n_kf] = out["bg"]
        m.kf_ba[: m.n_kf] = out["ba"]
        # the windows were integrated at (near-)zero bias: reintegrate the
        # ones far from the new estimate
        for k in chain:
            if (np.linalg.norm(out["bg"] - m.kf_bg0[k]) > 0.01
                    or np.linalg.norm(out["ba"] - m.kf_ba0[k]) > 0.05):
                reintegrate_kf(m, k, calib, device)
    m.imu_initialized = True
    return True


def full_inertial_ba(m, camera, calib: ImuCalib, inv_sigma2, prior_g: float = 1e2,
                     prior_a: float = 1e10, n_iters: int = 40, fix_first: bool = True,
                     hold=_no_lock, device=DEFAULT_DEVICE, dtype=torch.float32):
    """ref Optimizer::FullInertialBA (:420) over the whole temporal chain."""
    device = resolve_device(device)
    chain = m.temporal_chain()
    if len(chain) < 3:
        return
    window_inertial_ba(m, camera, calib, inv_sigma2, opt_kfs=chain, fixed_kfs=[],
                       prior_g=prior_g, prior_a=prior_a, n_iters=n_iters, fix_first=fix_first,
                       hold=hold, device=device, dtype=dtype)


def local_inertial_ba(m, kf: int, camera, calib: ImuCalib, inv_sigma2, window: int = 10,
                      n_iters: int = 10, prior_g: float = 0.0, prior_a: float = 0.0,
                      hold=_no_lock, device=DEFAULT_DEVICE, dtype=torch.float32):
    """ref Optimizer::LocalInertialBA (:4574): the temporal window of the
    last `window` KFs; the predecessor enters fixed, covisible KFs seeing
    the window's points enter as the fixed visual frontier. The selection
    runs under the lock; window_inertial_ba stages the solve."""
    device = resolve_device(device)
    with hold():
        chain = m.temporal_chain()
        if kf not in chain:
            return
        pos = chain.index(kf)
        opt_kfs = chain[max(0, pos - window + 1): pos + 1]
        fixed_kfs = chain[max(0, pos - window): max(0, pos - window + 1)]
        if len(opt_kfs) < 2:
            return
        wset = set(opt_kfs) | set(fixed_kfs)
        pts = np.unique(m.kf_mp[opt_kfs])
        pts = pts[pts >= 0]
        pts = pts[m.mp_valid[pts]]
        frontier = set()
        for j in pts:
            for okf in m.mp_obs[int(j)]:
                if okf not in wset:
                    frontier.add(okf)
    window_inertial_ba(m, camera, calib, inv_sigma2, opt_kfs=opt_kfs,
                       fixed_kfs=fixed_kfs + sorted(frontier), n_iters=n_iters, prior_g=prior_g,
                       prior_a=prior_a, fix_first=(len(fixed_kfs) == 0), hold=hold,
                       device=device, dtype=dtype)


def window_inertial_ba(m, camera, calib: ImuCalib, inv_sigma2, opt_kfs, fixed_kfs,
                       prior_g: float = 0.0, prior_a: float = 0.0, n_iters: int = 10,
                       fix_first: bool = False, chi2_prune: float = 5.991, hold=_no_lock,
                       device=DEFAULT_DEVICE, dtype=torch.float32):
    """Shared assembly for full / local inertial BA: the visual observations
    of the window's points + the inertial chain edges among opt_kfs (and
    from a fixed temporal predecessor). Assembly and write-back run under
    the map lock (`hold`), the LM solve on the snapshot without it;
    write-back skips KFs and points culled meanwhile."""
    device = resolve_device(device)
    with hold():
        snap = _window_viba_assemble(m, camera, calib, inv_sigma2, opt_kfs, fixed_kfs,
                                     fix_first, device)
    if snap is None:
        return
    _window_viba_solve_writeback(m, camera, calib, snap, prior_g, prior_a, n_iters, chi2_prune,
                                 fix_first, hold, device, dtype)


def _window_viba_assemble(m, camera, calib, inv_sigma2, opt_kfs, fixed_kfs, fix_first,
                          device=DEFAULT_DEVICE):
    kf_list = list(opt_kfs) + list(fixed_kfs)
    idx = {k: i for i, k in enumerate(kf_list)}
    pts = np.unique(m.kf_mp[kf_list])
    pts = pts[pts >= 0]
    pts = pts[m.mp_valid[pts]]
    if len(pts) < 10:
        return None
    pt_index = {int(j): i for i, j in enumerate(pts)}
    obs_kf, obs_pt, uvr, inv_s2, obs_ref = [], [], [], [], []
    for j in pts:
        for okf, slot in m.mp_obs[int(j)].items():
            if okf not in idx:
                continue
            f = m.kf_feats[okf]
            obs_kf.append(idx[okf])
            obs_pt.append(pt_index[int(j)])
            uvr.append([f.und_xy[slot, 0], f.und_xy[slot, 1], 0.0])
            inv_s2.append(inv_sigma2[f.octave[slot]])
            obs_ref.append((int(j), okf))
    O = len(obs_kf)
    if O < 30:
        return None
    edges = chain_edges(m, list(opt_kfs), calib, device)
    # the edge from the fixed TEMPORAL predecessor into the window (the
    # preintegration stored at opt_kfs[0] spans kf_prev -> opt_kfs[0])
    pred = int(m.kf_prev[opt_kfs[0]]) if len(opt_kfs) else -1
    if pred >= 0 and pred in set(fixed_kfs):
        edges = chain_edges(m, [pred, opt_kfs[0]], calib, device) + edges
    if not edges:
        return None
    K, E = len(kf_list), len(edges)
    pair_a, pair_b = B.build_obs_pairs(np.array(obs_pt, np.int32), len(pts))
    Rwb = np.zeros((K, 3, 3))
    p, v, bg, ba = (np.zeros((K, 3)) for _ in range(4))
    for k, i in idx.items():
        Rwb[i], p[i] = calib.body_from_cam(m.kf_R[k], m.kf_t[k])
        v[i], bg[i], ba[i] = m.kf_vel[k], m.kf_bg[k], m.kf_ba[k]
    fixed = np.zeros(K, bool)
    fixed[len(opt_kfs):] = True
    if fix_first:
        fixed[0] = True
    bg0, ba0 = np.zeros((K, 3)), np.zeros((K, 3))
    for e in edges:
        bg0[idx[e["a"]]] = e["bg0"]
        ba0[idx[e["a"]]] = e["ba0"]
    return dict(
        idx=idx, opt_kfs=list(opt_kfs), pts=pts, obs_ref=obs_ref, O=O, Rwb=Rwb, p=p, v=v,
        bg=bg, ba=ba, X=m.mp_pos[pts].copy(), obs_kf_a=np.array(obs_kf, np.int64),
        obs_pt_a=np.array(obs_pt, np.int64), uvr_a=np.array(uvr, np.float64),
        inv_s2_a=np.array(inv_s2, np.float64),
        ea=np.array([idx[e["a"]] for e in edges], np.int64),
        eb=np.array([idx[e["b"]] for e in edges], np.int64), pres=[e["pre"] for e in edges],
        info9=np.stack([e["info9"] for e in edges]), bg0=bg0, ba0=ba0,
        rw_g=np.array([e["rw_g"] for e in edges]), rw_a=np.array([e["rw_a"] for e in edges]),
        fixed=fixed, pair_a_a=pair_a.astype(np.int64), pair_b_a=pair_b.astype(np.int64))


def solve_window_snapshot(snap, camera, calib, prior_g, prior_a, n_iters, device, dtype,
                          fixed=None):
    """vi_ba_solve on an assembled snapshot; returns numpy (Rwb, p, v, bg,
    ba, X, cost). `fixed` overrides the snapshot's fixed-pose mask. Large
    problems in a group of more than one rank take the distributed
    FullInertialBA (ref Optimizer.cc:420 is what GBA runs on inertial maps,
    LoopClosing.cc:2437-2440): the visual blocks shard over the ranks, the
    chain is replicated."""
    O = snap["O"]
    fixed = snap["fixed"] if fixed is None else fixed
    if dist_ba.route_open() and O >= DIST_VIBA_MIN_OBS:
        pres = {k: np.stack([np.asarray(pre[k], np.float64) for pre in snap["pres"]])
                for k in PRE_KEYS}
        return list(dist_ba.dispatch(
            "viba", snap["Rwb"], snap["p"], snap["v"], snap["bg"], snap["ba"], snap["X"],
            snap["obs_kf_a"], snap["obs_pt_a"], snap["uvr_a"], snap["inv_s2_a"],
            np.zeros(O, bool), np.ones(O, bool), snap["ea"], snap["eb"], pres, snap["info9"],
            snap["bg0"], snap["ba0"], snap["rw_g"], snap["rw_a"], fixed, camera.fx, camera.fy,
            camera.cx, camera.cy, 0.0, calib.Rcb, calib.tcb, prior_g=prior_g, prior_a=prior_a,
            n_iters=n_iters, cam=camera.spec, device=device, dtype=dtype))

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)

    def i(x):
        return torch.as_tensor(np.asarray(x), device=device)

    out = vi_ba_solve(
        f(snap["Rwb"]), f(snap["p"]), f(snap["v"]), f(snap["bg"]), f(snap["ba"]), f(snap["X"]),
        i(snap["obs_kf_a"]), i(snap["obs_pt_a"]), f(snap["uvr_a"]), f(snap["inv_s2_a"]),
        torch.zeros(O, dtype=torch.bool, device=device),
        torch.ones(O, dtype=torch.bool, device=device), i(snap["ea"]), i(snap["eb"]),
        pre_stack(snap["pres"], device, dtype), f(snap["info9"]), f(snap["bg0"]),
        f(snap["ba0"]), i(fixed), i(snap["pair_a_a"]),
        i(snap["pair_b_a"]), camera.fx, camera.fy, camera.cx, camera.cy, 0.0,
        f(snap["rw_g"]), f(snap["rw_a"]), f(calib.Rcb), f(calib.tcb), prior_g=prior_g,
        prior_a=prior_a, n_iters=n_iters, cam=camera.spec)
    return [x.cpu().numpy().astype(np.float64) for x in out]


def _window_viba_solve_writeback(m, camera, calib, snap, prior_g, prior_a, n_iters, chi2_prune,
                                 fix_first, hold, device=DEFAULT_DEVICE, dtype=torch.float32):
    idx, opt_kfs, pts, obs_ref, O = (snap["idx"], snap["opt_kfs"], snap["pts"], snap["obs_ref"],
                                     snap["O"])
    fixed = snap["fixed"]
    Rf, pf, vf, bgf, baf, Xf, cost = solve_window_snapshot(snap, camera, calib, prior_g, prior_a,
                                                           n_iters, device, dtype)
    if not np.isfinite(cost):
        return
    # chi2 of the visual observations at the solution (lock-free)
    K = len(Rf)
    cams = [calib.cam_from_body(Rf[i], pf[i]) for i in range(K)]

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)

    chi2, posz = B.ba_chi2(
        f(np.stack([c[0] for c in cams])), f(np.stack([c[1] for c in cams])), f(Xf),
        torch.as_tensor(snap["obs_kf_a"], device=device),
        torch.as_tensor(snap["obs_pt_a"], device=device), f(snap["uvr_a"]),
        f(snap["inv_s2_a"]), torch.zeros(O, dtype=torch.bool, device=device),
        camera.fx, camera.fy, camera.cx, camera.cy, 0.0, cam=camera.spec)
    bad = (chi2.cpu().numpy() > chi2_prune) | ~posz.cpu().numpy()
    with hold():
        # write back body states -> camera poses (staleness-guarded)
        for k, i in idx.items():
            if fixed[i] and not (fix_first and i == 0):
                continue    # the frontier: pose fixed, nothing changed
            if not m.kf_valid[k]:
                continue
            m.kf_R[k], m.kf_t[k] = calib.cam_from_body(Rf[i], pf[i])
            m.kf_vel[k] = vf[i]
        for k in opt_kfs:
            if m.kf_valid[k]:
                m.kf_bg[k] = bgf[idx[k]]
                m.kf_ba[k] = baf[idx[k]]
        live = m.mp_valid[pts]
        m.mp_pos[pts[live]] = Xf[live]
        for o in np.nonzero(bad)[0]:
            j, okf = obs_ref[o]
            if m.mp_valid[j]:
                m.erase_observation(j, okf)
        for j in pts:
            if m.mp_valid[int(j)]:
                m.update_point_stats(int(j))
        # the write-back bumps the map change index (ref Map::
        # IncreaseChangeIndex): the tracker re-anchors its prior
        m.map_version += 1
