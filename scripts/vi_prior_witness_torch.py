"""Trace the marginalization prior of the PyTorch port's visual-inertial
tracking over bench_sensors_torch.py's mono-inertial row (vi_excite,
376x240, 600 features, a 200 Hz IMU), to find where the prior becomes
non-finite and why.

    python scripts/vi_prior_witness_torch.py [--frames 80] [--passes 2] \\
        [--device cuda] [--out build/vi_prior]

Every pose_inertial_solve call prints one JSON line: pass, frame, the
anchor variant, whether the prior it was given, the [30, 30] Hessian it
marginalized, the anchor block's factorization, its state and its new
prior H15 are finite, and the anchor block's smallest Jacobi-scaled
eigenvalue. The first call of each pass whose H15 is not finite, while the
prior it was given was, is saved to --out as an .npz: the inputs of every
solve of its prior chain (from the last keyframe-anchored solve on), their
outputs, and the failing call's Hessian.
tests/test_torch_vi_solve.py::test_kf_anchored_solve_from_the_card_gives_a_finite_prior
replays one such call through tpuslam's solver and the port's.
"""

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flatten(args, kw):
    """A solve's inputs as {name: array}: positional a0.., the
    preintegration dict as a15.<key>; the camera spec is left out (pinhole)."""
    import torch

    out = {}
    for i, a in enumerate(args):
        if isinstance(a, dict):
            out.update({f"a{i}.{k}": v.detach().cpu().numpy() for k, v in a.items()})
        else:
            out[f"a{i}"] = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    out.update({f"k.{k}": np.asarray(v) for k, v in kw.items() if k != "cam"})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) "
                                                     "or 'cpu'")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "vi_prior"))
    args = ap.parse_args(argv)

    import torch

    import bench_sensors_torch
    from tpuslam_torch.solve import pose_inertial
    from tpuslam_torch.utils import resolve_device

    device = resolve_device(args.device)
    make, track = bench_sensors_torch.vi_row(args.frames, device)
    real_solve, real_marg = pose_inertial.pose_inertial_solve, pose_inertial._marginalize_anchor
    seen = {}
    chain = collections.deque()
    where = {"pass": 0, "frame": 0}
    saved, failures = [], []

    def marg(H):
        seen["H"] = H.detach().clone()
        return real_marg(H)

    def solve(*a, **kw):
        anchor_fixed = bool(a[27])
        if anchor_fixed:
            chain.clear()
        ins = flatten(a, kw)
        out = real_solve(*a, **kw)
        H = seen.pop("H").double()
        H11 = H[:15, :15]
        d = torch.diagonal(H11)
        good = (d > 0) & torch.isfinite(d)
        s = torch.where(good, torch.rsqrt(torch.where(good, d, 1.0)), 1.0)
        A = H11 * s[:, None] * s[None, :] + 1e-6 * torch.eye(15, dtype=H.dtype, device=H.device)
        _, info = torch.linalg.solve_ex(A.float(), (s[:, None] * H[:15, 15:]).float())
        finite = lambda x: bool(torch.isfinite(x).all())  # noqa: E731
        eig = float(torch.linalg.eigvalsh(A).min()) if finite(A) else float("nan")
        rec = dict(where, anchor_fixed=anchor_fixed, n_obs=int(a[14].sum()),
                   prior_finite=finite(a[21]), H_finite=finite(H),
                   anchor_block_info=int(info), min_scaled_eig=eig,
                   state_finite=all(finite(x) for x in out[:5]), H15_finite=finite(out[6]),
                   n_inliers=int(out[7]))
        print(json.dumps(rec), flush=True)
        chain.append((ins, {f"o{j}": x.detach().cpu().numpy() for j, x in enumerate(out)}))
        if not rec["H15_finite"]:
            failures.append(rec)
            if rec["prior_finite"] and all(s["pass"] != where["pass"] for s in saved):
                os.makedirs(args.out, exist_ok=True)
                path = os.path.join(args.out, f"pass{where['pass']}_frame{where['frame']}.npz")
                arrays = {"H": H.cpu().numpy(), "n_calls": np.asarray(len(chain))}
                for j, (i_, o_) in enumerate(chain):
                    arrays.update({f"c{j}/{k}": v for k, v in {**i_, **o_}.items()})
                np.savez_compressed(path, **arrays)
                saved.append(dict(where, path=os.path.relpath(path, ROOT), n_calls=len(chain)))
        return out

    pose_inertial.pose_inertial_solve, pose_inertial._marginalize_anchor = solve, marg
    try:
        for p in range(args.passes):
            t0 = time.perf_counter()
            slam = make()
            for i in range(args.frames):
                where.update({"pass": p, "frame": i})
                track(slam, i)
            slam.shutdown()
            print(json.dumps({"pass": p, "state": slam.get_tracking_state().name,
                              "kfs": len(slam.map.valid_kf_ids()),
                              "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        pose_inertial.pose_inertial_solve, pose_inertial._marginalize_anchor = real_solve, real_marg
    summary = {"device": str(device), "frames": args.frames, "passes": args.passes,
               "non_finite_priors": [(f["pass"], f["frame"]) for f in failures],
               "first_from_a_finite_prior": [(f["pass"], f["frame"]) for f in failures
                                             if f["prior_finite"]],
               "saved": saved}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
