"""Tracking-frontend benchmark of the PyTorch port (the counterpart of
bench_frontend.py): the per-frame kernel chain on one CUDA card.

The chain (bench_frontend.py:46-87): ORB extraction at 1024 features on a
752x480 frame -> Hamming matrix against the previous frame -> masked best-2
-> the 50 / 0.9 ratio gate -> one-to-one resolution -> the motion-only pose
LM (4 x 10 schedule, the pose-LM kernel). Each frame's pose seeds the
next, so 256 frames are 256 sequential steps (per-frame latency, not batch
throughput); one torch.cuda.synchronize() ends the chain. The previous
frame's descriptors and landmarks come from a real extraction of the same
image, back-projected at z = 4 m, so the matcher finds real
correspondences and the LM accepts and rejects real steps (inliers > 0
is checked). Best of 3 chains; the reference's budget is 20 fps.

    python3 bench_frontend_torch.py               # on the card
    python3 bench_frontend_torch.py --device cpu --frames 4 --size 376x240 --features 300

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

`entry()` is the counterpart of __graft_entry__.entry(): one fused
tracking step (engine/track_device.FusedTrackStep, what
System.track_stereo dispatches per frame) with that function's example
inputs (752x480, N = 1024, P = 2048, seed 0).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 256
N_CHAINS = 3
WIDTH, HEIGHT = 752, 480
N_FEATURES = 1024
FX = FY = 458.0
INI_TH, MIN_TH = 20.0, 7.0    # the FAST thresholds bench_frontend.py passes
P_ENTRY = 2048


def kernel_chain(device, width=WIDTH, height=HEIGHT, n_features=N_FEATURES):
    """(forward, (img, prev_bits, prev_X, R0, t0)): the chain and its
    inputs on `device`; forward(img, prev_bits, prev_X, R0, t0) -> (R, t,
    inlier count), all device tensors."""
    import torch

    from tpuslam_torch.engine.config import OrbConfig
    from tpuslam_torch.ops.hamming import hamming_matrix
    from tpuslam_torch.ops.match import masked_best2, resolve_duplicates
    from tpuslam_torch.ops.orb import OrbExtractor
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    N = n_features
    cx, cy = width / 2.0, height / 2.0
    extractor = OrbExtractor(OrbConfig(n_features=N), device)
    ones = torch.ones(N, device=device)
    no_stereo = torch.zeros(N, dtype=torch.bool, device=device)
    zero_col = torch.zeros(N, 1, device=device)

    def forward(img, prev_bits, prev_X, R0, t0):
        feats = extractor(img, INI_TH, MIN_TH)
        mask = feats["valid"][:, None].expand(N, prev_bits.shape[0])
        dist = hamming_matrix(feats["bits"], prev_bits)
        idx, best, second = masked_best2(dist, mask)
        good = (best <= 50) & (best.float() < 0.9 * second.float())
        idx, good = resolve_duplicates(idx, best, good, prev_bits.shape[0])
        X = prev_X[torch.clamp(idx, 0, prev_X.shape[0] - 1).long()]
        uvr = torch.cat([feats["xy"], zero_col], dim=-1)
        R, t, inliers, _ = pose_optimize_best(R0, t0, X, uvr, ones, no_stereo, good,
                                              FX, FY, cx, cy, 0.0)
        return R, t, inliers.sum()

    # previous-frame state from a real extraction of the same image
    rng = np.random.RandomState(0)
    img = torch.tensor(rng.rand(height, width).astype(np.float32) * 255.0, device=device)
    f = extractor(img, INI_TH, MIN_TH)
    z = 4.0
    prev_X = torch.stack([(f["xy"][:, 0] - cx) / FX * z, (f["xy"][:, 1] - cy) / FY * z,
                          torch.full_like(f["xy"][:, 0], z)], dim=-1)
    R0 = torch.eye(3, device=device)
    t0 = torch.zeros(3, device=device)
    return forward, (img, f["bits"], prev_X, R0, t0)


def chain_time(forward, args, n):
    """An n-frame pose-carry chain ending in one synchronize: (seconds,
    the last frame's inliers, the last pose (R, t))."""
    import torch

    img, prev_bits, prev_X, R, t = args
    start = time.perf_counter()
    for _ in range(n):
        R, t, inl = forward(img, prev_bits, prev_X, R, t)
    if img.is_cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - start, int(inl), (R, t)


def graft_inputs():
    """__graft_entry__.entry()'s example inputs as numpy arrays, made by
    the same seeded numpy calls: imgs [2,480,752] u8, mapGeo [P,8],
    mapBits [P,256] u8, mapValid [P], refBits [N,256] u8, refMeta [N,2],
    pose_in [13], min_req2 [1]."""
    N, P = N_FEATURES, P_ENTRY
    rng = np.random.RandomState(0)
    imgs = (rng.rand(2, HEIGHT, WIDTH) * 255).astype(np.uint8)
    geo = np.concatenate([rng.randn(P, 3) + [0, 0, 5], rng.randn(P, 3),
                          np.full((P, 1), 0.5), np.full((P, 1), 50.0)], 1).astype(np.float32)
    bits = (rng.rand(P, 256) > 0.5).astype(np.uint8)
    valid = np.ones(P, bool)
    ref_bits = (rng.rand(N, 256) > 0.5).astype(np.uint8)
    ref_meta = np.stack([np.zeros(N), rng.randint(0, P, N).astype(float)], 1).astype(np.float32)
    pose_in = np.concatenate([np.eye(3).ravel(), np.zeros(4)]).astype(np.float32)
    return imgs, geo, bits, valid, ref_bits, ref_meta, pose_in, np.float32([60.0])


def entry(device="cuda"):
    """(forward, example_args): one fused stereo tracking step at
    752x480 / 1024 features on graft_inputs(); forward(*example_args) ->
    (pose [13], assoc [N], rowflags [2P])."""
    from tpuslam_torch.cameras import Pinhole
    from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
    from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy

    cam = Pinhole([FX, FY, WIDTH / 2.0, HEIGHT / 2.0], WIDTH, HEIGHT)
    step = FusedTrackStep(cam, OrbConfig(n_features=N_FEATURES), TrackingConfig(), 8, 1.2,
                          FX * 0.11, True, device=device)

    def forward(*args):
        out = step(*args)
        return out["pose"], out["assoc"], out["rowflags"]

    return forward, step_inputs_from_numpy(*graft_inputs(), device=step.sf.device)


def main(argv=None):
    """Run the benchmark, print its JSON line and return the frames/s."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=N_FRAMES, help="frames per chain")
    p.add_argument("--size", default=f"{WIDTH}x{HEIGHT}", help="WIDTHxHEIGHT")
    p.add_argument("--features", type=int, default=N_FEATURES)
    p.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) "
                                                    "or 'cpu'")
    args = p.parse_args(argv)

    from tpuslam_torch.utils import resolve_device

    device = resolve_device(args.device)
    width, height = (int(v) for v in args.size.split("x"))
    forward, inputs = kernel_chain(device, width, height, args.features)
    _, inl0, _ = chain_time(forward, inputs, 1)      # first calls, then the check
    if inl0 <= 0:
        raise RuntimeError(f"no inliers ({inl0}): the bench inputs are broken")
    best = float("inf")
    for _ in range(N_CHAINS):
        dt, _, (R, t) = chain_time(forward, inputs, args.frames)
        if not (bool(R.isfinite().all()) and bool(t.isfinite().all())):
            raise RuntimeError("the chain's pose is not finite")
        best = min(best, dt / args.frames)
    fps = 1.0 / best
    print(json.dumps({
        "metric": f"tracking_frontend_fps_{width}x{height}_{args.features}feat",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 20.0, 3),
    }), flush=True)
    return fps


if __name__ == "__main__":
    main()
