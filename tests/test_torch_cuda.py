"""CUDA kernels of the PyTorch port vs their plain PyTorch versions, on
the card. These tests need a CUDA device and skip without one; the file
imports no jax, so it also runs on a host that has none:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Tolerances: the patch gather is a copy (bitwise); the pose LM sums in
another order than the plain version (R 1e-4, t 1e-3, inliers >= 0.99);
the fused step as in tests/test_torch_track_step.py.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.cameras import Pinhole
from tpuslam_torch.engine import track_device
from tpuslam_torch.engine.config import OrbConfig, TrackingConfig
from tpuslam_torch.engine.track_device import FusedTrackStep, step_inputs_from_numpy
from tpuslam_torch.io.synthetic import SyntheticSequence
from tpuslam_torch.map.local_map import stereo_local_map
from tpuslam_torch.ops import orb, patch_cuda
from tpuslam_torch.solve import pose_opt_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("size", [5, 37, patch_cuda.MAX_SIZE])
def test_patch_kernel_bitwise(cuda, size):
    rng = np.random.RandomState(size)
    h, w = 518, 790
    img = torch.tensor(rng.rand(h, w).astype(np.float32), device=cuda)
    yx = np.stack([rng.randint(0, h - size + 1, 222), rng.randint(0, w - size + 1, 222)], -1)
    yx[:4] = [(0, 0), (0, w - size), (h - size, 0), (h - size, w - size)]
    yx = torch.tensor(yx.astype(np.int32), device=cuda)
    before = patch_cuda.counter.launches
    got = patch_cuda.extract_patches(img, yx, size)
    assert patch_cuda.counter.launches == before + 1
    assert torch.equal(got, patch_cuda.extract_patches_plain(img, yx, size))


def test_patch_kernel_masks_out_of_bounds(cuda):
    img = torch.ones(40, 50, device=cuda)
    yx = torch.tensor([[30, 45]], dtype=torch.int32, device=cuda)   # breaks the contract
    got = patch_cuda.extract_patches(img, yx, 37)[0].cpu()
    assert got[:10, :5].eq(1).all() and got[10:].eq(0).all() and got[:, 5:].eq(0).all()


def test_patch_kernel_rejects_bad_inputs(cuda):
    img = torch.zeros(40, 50, device=cuda)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img, torch.zeros(3, 2, dtype=torch.int64, device=cuda), 37)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img.T, torch.zeros(3, 2, dtype=torch.int32, device=cuda), 37)


def _pose_problem(n, stereo, dev, seed=0):
    rng = np.random.RandomState(seed)
    fx, cx, cy = 458.0, 376.0, 240.0
    bf = 50.4 if stereo else 0.0
    X = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 4 + 2], -1).astype(np.float32)
    u, v = fx * X[:, 0] / X[:, 2] + cx, fx * X[:, 1] / X[:, 2] + cy
    uvr = np.stack([u, v, u - bf / X[:, 2]], -1) + rng.randn(n, 3) * 0.3
    uvr[: n // 10] += rng.randn(n // 10, 3) * 40
    is_st = np.zeros(n, bool)
    is_st[: n // 2] = stereo
    dR, dt = pose_opt_cuda._se3_exp(torch.tensor([0.05, -0.02, 0.03, 0.02, -0.015, 0.01]))
    arrays = [dR, dt, torch.tensor(X), torch.tensor(uvr, dtype=torch.float32), torch.ones(n),
              torch.tensor(is_st), torch.ones(n, dtype=torch.bool)]
    return [a.contiguous().to(dev) for a in arrays] + [fx, fx, cx, cy, bf]


@pytest.mark.parametrize("n,stereo,n_rounds", [(1024, False, 4), (1024, True, 4),
                                               (217, True, 2), (5000, True, 2)])
def test_pose_kernel_matches_plain(cuda, n, stereo, n_rounds):
    args = _pose_problem(n, stereo, cuda)
    R, t, inl, chi2 = pose_opt_cuda.pose_optimize_fused(*args, n_rounds=n_rounds)
    Rp, tp, inlp, chi2p = pose_opt_cuda.pose_optimize_plain(*args, n_rounds=n_rounds)
    assert inl.dtype == torch.bool and chi2.shape == (n,)
    assert (R - Rp).abs().max() <= 1e-4 and (t - tp).abs().max() <= 1e-3
    assert (inl == inlp).float().mean() >= 0.99
    again = pose_opt_cuda.pose_optimize_fused(*args, n_rounds=n_rounds)
    assert torch.equal(again[0], R) and torch.equal(again[1], t)   # fixed-order reductions


def test_fused_step_kernels_match_plain(cuda, monkeypatch):
    seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
    u8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)  # noqa: E731
    frames = [np.stack([u8(seq.frame(i)), u8(seq.frame(i, right=True))]) for i in range(3)]
    step = FusedTrackStep(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
                          OrbConfig(n_features=500), TrackingConfig(), 8, 1.2,
                          seq.fx * seq.baseline, True, device=cuda)
    f0 = step.extract(torch.tensor(frames[0], device=cuda))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()}, seq.fx, seq.fy,
                             seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=512)
    pose0 = np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32)
    inp = step_inputs_from_numpy(frames[1], *local, pose0, np.float32([60]), cuda)
    n_patch, n_pose = patch_cuda.counter.launches, pose_opt_cuda.counter.launches
    out = step(*inp)
    assert patch_cuda.counter.launches - n_patch == 16
    assert pose_opt_cuda.counter.launches - n_pose == 4
    monkeypatch.setattr(orb, "extract_patches", patch_cuda.extract_patches_plain)
    monkeypatch.setattr(track_device, "pose_optimize_fused", pose_opt_cuda.pose_optimize_plain)
    ref = step(*inp)
    assert (out["pose"][:9] - ref["pose"][:9]).abs().max() <= 5e-4
    assert (out["pose"][9:12] - ref["pose"][9:12]).abs().max() <= 5e-3
    assert (out["assoc"] == ref["assoc"]).float().mean() >= 0.95
    assert int(out["pose"][12]) >= 100
