"""CUDA kernels of the PyTorch port vs their plain PyTorch versions, on
the card. These tests need a CUDA device and skip without one; the file
imports no jax, so it also runs on a host that has none:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py

Tolerances: the patch gather is a copy (bitwise); the pose LM sums in
another order than the plain version (R 1e-4, t 1e-3, inliers >= 0.99)
and repeats itself bitwise (fixed-order reductions); the fused step,
stereo (pyramid and level-0 SAD) and mono, as in
tests/test_torch_track_step.py.
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
    yx = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img, torch.zeros(3, 2, dtype=torch.int64, device=cuda), 37)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img.T, yx, 37)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches(img, yx, patch_cuda.MAX_SIZE + 1)
    with pytest.raises(ValueError):                                  # counts != rows
        patch_cuda.extract_patches_levels([img, img], yx, [1, 1], 37)
    with pytest.raises(ValueError):                                  # a level on the CPU
        patch_cuda.extract_patches_levels([img, img.cpu()], yx, [1, 2], 37)
    with pytest.raises(ValueError):
        patch_cuda.extract_patches_levels([img] * (patch_cuda.MAX_LEVELS + 1), yx,
                                          [3] + [0] * patch_cuda.MAX_LEVELS, 37)


@pytest.mark.parametrize("size", [37, 16])
def test_patch_levels_kernel_bitwise(cuda, size):
    """One launch over 8 levels (one of them with no keypoint) against the
    per-level plain gathers; a corner that breaks the contract reads 0
    outside its level, as the plain gather cannot show."""
    rng = np.random.RandomState(7)
    shapes = [(int(518 / 1.2 ** l), int(790 / 1.2 ** l)) for l in range(8)]
    counts = [222, 185, 0, 128, 107, 89, 74, 65]
    imgs = [torch.tensor(rng.rand(h, w).astype(np.float32), device=cuda) for h, w in shapes]
    yx = np.concatenate([np.stack([rng.randint(0, h - size + 1, n),
                                   rng.randint(0, w - size + 1, n)], -1)
                         for (h, w), n in zip(shapes, counts)]).astype(np.int32)
    yx[counts[0] - 1] = (shapes[0][0] - size, shapes[0][1] - size)   # last row of level 0
    yx = torch.tensor(yx, device=cuda)
    before = patch_cuda.counter.launches
    got = patch_cuda.extract_patches_levels(imgs, yx, counts, size)
    assert patch_cuda.counter.launches == before + 1
    assert torch.equal(got, patch_cuda.extract_patches_levels_plain(imgs, yx, counts, size))
    h7, w7 = shapes[7]
    yx[-1] = torch.tensor([h7 - 5, w7 - 3], dtype=torch.int32)        # level 7's last row
    out = patch_cuda.extract_patches_levels(imgs, yx, counts, size)[-1].cpu()
    assert torch.equal(out[:5, :3], imgs[7][h7 - 5:, w7 - 3:].cpu())
    assert out[5:].eq(0).all() and out[:, 3:].eq(0).all()             # 0 outside level 7


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


@pytest.mark.parametrize("n_rounds", [2, 4])
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("n", [217, 256, 768, 1024, 5000])
def test_pose_kernel_matches_plain(cuda, n, stereo, n_rounds):
    args = _pose_problem(n, stereo, cuda)
    R, t, inl, chi2 = pose_opt_cuda.pose_optimize_fused(*args, n_rounds=n_rounds)
    Rp, tp, inlp, chi2p = pose_opt_cuda.pose_optimize_plain(*args, n_rounds=n_rounds)
    assert inl.dtype == torch.bool and chi2.shape == (n,)
    assert (R - Rp).abs().max() <= 1e-4 and (t - tp).abs().max() <= 1e-3
    assert (inl == inlp).float().mean() >= 0.99
    again = pose_opt_cuda.pose_optimize_fused(*args, n_rounds=n_rounds)
    for a, b in zip(again, (R, t, inl, chi2)):                      # fixed-order reductions
        assert torch.equal(a, b)


def _stereo_step_against_plain(cuda, monkeypatch, sad):
    """The stereo step with TrackingConfig(fused_sad=sad) on frame 1
    through the kernels (2 patch-gather and 4 pose-LM launches) against the
    same step with the kernels' plain versions."""
    seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
    u8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)  # noqa: E731
    frames = [np.stack([u8(seq.frame(i)), u8(seq.frame(i, right=True))]) for i in range(3)]
    step = FusedTrackStep(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240),
                          OrbConfig(n_features=500), TrackingConfig(fused_sad=sad), 8, 1.2,
                          seq.fx * seq.baseline, True, device=cuda)
    f0 = step.extract(torch.tensor(frames[0], device=cuda))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()}, seq.fx, seq.fy,
                             seq.cx, seq.cy, step.sf.cpu().numpy(), p_base=512)
    pose0 = np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32)
    inp = step_inputs_from_numpy(frames[1], *local, pose0, np.float32([60]), cuda)
    n_patch, n_pose = patch_cuda.counter.launches, pose_opt_cuda.counter.launches
    out = step(*inp)
    assert patch_cuda.counter.launches - n_patch == 2          # one per image
    assert pose_opt_cuda.counter.launches - n_pose == 4
    monkeypatch.setattr(orb, "extract_patches_levels", patch_cuda.extract_patches_levels_plain)
    monkeypatch.setattr(track_device, "pose_optimize_fused", pose_opt_cuda.pose_optimize_plain)
    ref = step(*inp)
    assert (out["pose"][:9] - ref["pose"][:9]).abs().max() <= 5e-4
    assert (out["pose"][9:12] - ref["pose"][9:12]).abs().max() <= 5e-3
    assert (out["assoc"] == ref["assoc"]).float().mean() >= 0.95
    assert int(out["pose"][12]) >= 100


def test_fused_step_kernels_match_plain(cuda, monkeypatch):
    _stereo_step_against_plain(cuda, monkeypatch, "pyramid")


def test_level0_fused_step_kernels_match_plain(cuda, monkeypatch):
    """fused_sad="level0": the level-0 SAD refinement, the same kernels."""
    _stereo_step_against_plain(cuda, monkeypatch, "level0")


def test_mono_fused_step_kernels_match_plain(cuda, monkeypatch):
    """The mono step (one image: 1 patch launch, 4 pose LMs with every
    row monocular) through the kernels against its plain path, chained
    over two frames."""
    seq = SyntheticSequence(n_frames=3, fps=20, speed=0.5, baseline=0.11)
    u8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)  # noqa: E731
    cam = Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240)
    st = FusedTrackStep(cam, OrbConfig(n_features=500), TrackingConfig(), 8, 1.2,
                        seq.fx * seq.baseline, True, device=cuda)
    f0 = st.extract(torch.tensor(np.stack([u8(seq.frame(0)), u8(seq.frame(0, right=True))]),
                                 device=cuda))
    f0["und_xy"] = f0["xy"]
    local = stereo_local_map({k: v.cpu().numpy() for k, v in f0.items()}, seq.fx, seq.fy,
                             seq.cx, seq.cy, st.sf.cpu().numpy(), p_base=512)
    mono = FusedTrackStep(cam, OrbConfig(n_features=500), TrackingConfig(), 8, 1.2, 0.0, False,
                          device=cuda)
    pose = np.r_[np.eye(3).ravel(), np.zeros(4)].astype(np.float32)
    for i in (1, 2):
        inp = step_inputs_from_numpy(u8(seq.frame(i))[None], *local, pose, np.float32([60]),
                                     cuda)
        n_patch, n_pose = patch_cuda.counter.launches, pose_opt_cuda.counter.launches
        out = mono(*inp)
        assert patch_cuda.counter.launches - n_patch == 1
        assert pose_opt_cuda.counter.launches - n_pose == 4
        with monkeypatch.context() as mp:
            mp.setattr(orb, "extract_patches_levels", patch_cuda.extract_patches_levels_plain)
            mp.setattr(track_device, "pose_optimize_fused", pose_opt_cuda.pose_optimize_plain)
            ref = mono(*inp)
        assert (out["pose"][:9] - ref["pose"][:9]).abs().max() <= 5e-4
        assert (out["pose"][9:12] - ref["pose"][9:12]).abs().max() <= 5e-3
        assert (out["assoc"] == ref["assoc"]).float().mean() >= 0.95
        assert int(out["pose"][12]) >= 100
        pose = out["pose"].cpu().numpy()



@pytest.mark.parametrize("case", ["regular", "singular", "inf"])
def test_anchor_marginalization_on_the_card(cuda, case):
    """pose_inertial_solve's prior on the card: a singular or non-finite
    anchor block gives a non-finite prior, never an exception (tpuslam's
    jnp.linalg.solve raises nothing); a regular one the CPU's result."""
    from tpuslam_torch.solve.pose_inertial import _marginalize_anchor

    rng = np.random.RandomState(0)
    M = rng.randn(30, 30)
    H = M @ M.T + np.eye(30)
    if case == "singular":
        H[:15, :15] = np.eye(15)
        H[0, 1] = H[1, 0] = 1.0 + 1e-6
    if case == "inf":
        H[3, 3] = np.inf
    for dtype in (torch.float64, torch.float32):
        got = _marginalize_anchor(torch.tensor(H, dtype=dtype, device=cuda)).cpu()
        if case == "regular":
            want = _marginalize_anchor(torch.tensor(H, dtype=dtype))
            assert torch.allclose(got, want, rtol=1e-4 if dtype == torch.float32 else 1e-9)
        else:
            assert not bool(torch.isfinite(got).all())

def test_host_pose_route_matches_plain(cuda):
    """The host tracker's route (pose_opt_dispatch): f64 inputs cast to f32,
    700 observations padded with invalid rows to 768."""
    from tpuslam_torch.solve.pose_opt_dispatch import pose_optimize_best

    args = _pose_problem(700, True, cuda, seed=4)
    pad = lambda a, v: torch.cat([a, torch.full((68,) + a.shape[1:], v, dtype=a.dtype,  # noqa: E731
                                                 device=cuda)])
    X, uvr, is2, st, valid = (pad(args[2], 0), pad(args[3], 0), pad(args[4], 1),
                              pad(args[5], False), pad(args[6], False))
    f64 = [a.double() for a in (args[0], args[1], X, uvr, is2)]
    before = pose_opt_cuda.counter.launches
    R, t, inl, _ = pose_optimize_best(*f64, st, valid, *args[7:])
    assert pose_opt_cuda.counter.launches == before + 1
    Rp, tp, inlp, _ = pose_opt_cuda.pose_optimize_plain(*args[:2], X, uvr, is2, st, valid,
                                                        *args[7:])
    assert (R - Rp).abs().max() <= 1e-4 and (t - tp).abs().max() <= 1e-3
    assert (inl == inlp).float().mean() >= 0.99 and not inl[700:].any()


def test_system_on_the_card_matches_cpu(cuda):
    """The port's System on the card against the same System on the CPU:
    8 rendered frames, a keyframe every 2 frames (init, fused and host
    tracking, triangulation, fusion, local BA); poses within 1 cm."""
    from tpuslam_torch.engine.config import SlamConfig
    from tpuslam_torch.engine.system import Sensor, System

    seq = SyntheticSequence(n_frames=8, fps=10, speed=0.5, baseline=0.1)
    cfg = SlamConfig(orb=OrbConfig(n_features=500),
                     tracking=TrackingConfig(min_stereo_init_features=200,
                                             max_frames_between_kf=2))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        slam = System(Pinhole([seq.fx, seq.fy, seq.cx, seq.cy], 376, 240), cfg,
                      sensor=Sensor.STEREO, bf=seq.fx * seq.baseline, device=dev)
        n_patch, n_pose = patch_cuda.counter.launches, pose_opt_cuda.counter.launches
        for i in range(8):
            slam.tracker.fused_enabled = i != 5          # frame 5: the host path
            slam.track_stereo(seq.frame(i), seq.frame(i, right=True), i / seq.fps)
        runs[dev.type] = (slam, patch_cuda.counter.launches - n_patch,
                          pose_opt_cuda.counter.launches - n_pose)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu[1] == 8 * 2 and gpu[2] > 6 * 4 and cpu[1:] == (0, 0)
    assert gpu[0].get_tracking_state().name == "OK" and len(gpu[0].map.valid_kf_ids()) >= 3
    for a, b in zip(gpu[0].trajectory_tum(), cpu[0].trajectory_tum()):
        assert abs(a[0] - b[0]) < 1e-9 and np.linalg.norm(np.subtract(a[1:4], b[1:4])) < 0.01
