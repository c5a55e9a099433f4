"""Per-keypoint patch gather (port of tpuslam/ops/patch_pallas.py).

`extract_patches_levels(imgs, yx, counts, size)` gathers the patches of
all pyramid levels of one image in one launch of the CUDA kernel of
csrc/patch.cu on CUDA tensors, and runs the plain PyTorch gather level by
level on CPU tensors; `extract_patches(img, yx, size)` is its one-level
case (tpuslam's entry point). Both copy the same pixels, so they agree
bitwise.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import MAX_LEVELS, PatchLevels

MAX_SIZE = 40


counter = _build.LaunchCounter()


def extract_patches_plain(img, yx, size: int):
    """img[yx[:,0] + dy, yx[:,1] + dx] for the [size, size] window at each
    top-left corner; every yx must satisfy 0 <= yx <= (H, W) - size."""
    d = torch.arange(size, device=img.device)
    yx = yx.long()
    return img[yx[:, 0, None, None] + d[None, :, None],
               yx[:, 1, None, None] + d[None, None, :]]


def extract_patches_levels_plain(imgs, yx, counts, size: int):
    """The per-level plain gathers, concatenated: level l's patches are
    rows start[l]:start[l] + counts[l] of yx (start: prefix sums of counts)."""
    out, k = [], 0
    for img, n in zip(imgs, counts):
        out.append(extract_patches_plain(img, yx[k:k + n], size))
        k += n
    return torch.cat(out, dim=0)


def _launch(imgs, yx, counts, size: int):
    if not 0 < len(imgs) <= MAX_LEVELS or len(counts) != len(imgs):
        raise ValueError(f"1 to {MAX_LEVELS} levels with one count each")
    dev = yx.device
    for img in imgs:
        if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
            raise ValueError("every level must be a contiguous 2-D float32 tensor")
        if img.device != dev:
            raise ValueError("the levels and yx must be on the same device")
    if yx.dtype != torch.int32 or yx.dim() != 2 or yx.shape[1] != 2 or not yx.is_contiguous():
        raise ValueError("yx must be a contiguous [K, 2] int32 tensor")
    if min(counts) < 0 or sum(counts) != yx.shape[0]:
        raise ValueError(f"counts {list(counts)} do not add up to the {yx.shape[0]} rows of yx")
    if not 0 < size <= MAX_SIZE:
        raise ValueError(f"size must be in (0, {MAX_SIZE}]")
    lv = PatchLevels()
    lv.n_levels = len(imgs)
    k = 0
    for l, (img, n) in enumerate(zip(imgs, counts)):
        lv.img[l] = img.data_ptr()
        lv.H[l], lv.W[l] = img.shape
        lv.start[l] = k
        k += int(n)
    lv.start[len(imgs)] = k
    out = torch.empty((k, size, size), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().patch_gather_levels(lv, yx.data_ptr(), size, out.data_ptr(), stream)
    _build.check(err, "patch_gather_levels")
    counter.launches += 1
    return out


def extract_patches_levels(imgs, yx, counts, size: int):
    """Gather [size, size] patches from the levels imgs [H_l, W_l] f32 at
    top-left corners yx [K, 2] int32 (row, col): counts[l] rows for level
    l, in level order -> [K, size, size] f32.

    CUDA tensors: one launch of the hand-written kernel (or an error). CPU
    tensors: the plain gathers."""
    kinds = {t.device.type for t in (yx, *imgs)}
    if kinds == {"cpu"}:
        return extract_patches_levels_plain(imgs, yx, counts, size)
    if kinds != {"cuda"}:
        raise ValueError(f"unsupported devices {sorted(kinds)}")
    return _launch(imgs, yx, counts, size)


def extract_patches(img, yx, size: int):
    """Gather [size, size] patches at top-left corners yx [K,2] int32
    (row, col) from img [H,W] f32 -> [K, size, size] f32: the one-level
    case of extract_patches_levels."""
    return extract_patches_levels([img], yx, [yx.shape[0]], size)
