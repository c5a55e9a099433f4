"""Batched per-keypoint patch gather (port of tpuslam/ops/patch_pallas.py).

`extract_patches(img, yx, size)` launches the CUDA kernel of
csrc/patch.cu on CUDA tensors and runs the plain PyTorch gather on CPU
tensors. Both copy the same pixels, so they agree bitwise.
"""

from __future__ import annotations

import torch

from .. import _build

MAX_SIZE = 40


counter = _build.LaunchCounter()


def extract_patches_plain(img, yx, size: int):
    """img[yx[:,0] + dy, yx[:,1] + dx] for the [size, size] window at each
    top-left corner; every yx must satisfy 0 <= yx <= (H, W) - size."""
    d = torch.arange(size, device=img.device)
    yx = yx.long()
    return img[yx[:, 0, None, None] + d[None, :, None],
               yx[:, 1, None, None] + d[None, None, :]]


def _launch(img, yx, size: int):
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError("img must be a contiguous 2-D float32 tensor")
    if (yx.dtype != torch.int32 or yx.dim() != 2 or yx.shape[1] != 2
            or not yx.is_contiguous()):
        raise ValueError("yx must be a contiguous [K, 2] int32 tensor")
    if yx.device != img.device:
        raise ValueError("img and yx must be on the same device")
    if not 0 < size <= MAX_SIZE:
        raise ValueError(f"size must be in (0, {MAX_SIZE}]")
    k = yx.shape[0]
    h, w = img.shape
    out = torch.empty((k, size, size), dtype=torch.float32, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _build.lib().patch_gather(img.data_ptr(), h, w, yx.data_ptr(), k,
                                    size, out.data_ptr(), stream)
    _build.check(err, "patch_gather")
    counter.launches += 1
    return out


def extract_patches(img, yx, size: int):
    """Gather [size, size] patches at top-left corners yx [K,2] int32
    (row, col) from img [H,W] f32 -> [K, size, size] f32.

    CUDA tensors: the hand-written kernel (or an error). CPU tensors: the
    plain gather."""
    if img.device.type == "cpu":
        return extract_patches_plain(img, yx, size)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    return _launch(img, yx, size)
