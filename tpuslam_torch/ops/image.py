"""Image primitives: separable Gaussian blur, pyramid construction
(port of tpuslam/ops/image.py; ref: src/ORBextractor.cc:1114, 1152-1178).

Plain [H, W] f32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, taps):
    """Separable Gaussian blur with reflect padding on [H, W] f32.

    taps: [ksize] f32 tensor (gaussian_kernel1d). Each 1-D pass is the same
    weighted sum of statically shifted copies, in the same order, as the
    JAX version."""
    ksize = taps.shape[0]
    r = ksize // 2
    h, w = img.shape
    p = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    x = sum(taps[i] * p[:, i:i + w] for i in range(ksize))
    p = F.pad(x[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    x = sum(taps[i] * p[i:i + h, :] for i in range(ksize))
    return x


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) list, rounded like the JAX version."""
    shapes = []
    for l in range(n_levels):
        s = 1.0 / (scale ** l)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def build_pyramid(img, n_levels: int, scale: float):
    """[H,W] f32 -> list of per-level images, each resized from the one
    before (cascaded, like the reference's ComputePyramid).

    jax.image.resize "bilinear" antialiases when it downsamples, so this
    uses the antialiased bilinear filter too: level 0 is bitwise equal to
    the JAX version, levels >= 1 agree to a few 1e-3."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(F.interpolate(
            levels[-1][None, None], size=shapes[l], mode="bilinear",
            align_corners=False, antialias=True)[0, 0])
    return levels
