"""Shape bucketing (port of tpuslam/utils/pad.py).

The port keeps tpuslam's buckets where a shape is part of the result: the
fused tracker's local-map rows (P bucket) and the host tracker's pose rows
(padded to a multiple of 256). Padded rows are invalid.
"""

from __future__ import annotations

import numpy as np


def bucket(n: int, base: int = 128) -> int:
    """Smallest power-of-two multiple progression >= n: base, 2*base, ...
    Growth is x2, so at most log2 distinct shapes per base."""
    if n <= base:
        return base
    b = base
    while b < n:
        b *= 2
    return b


def pad_to(arr: np.ndarray, n: int, fill=0):
    """Pad axis 0 of arr to length n with `fill`."""
    if len(arr) == n:
        return arr
    pad_shape = (n - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)
