"""FAST-9/16 corner detection as whole-image tensor ops
(port of tpuslam/ops/fast.py; ref: src/ORBextractor.cc:808-840).

The image is processed as 16 statically shifted planes; the "9 contiguous
of 16" arc test and the FAST score (the largest threshold at which the
pixel stays a corner, OpenCV's definition) come from log-depth windowed
min/max reductions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle radius 3, clockwise from 12 o'clock (OpenCV order)
CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx, dy)


def _shifted_planes(img):
    """[H,W] -> [16,H,W] where plane k is I(x+dx_k, y+dy_k), edge-padded;
    border pixels are masked by the caller (3px margin)."""
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    return torch.stack([p[3 + int(dy):3 + int(dy) + h, 3 + int(dx):3 + int(dx) + w]
                        for dx, dy in CIRCLE])


def _window9_reduce(x, op):
    """out[r] = op over x[r..r+8 mod 16] along axis 0 of [16,H,W];
    log-depth: window 2 -> 4 -> 8 -> 9."""
    ext = torch.cat([x, x[:8]], dim=0)  # [24,...]
    w2 = op(ext[:-1], ext[1:])
    w4 = op(w2[:-2], w2[2:])
    w8 = op(w4[:-4], w4[4:])
    return op(w8[:-1], ext[8:])


def _border_mask(h, w, margin, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def fast_score(img):
    """FAST-9/16 score map [H,W] f32 (0 where not a corner at any threshold)."""
    diff = _shifted_planes(img) - img[None]
    bright = _window9_reduce(diff, torch.minimum).amax(dim=0)
    dark = _window9_reduce(-diff, torch.minimum).amax(dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    h, w = img.shape
    return torch.where(_border_mask(h, w, 3, img.device), score, 0.0)


def nms3x3(score):
    """3x3 non-max suppression with the plateau tie-break of the JAX
    version: a tiny index-based epsilon, -(y*w+x)*1e-7 in f32, keeps the
    lexicographically first pixel of a plateau."""
    h, w = score.shape
    ys = torch.arange(h, dtype=torch.int32, device=score.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=score.device)[None, :]
    eps = (-(ys * w + xs)).to(score.dtype) * 1e-7
    s2 = torch.where(score > 0, score + eps, score)
    # max_pool2d pads with -inf: reduce_window "SAME" with a -inf init
    m2 = F.max_pool2d(s2[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(s2 >= m2, score, 0.0)


def cell_threshold_gate(score, ini_th: float, min_th: float, cell: int = 32):
    """Reference cell semantics (ORBextractor.cc:808-840): in cells with
    any corner >= ini_th keep only those; elsewhere keep corners >= min_th."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    sp = F.pad(score, (0, pw, 0, ph))
    cell_max = sp.reshape((h + ph) // cell, cell, (w + pw) // cell, cell).amax(dim=(1, 3))
    has_ini = (cell_max >= ini_th).repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    keep = torch.where(has_ini, score >= ini_th, score >= min_th)
    return torch.where(keep, score, 0.0)
