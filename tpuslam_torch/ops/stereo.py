"""Rectified stereo matching: row-banded Hamming + per-octave image-SAD
refinement, and the RGB-D virtual stereo (port of tpuslam/ops/stereo.py;
ref: Frame::ComputeStereoMatches, src/Frame.cc:802-981, and
Frame::ComputeStereoFromRGBD :983).

The level-0 SAD variant (`sad_refine`, the `fused_sad="level0"` option)
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import device_const
from .hamming import hamming_matrix
from .image import build_pyramid, pyramid_shapes
from .match import TH_HIGH


def stereo_match(bits_l, bits_r, xy_l, xy_r, oct_l, oct_r, valid_l, valid_r,
                 scale_factors, min_disp, max_disp):
    """Match left->right features on rectified images.

    Gates (ref Frame.cc:816-860): |v_l - v_r| <= 2*sf[oct_r] (row band),
    octave within +-1, disparity in [min_disp, max_disp].
    Returns (u_right [N_l], disparity [N_l], ok [N_l]).
    """
    dist = hamming_matrix(bits_l, bits_r)            # [Nl, Nr]
    row_band = 2.0 * scale_factors[oct_r.long()][None, :]
    disp = xy_l[:, 0][:, None] - xy_r[:, 0][None, :]
    mask = (
        (torch.abs(xy_l[:, 1][:, None] - xy_r[:, 1][None, :]) <= row_band)
        & (torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1)
        & (disp >= min_disp) & (disp <= max_disp)
        & valid_l[:, None] & valid_r[None, :]
    )
    dm = torch.where(mask, dist, 10_000)
    j = torch.argmin(dm, dim=1)
    best = dm.gather(1, j[:, None])[:, 0]
    u_r = xy_r[j, 0]
    d = xy_l[:, 0] - u_r
    return u_r, d, (best <= TH_HIGH) & (d > 1e-3)


def sad_refine_pyramid(img_l, img_r, xy_l, octave, u_r0, ok,
                       w: int = 5, L: int = 5,
                       n_levels: int = 8, scale: float = 1.2):
    """Per-octave image-SAD sub-pixel refinement (ref Frame.cc:869-930):
    the 11x11 center-normalized patch is gathered from the feature's level
    of the unblurred pyramid, slid +-L level-pixels along the right row,
    and the parabola-refined offset is scaled back to level 0.

    Both pyramids are padded into one [n_levels, H, W] stack so every
    feature is one 3-D gather whatever its octave.
    Returns (u_r [N], best_sad [N], ok [N]).
    """
    Hm, Wm = img_l.shape
    dtype = img_l.dtype
    dev = img_l.device
    shapes = pyramid_shapes(Hm, Wm, n_levels, scale)

    def stack(img):
        lv = build_pyramid(img.float(), n_levels, scale)
        return torch.stack([F.pad(im, (0, Wm - im.shape[1], 0, Hm - im.shape[0]))
                            for im in lv])

    pyr_l, pyr_r = stack(img_l), stack(img_r)
    octave = octave.long()
    lev_h = device_const([s[0] for s in shapes], torch.int64, dev)[octave]
    lev_w = device_const([s[1] for s in shapes], torch.int64, dev)[octave]
    sf = device_const(scale ** np.arange(n_levels), dtype, dev)[octave]

    ui = torch.round(xy_l[:, 0] / sf).long()
    vi = torch.round(xy_l[:, 1] / sf).long()
    ur0 = torch.round(u_r0 / sf).long()
    # reference border guard: the slid window must fit the level image
    inside = (
        (ui - w >= 0) & (ui + w < lev_w)
        & (vi - w >= 0) & (vi + w < lev_h)
        & (ur0 - L - w >= 0) & (ur0 + L + w < lev_w)
    )
    r = torch.arange(-w, w + 1, device=dev)
    dy, dx = r[:, None], r[None, :]
    iy = torch.clamp(vi[:, None, None] + dy[None], 0, Hm - 1)
    ixl = torch.clamp(ui[:, None, None] + dx[None], 0, Wm - 1)
    o3 = octave[:, None, None]
    pl = pyr_l[o3, iy, ixl]                               # [N,P,P]
    pl = pl - pl[:, w:w + 1, w:w + 1]
    offs = torch.arange(-L, L + 1, device=dev)
    ixr = torch.clamp(ur0[:, None, None, None] + offs[None, :, None, None]
                      + dx[None, None], 0, Wm - 1)        # [N,2L+1,P,P]
    pr = pyr_r[o3[:, None], iy[:, None], ixr]
    pr = pr - pr[:, :, w:w + 1, w:w + 1]
    sad = torch.abs(pl[:, None] - pr).sum(dim=(-2, -1))  # [N,2L+1]
    best = torch.argmin(sad, dim=1)
    d2 = sad.gather(1, best[:, None])[:, 0]
    interior = (best > 0) & (best < 2 * L)
    bi = torch.clamp(best, 1, 2 * L - 1)
    d1 = sad.gather(1, (bi - 1)[:, None])[:, 0]
    d3 = sad.gather(1, (bi + 1)[:, None])[:, 0]
    denom = d1 + d3 - 2.0 * d2
    delta = torch.where(torch.abs(denom) > 1e-9,
                        (d1 - d3) / (2.0 * torch.clamp(denom, min=1e-9)), 0.0)
    good = ok & inside & interior & (torch.abs(delta) <= 1.0) & (denom > 0)
    # add back the left center's sub-level offset (x - sf*ui): the SAD
    # localizes the match of the rounded level center
    u_r = (sf * (ur0.to(dtype) + (bi - L).to(dtype) + delta)
           + (xy_l[:, 0] - sf * ui.to(dtype)))
    return torch.where(good, u_r, u_r0), d2, good


def depth_from_disparity(disp, bf):
    """z = fx*b / d (bf = fx * baseline, the reference's Camera.bf)."""
    return torch.where(disp > 1e-3, bf / torch.clamp(disp, min=1e-3), -1.0)


def rgbd_to_stereo(xy, depth_map, bf, depth_factor: float = 1.0):
    """Per-feature depth lookup at the rounded pixel + the virtual right
    coordinate u_r = u - bf / z (ref Frame::ComputeStereoFromRGBD). Host
    numpy, as in tpuslam: xy [N,2], depth_map [H,W]. Returns (z, u_r)."""
    ui = np.clip(np.round(xy[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
    vi = np.clip(np.round(xy[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
    z = depth_map[vi, ui] * depth_factor
    u_r = np.where(z > 0, xy[:, 0] - bf / np.maximum(z, 1e-6), -1.0)
    return z, u_r
