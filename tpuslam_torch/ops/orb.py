"""ORB feature extraction: pyramid FAST + oriented BRIEF, fully batched
(port of tpuslam/ops/orb.py; ref: src/ORBextractor.cc).

  - 8-level pyramid, scale 1.2 (ComputePyramid, :1152)
  - per-cell FAST with ini/min thresholds (ComputeKeyPointsOctTree, :763)
  - per-cell top-1 + per-level top-K by response in place of the quadtree
  - intensity-centroid orientation (IC_Angle, :75) on the blurred level
  - rBRIEF 256-pair descriptors through a quantized-rotation LUT matmul

The constants (PATTERN, the descriptor LUT, the IC masks) are made by the
same numpy code as the JAX module, so they are bitwise equal to it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.config import OrbConfig
from .fast import _border_mask, cell_threshold_gate, fast_score, nms3x3
from .image import build_pyramid, gaussian_blur, gaussian_kernel1d
from .patch_cuda import extract_patches_levels

HALF_PATCH = 15  # IC-angle circular patch radius (ref: ORBextractor.cc:70 PATCH_SIZE 31)
DESC_R = 18      # descriptor patch radius: 13*sqrt(2) ~ 18.4 rounded in
PAD = DESC_R + 1
N_ANGLE_BINS = 32


def _make_pattern(seed: int = 42, n_bits: int = 256, sigma: float = 6.2):
    """Deterministic BRIEF pattern: [n_bits, 2, 2] int32 (pairs of (dx,dy)),
    Gaussian, clipped to radius 13 so any rotation stays in the patch."""
    rs = np.random.RandomState(seed)
    return np.clip(np.round(rs.randn(n_bits, 2, 2) * sigma), -13, 13).astype(np.int32)


PATTERN = _make_pattern()


def _make_desc_lut() -> np.ndarray:
    """[side^2, B*256] per-rotation-bin sampling matrices with bilinear
    sub-pixel taps (+v1 - v0 of each pair), so the sampling is continuous
    in the rotation angle."""
    side = 2 * DESC_R + 1
    B = N_ANGLE_BINS
    lut = np.zeros((side * side, B * 256), np.float32)
    for b in range(B):
        ang = 2.0 * np.pi * b / B
        c, s = np.cos(ang), np.sin(ang)
        rx = PATTERN[..., 0] * c - PATTERN[..., 1] * s     # [256, 2] float
        ry = PATTERN[..., 0] * s + PATTERN[..., 1] * c
        cols = b * 256 + np.arange(256)
        for pt, sign in ((1, 1.0), (0, -1.0)):             # + v1, - v0
            x = rx[:, pt] + DESC_R
            y = ry[:, pt] + DESC_R
            x0 = np.floor(x).astype(int)
            y0 = np.floor(y).astype(int)
            fx_ = x - x0
            fy_ = y - y0
            for dy, dx, w in (
                (0, 0, (1 - fy_) * (1 - fx_)),
                (0, 1, (1 - fy_) * fx_),
                (1, 0, fy_ * (1 - fx_)),
                (1, 1, fy_ * fx_),
            ):
                flat = (y0 + dy) * side + (x0 + dx)
                np.add.at(lut, (flat, cols), sign * w)
    return lut


_DESC_LUT = _make_desc_lut()

# circular mask and coordinate grids for the IC angle
_yy, _xx = np.mgrid[-HALF_PATCH : HALF_PATCH + 1, -HALF_PATCH : HALF_PATCH + 1]
_CIRC_MASK = (_xx ** 2 + _yy ** 2 <= HALF_PATCH ** 2).astype(np.float32)
_IC_X = (_xx * _CIRC_MASK).astype(np.float32)
_IC_Y = (_yy * _CIRC_MASK).astype(np.float32)


def _select_level_keypoints(score, budget: int, cell: int):
    """Per-cell top-1 then top-`budget` by response -> (xy [K,2] i32,
    resp [K]); resp == 0 marks an invalid slot. Ties go to the lower cell
    index, as lax.top_k breaks them (a stable sort; torch.topk does not)."""
    h, w = score.shape
    ph, pw = (-h) % cell, (-w) % cell
    sp = F.pad(score, (0, pw, 0, ph))
    hc, wc = (h + ph) // cell, (w + pw) // cell
    cells = sp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    cmax, carg = cells.max(dim=1)
    carg = carg.to(torch.int32)
    cid = torch.arange(hc * wc, dtype=torch.int32, device=score.device)
    cy = carg // cell + (cid // wc) * cell
    cx = carg % cell + (cid % wc) * cell
    k = min(budget, hc * wc)
    order = torch.sort(-cmax, stable=True).indices[:k]
    top = cmax[order]
    xy = torch.stack([cx[order], cy[order]], dim=-1)
    resp = torch.where(top > 0, top, 0.0)
    if k < budget:  # pad to the static budget
        xy = F.pad(xy, (0, 0, 0, budget - k))
        resp = F.pad(resp, (0, budget - k))
    return xy, resp


def _ic_angles_from_patches(p37, ic_x, ic_y):
    """Intensity-centroid angle (rad) from [K,37,37] patches, f32 sums
    (ref: ORBextractor.cc:75 IC_Angle)."""
    off = DESC_R - HALF_PATCH
    n = 2 * HALF_PATCH + 1
    inner = p37[:, off:off + n, off:off + n]
    m10 = (inner * ic_x).sum(dim=(1, 2))
    m01 = (inner * ic_y).sum(dim=(1, 2))
    return torch.atan2(m01, m10)


def _descriptors_from_patches(patches, angles, lut):
    """rBRIEF bits [K,256] uint8 via the quantized-rotation LUT matmul.

    lut is the bf16-rounded descriptor LUT held in f32. The JAX version
    rounds patches and LUT to bf16 and accumulates in f32; an f32 matmul
    of the rounded values (TF32 off) does the same. The keypoint's diff is
    interpolated between its two neighbouring rotation bins."""
    B = N_ANGLE_BINS
    diff = patches.to(torch.bfloat16).float() @ lut          # [K, B*256]
    diff = diff.reshape(-1, B, 256)
    a = angles / (2.0 * np.pi / B)
    b0 = torch.floor(a)
    frac = (a - b0)[:, None]
    b0 = torch.remainder(b0.to(torch.int64), B)
    b1 = torch.remainder(b0 + 1, B)
    d0 = diff.gather(1, b0[:, None, None].expand(-1, 1, 256))[:, 0]
    d1 = diff.gather(1, b1[:, None, None].expand(-1, 1, 256))[:, 0]
    sel = (1.0 - frac) * d0 + frac * d1
    return (sel > 0).to(torch.uint8)


def pack_bits(bits):
    """[...,256] {0,1} -> [...,8] uint32 (little-endian within each word)."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (8, 32))
    pows = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    return (b * pows).sum(dim=-1).to(torch.uint32)


class OrbExtractor(nn.Module):
    """ORB extraction for one config. Buffers: the Gaussian taps, the IC
    masks and the bf16-rounded descriptor LUT.

    forward(img [H,W], ini_th=None, min_th=None) -> dict: xy [N,2] f32
    level-0 pixel coords; resp [N]; angle [N] rad; octave [N] i32; size [N];
    valid [N] bool; bits [N,256] u8; packed [N,8] u32.  N == cfg.n_features.
    The FAST thresholds default to the config's.
    """

    def __init__(self, cfg: OrbConfig, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device)
        self.register_buffer("gauss_taps", torch.tensor(gaussian_kernel1d(), **kw))
        self.register_buffer("ic_x", torch.tensor(_IC_X, **kw))
        self.register_buffer("ic_y", torch.tensor(_IC_Y, **kw))
        self.register_buffer("desc_lut", torch.tensor(_DESC_LUT, **kw).to(
            torch.bfloat16).float())

    def forward(self, img, ini_th=None, min_th=None):
        cfg = self.cfg
        ini_th = float(cfg.ini_th if ini_th is None else ini_th)
        min_th = float(cfg.min_th if min_th is None else min_th)
        levels = build_pyramid(img.float(), cfg.n_levels, cfg.scale)
        budgets = cfg.level_budgets()
        out = {"xy": [], "resp": [], "octave": [], "size": []}
        padded, corners = [], []
        # per level: FAST, cell gate, NMS, selection, blur and pad
        for l, (im, budget, sc) in enumerate(zip(levels, budgets, cfg.level_scales())):
            score = fast_score(im)
            score = cell_threshold_gate(score, ini_th, min_th, cell=cfg.th_cell)
            score = nms3x3(score)
            # keep keypoints whose descriptor patch fits (margin 16)
            h, w = im.shape
            score = torch.where(_border_mask(h, w, HALF_PATCH + 1, im.device), score, 0.0)
            xy, resp = _select_level_keypoints(score, budget, cfg.cell)
            blur = gaussian_blur(im, self.gauss_taps)
            padded.append(F.pad(blur[None, None], (PAD,) * 4, mode="replicate")[0, 0])
            corners.append(torch.stack([xy[:, 1], xy[:, 0]], dim=-1) + (PAD - DESC_R))
            out["xy"].append(xy.float() * sc)
            out["resp"].append(resp)
            out["octave"].append(torch.full((budget,), l, dtype=torch.int32,
                                            device=img.device))
            out["size"].append(torch.full((budget,), 31.0 * sc, dtype=torch.float32,
                                          device=img.device))
        # then every level's [K, 37, 37] descriptor-radius patches (the 31x31
        # IC-angle window sits at offset +3 inside) in one patch gather, one
        # IC-angle pass and one LUT matmul over all keypoints
        p37 = extract_patches_levels(padded, torch.cat(corners, dim=0).contiguous(), budgets,
                                     2 * DESC_R + 1)
        res = {"xy": torch.cat(out["xy"], dim=0), "resp": torch.cat(out["resp"], dim=0),
               "angle": _ic_angles_from_patches(p37, self.ic_x, self.ic_y)}
        res["octave"] = torch.cat(out["octave"], dim=0)
        res["size"] = torch.cat(out["size"], dim=0)
        res["bits"] = _descriptors_from_patches(p37.reshape(p37.shape[0], -1),
                                                res["angle"], self.desc_lut)
        res["valid"] = res["resp"] > 0
        res["packed"] = pack_bits(res["bits"])
        return res

    def extract_pair(self, img_l, img_r, ini_th=None, min_th=None):
        """Both images of a stereo pair (tpuslam's batched call): (out_l,
        out_r) with the fields of forward, one patch-gather launch each."""
        return self(img_l, ini_th, min_th), self(img_r, ini_th, min_th)
