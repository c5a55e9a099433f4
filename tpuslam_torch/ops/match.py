"""Masked nearest-neighbour descriptor matching (port of the parts of
tpuslam/ops/match.py that the fused tracking step uses).

Every ORBmatcher strategy (src/ORBmatcher.cc) is a candidate MASK on the
Hamming matrix plus its gates (TH_LOW/TH_HIGH, ratio test, rotation
histogram). Constants mirror ORBmatcher.cc:40-42.
"""

from __future__ import annotations

import numpy as np
import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20  # "infinite" hamming distance


def _top_k_stable(x, k: int):
    """(values, indices) of the k largest, ties to the lower index (the tie
    rule of lax.top_k)."""
    idx = torch.sort(-x, stable=True).indices[:k]
    return x[idx], idx


def masked_best2(dist, mask):
    """dist [N,M] int32, mask [N,M] bool (True = allowed) ->
    (best_idx [N], best [N], second [N]): plain top-2 per row."""
    idx, best, _, second = masked_best2_idx(dist, mask)
    return idx, best, second


def masked_best2_idx(dist, mask):
    """Like masked_best2 but also returns the second-best index (for the
    same-octave ratio test, ORBmatcher.cc:130). argmin takes the first
    minimum, as jnp.argmin does."""
    d = torch.where(mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = d.gather(1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], BIG)
    second_idx = torch.argmin(d2, dim=1)
    second = d2.gather(1, second_idx[:, None])[:, 0]
    return best_idx.to(torch.int32), best, second_idx.to(torch.int32), second


def rotation_consistency(ang_a, ang_b_of_match, valid):
    """Keep only matches whose angle difference falls in the 3 most common
    of 30 bins (ref: ORBmatcher ComputeThreeMaxima + rotHist usage)."""
    two_pi = 2.0 * np.pi
    diff = torch.remainder(ang_a - ang_b_of_match, two_pi)
    bins = torch.clamp((diff * (HISTO_LENGTH / two_pi)).to(torch.int64), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=valid.device)
    hist = hist.index_add(0, bins, valid.to(torch.int32))
    counts, idxs = _top_k_stable(hist, 3)
    # reference drops bins 2,3 if < 0.1 * bin 1 (ComputeThreeMaxima)
    top = counts.float() >= 0.1 * counts[0].float()
    keep = torch.cat([torch.ones_like(top[:1]), top[1:]])
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=valid.device)
    keep_bin = keep_bin.scatter(0, idxs, keep)
    return valid & keep_bin[bins]


def resolve_duplicates(match_idx, best, valid, m_size: int):
    """Enforce one-to-one: if several rows matched the same column, keep the
    lowest distance, then the first row (ref: ORBmatcher.cc:477)."""
    col = torch.where(valid, match_idx.long(), m_size)
    col_best = torch.full((m_size + 1,), BIG, dtype=best.dtype, device=best.device)
    col_best = col_best.scatter_reduce(0, col, best, reduce="amin", include_self=True)
    is_winner = valid & (best <= col_best[col])
    row_ids = torch.arange(match_idx.shape[0], dtype=torch.int32, device=best.device)
    no_row = torch.full_like(row_ids, 1 << 30)
    col_winner_row = torch.full((m_size + 1,), 1 << 30, dtype=torch.int32,
                                device=best.device)
    col_winner_row = col_winner_row.scatter_reduce(
        0, torch.where(is_winner, col, m_size), torch.where(is_winner, row_ids, no_row),
        reduce="amin", include_self=True)
    final = is_winner & (col_winner_row[col] == row_ids)
    return torch.where(final, match_idx, -1), final


def window_mask(xy_a_pred, xy_b, radius):
    """|proj(a) - kp_b|_inf within radius. xy_a_pred [N,2], xy_b [M,2],
    radius scalar or [N] -> [N,M]."""
    r = radius[:, None] if torch.is_tensor(radius) and radius.dim() == 1 else radius
    dx = torch.abs(xy_a_pred[:, None, 0] - xy_b[None, :, 0])
    dy = torch.abs(xy_a_pred[:, None, 1] - xy_b[None, :, 1])
    return (dx <= r) & (dy <= r)


def level_mask(pred_level, octave_b, lo_off: int = 0, hi_off: int = 1):
    """Scale gate: octave_b in [pred-lo_off, pred+hi_off]
    (ref: SearchByProjection nPredictedLevel gating ORBmatcher.cc:90-95)."""
    pl = pred_level[:, None]
    ob = octave_b[None, :]
    return (ob >= pl - lo_off) & (ob <= pl + hi_off)
