"""Hamming distances of 256-bit ORB descriptors
(port of tpuslam/ops/hamming.py; ref: src/ORBmatcher.cc:2353).

With descriptors as {0,1} vectors, popcount(a XOR b) = sum(a) + sum(b) - 2 a.b,
so a whole N x M distance matrix is one matmul; in f32 it is exact for
0/1 values up to 256 (TF32 must be off on the card).
"""

from __future__ import annotations

import torch


def hamming_matrix(bits_a, bits_b):
    """bits_[ab]: [N,256]/[M,256] {0,1} (any int dtype) -> [N,M] int32."""
    a = bits_a.float()
    b = bits_b.float()
    dots = a @ b.T
    return (a.sum(dim=-1)[:, None] + b.sum(dim=-1)[None, :] - 2.0 * dots).to(torch.int32)


def popcount_u32(x):
    """Bit-twiddling popcount of 32-bit words held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_packed(pa, pb):
    """pa [N,8] u32, pb [M,8] u32 -> [N,M] int32 via XOR + popcount."""
    x = pa.to(torch.int64)[:, None, :] ^ pb.to(torch.int64)[None, :, :]
    return popcount_u32(x).sum(dim=-1, dtype=torch.int32)


def hamming_pairs(bits_a, bits_b):
    """Rowwise distance of aligned pairs: [N,256], [N,256] -> [N] int32."""
    return (bits_a != bits_b).sum(dim=-1, dtype=torch.int32)
