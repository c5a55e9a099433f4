"""Small tensor helpers of the port."""

from __future__ import annotations

import torch


def device_const(values, dtype, device):
    """A 1-D tensor of host values made on `device` by fill kernels, so no
    host-to-device copy (which synchronizes) runs inside a traced step."""
    cast = float if dtype.is_floating_point else int
    return torch.cat([torch.full((1,), cast(v), dtype=dtype, device=device)
                      for v in values])
