"""Small tensor helpers of the port."""

from __future__ import annotations

import threading

import torch

# Every entry point of the port runs on the card unless its caller passes
# another device (the CPU tests pass device="cpu").
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device(device); a CUDA device on a machine without a card
    raises here instead of failing later or running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} needs a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def device_const(values, dtype, device):
    """A 1-D tensor of host values made on `device` by fill kernels, so no
    host-to-device copy (which synchronizes) runs inside a traced step."""
    cast = float if dtype.is_floating_point else int
    return torch.cat([torch.full((1,), cast(v), dtype=dtype, device=device)
                      for v in values])


# forward-mode AD keeps its dual levels in process-global state: jacfwd
# taken in two threads at once (the background GBA's and the tracker's
# solves) tears down each other's levels ("Trying to access a forward AD
# level with an invalid index")
_JACFWD_LOCK = threading.RLock()


def jacfwd(fn, argnums=0):
    """torch.func.jacfwd(fn, argnums), each evaluation under one
    process-wide lock, so any thread may take it."""
    inner = torch.func.jacfwd(fn, argnums=argnums)

    def call(*args, **kwargs):
        with _JACFWD_LOCK:
            return inner(*args, **kwargs)

    return call
