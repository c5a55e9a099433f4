"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc, at first use, into ONE shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/tpuslam_torch/libtpuslam_kernels.so csrc/*.cu

No --use_fast_math: approximate sqrt/rsqrt/sin/cos change the pose LM's
accept decisions. The library is rebuilt when a source is newer than it
(the rule of tpuslam/native). Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "csrc"
BUILD_DIR = ROOT.parent / "build" / "tpuslam_torch"
LIB = BUILD_DIR / "libtpuslam_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    "patch_gather": [_P, _I, _I, _P, _I, _I, _P, _P],
    "pose_lm": [_P, _P, _P, _P, _P, _I, _P, _P, _F, _F, _F, _F, _F, _F, _F,
                _I, _I, _P, _P, _P, _P, _P],
}

_lib = None
build_seconds = None  # wall time of the last build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (looked at $NVCC, PATH, /usr/local/cuda/bin)")


def _stale(sources) -> bool:
    if not LIB.exists():
        return True
    built = LIB.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into LIB if it is missing or older than a source.
    The library is written under a temporary name and renamed into place,
    so concurrent builders never load a half-written file."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not _stale(sources + headers):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, LIB)
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


class LaunchCounter:
    """Plain-integer count of a kernel's launches (one per wrapper call
    that launches it)."""

    def __init__(self):
        self.launches = 0


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
