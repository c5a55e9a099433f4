"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by its own nvcc, all started together, and
the objects are linked, at first use, into ONE shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o <name>.o          # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         build/tpuslam_torch/libtpuslam_kernels.so *.o

No --use_fast_math: approximate sqrt/rsqrt/sin/cos change the pose LM's
accept decisions. The library is rebuilt when a source is newer than it
(the rule of tpuslam/native). Nothing is built at import time. ptxas's
report (registers, stack frame and spills of every kernel) is kept in
`build_log`.
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
MAX_LEVELS = 16  # csrc/patch.cu


class PatchLevels(ctypes.Structure):
    """csrc/patch.cu's by-value parameter block: the levels of one image."""

    _fields_ = [("img", _P * MAX_LEVELS),
                ("H", _I * MAX_LEVELS),
                ("W", _I * MAX_LEVELS),
                ("start", _I * (MAX_LEVELS + 1)),  # prefix offsets of the counts
                ("n_levels", _I)]


# C entry points: name -> argtypes (every pointer and the stream as void*)
SIGNATURES = {
    "patch_gather_levels": [PatchLevels, _P, _I, _P, _P],
    "pose_lm": [_P, _P, _P, _P, _P, _I, _P, _P, _F, _F, _F, _F, _F, _F, _F,
                _I, _I, _P, _P, _P, _P, _P],
}

_lib = None
build_seconds = None  # wall time of the last build in this process
build_log = ""        # ptxas -v output of the last build in this process


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
    """Compile csrc/*.cu into LIB if it is missing or older than a source:
    one nvcc per source, all running at once, then one link. Everything is
    written under temporary names and the library renamed into place, so
    concurrent builders never load a half-written file."""
    global build_seconds, build_log
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    if not _stale(sources + headers):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc = _nvcc()
        objs = [Path(tmpdir) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                                   "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            logs.append(f"== {src.name}\n{err.strip()}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = Path(tmpdir) / LIB.name
        res = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, LIB)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if verbose:
        print(build_log)
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
