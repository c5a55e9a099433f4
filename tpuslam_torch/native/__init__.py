"""Native map-runtime bindings, ctypes over mapcore.cpp (port of
tpuslam/native, with its own copy of the C++ source), and the PNG row
unfilter that io/png.py's reader runs.

The library is compiled with g++ at first use into build/tpuslam_torch/
(rebuilt when the source is newer), written under a temporary name and
renamed into place, so concurrent processes never load a half-written
file. Where g++ is missing or the build fails, `load()` returns None and
the map store and the keyframe database keep their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "mapcore.cpp"
LIB = BUILD_DIR / "mapcore.so"

_lib = None
_failed = False


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The loaded core, or None where it cannot be built."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIB))
    except (OSError, subprocess.CalledProcessError):
        _failed = True
        return None
    i32 = ctypes.c_int32
    p_i32 = ctypes.POINTER(i32)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    lib.obs_new.restype = ctypes.c_void_p
    lib.obs_free.argtypes = [ctypes.c_void_p]
    lib.obs_add.restype = i32
    lib.obs_add.argtypes = [ctypes.c_void_p, i32, i32, i32]
    lib.obs_erase.restype = i32
    lib.obs_erase.argtypes = [ctypes.c_void_p, i32, i32]
    lib.obs_count.restype = i32
    lib.obs_count.argtypes = [ctypes.c_void_p, i32]
    lib.obs_get.restype = i32
    lib.obs_get.argtypes = [ctypes.c_void_p, i32, i32]
    lib.obs_items.restype = i32
    lib.obs_items.argtypes = [ctypes.c_void_p, i32, p_i32, p_i32, i32]
    lib.obs_clear_mp.restype = i32
    lib.obs_clear_mp.argtypes = [ctypes.c_void_p, i32, p_i32, p_i32, i32]
    lib.covis_count.restype = i32
    lib.covis_count.argtypes = [ctypes.c_void_p, i32, p_i32, i32, p_i32,
                                p_i32, i32]
    lib.redundancy_count.restype = i32
    lib.redundancy_count.argtypes = [ctypes.c_void_p, i32, p_i32, i32, p_i8,
                                     i32, i32]
    p_f32 = ctypes.POINTER(ctypes.c_float)
    lib.inv_new.restype = ctypes.c_void_p
    lib.inv_new.argtypes = [i32]
    lib.inv_free.argtypes = [ctypes.c_void_p]
    lib.inv_add.argtypes = [ctypes.c_void_p, i32, p_i32, p_f32, i32]
    lib.inv_erase.restype = i32
    lib.inv_erase.argtypes = [ctypes.c_void_p, i32]
    lib.inv_shared.restype = i32
    lib.inv_shared.argtypes = [ctypes.c_void_p, p_i32, i32, p_i32, i32,
                               p_i32, p_i32, i32]
    lib.inv_score.restype = ctypes.c_float
    lib.inv_score.argtypes = [ctypes.c_void_p, i32, p_i32, p_f32, i32]
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.png_unfilter.restype = i32
    lib.png_unfilter.argtypes = [p_u8, p_u8, i32, ctypes.c_int64, i32]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct PNG scanlines: `raw` is the inflated image data (each
    row a filter-type byte and `stride` bytes). Returns [height, stride]
    u8. Raises RuntimeError where the core cannot be built and ValueError
    on an unknown filter type."""
    lib = load()
    if lib is None:
        raise RuntimeError("native mapcore unavailable")
    src = np.frombuffer(raw, np.uint8)
    if height < 0 or stride < 0 or bpp < 1 or src.size != height * (stride + 1):
        raise ValueError(f"{src.size} bytes are not {height} rows of 1 + {stride} bytes")
    dst = np.empty((height, stride), np.uint8)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.png_unfilter(src.ctypes.data_as(p_u8), dst.ctypes.data_as(p_u8), height, stride,
                          bpp)
    if rc < 0:
        raise ValueError(f"PNG row {-rc - 1}: unknown filter type {src[(-rc - 1) * (stride + 1)]}")
    return dst


class NativeObsIndex:
    """mp <-> (kf, slot) inverse index backed by the C++ core. API mirrors
    the dict-of-dicts layout the Python fallback uses."""

    CAP = 4096

    def __init__(self):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native mapcore unavailable")
        self.h = ctypes.c_void_p(self.lib.obs_new())
        self._buf_kf = np.empty(self.CAP, np.int32)
        self._buf_slot = np.empty(self.CAP, np.int32)

    def __del__(self):
        if getattr(self, "h", None) and self.lib is not None:
            self.lib.obs_free(self.h)
            self.h = None

    def _p(self, arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def add(self, mp: int, kf: int, slot: int) -> int:
        return self.lib.obs_add(self.h, mp, kf, slot)

    def erase(self, mp: int, kf: int) -> int:
        return self.lib.obs_erase(self.h, mp, kf)

    def count(self, mp: int) -> int:
        return self.lib.obs_count(self.h, mp)

    def get(self, mp: int, kf: int) -> int:
        return self.lib.obs_get(self.h, mp, kf)

    def items(self, mp: int):
        n = self.lib.obs_items(self.h, mp, self._p(self._buf_kf),
                               self._p(self._buf_slot), self.CAP)
        return self._buf_kf[:n].copy(), self._buf_slot[:n].copy()

    def clear_mp(self, mp: int):
        n = self.lib.obs_clear_mp(self.h, mp, self._p(self._buf_kf),
                                  self._p(self._buf_slot), self.CAP)
        return self._buf_kf[:n].copy(), self._buf_slot[:n].copy()

    def covis_counts(self, kf: int, kf_mp_row: np.ndarray):
        row = np.ascontiguousarray(kf_mp_row, np.int32)
        n = self.lib.covis_count(self.h, kf, self._p(row), len(row),
                                 self._p(self._buf_kf),
                                 self._p(self._buf_slot), self.CAP)
        return self._buf_kf[:n].copy(), self._buf_slot[:n].copy()

    def redundancy(self, kf: int, kf_mp_row: np.ndarray,
                   kf_octaves: np.ndarray, min_obs: int = 3) -> int:
        row = np.ascontiguousarray(kf_mp_row, np.int32)
        oc = np.ascontiguousarray(kf_octaves, np.int8)
        return self.lib.redundancy_count(
            self.h, kf, self._p(row), len(row),
            oc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            oc.shape[1], min_obs)


class NativeInvIndex:
    """Inverted BoW index backed by the C++ core (ref: KeyFrameDatabase's
    mvInvertedFile + DBoW2 L1 scoring). API mirrors the Python fallback in
    place/kfdb.py."""

    CAP = 8192

    def __init__(self, n_words: int):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native mapcore unavailable")
        self.h = ctypes.c_void_p(self.lib.inv_new(n_words))
        self._buf_kf = np.empty(self.CAP, np.int32)
        self._buf_ct = np.empty(self.CAP, np.int32)

    def __del__(self):
        if getattr(self, "h", None) and self.lib is not None:
            self.lib.inv_free(self.h)
            self.h = None

    @staticmethod
    def _pi(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    @staticmethod
    def _pf(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def add(self, kf: int, words: np.ndarray, weights: np.ndarray):
        w = np.ascontiguousarray(words, np.int32)
        v = np.ascontiguousarray(weights, np.float32)
        self.lib.inv_add(self.h, kf, self._pi(w), self._pf(v), len(w))

    def erase(self, kf: int) -> bool:
        return bool(self.lib.inv_erase(self.h, kf))

    def shared(self, qwords: np.ndarray, exclude: np.ndarray):
        """Returns (kfs [m], counts [m]) of KFs sharing >=1 query word."""
        q = np.ascontiguousarray(qwords, np.int32)
        x = np.ascontiguousarray(np.sort(np.asarray(exclude, np.int32)))
        n = self.lib.inv_shared(self.h, self._pi(q), len(q), self._pi(x),
                                len(x), self._pi(self._buf_kf),
                                self._pi(self._buf_ct), self.CAP)
        return self._buf_kf[:n].copy(), self._buf_ct[:n].copy()

    def score(self, kf: int, qwords: np.ndarray, qweights: np.ndarray):
        q = np.ascontiguousarray(qwords, np.int32)
        v = np.ascontiguousarray(qweights, np.float32)
        return float(self.lib.inv_score(self.h, kf, self._pi(q),
                                        self._pf(v), len(q)))
