"""A small PNG codec: zlib + numpy, the row unfilter in C++.

The dataset loaders read their images with it where tpuslam calls
`cv2.imread` (tpuslam/io/datasets.py:22-29, 48-54), so the port needs no
OpenCV. `read_png(path)` gives what `cv2.imread(path, IMREAD_GRAYSCALE)`
gives: 8-bit gray as stored, 16-bit samples cut to their high byte, colour
(RGB, RGBA, palette) to gray with libpng's fixed-point BT.601 weights and
alpha dropped. `read_png(path, gray=False)` gives `IMREAD_UNCHANGED`:
gray as stored (16-bit TUM depth stays uint16), colour in BGR(A) order.
Interlaced files and bit depths below 8 raise: they are not decoded.

The unfilter (Average and Paeth are sequential along a row) runs in the
native core (native/mapcore.cpp `png_unfilter`); `unfilter_plain` is the
numpy reference it is held against, and the path where g++ is missing.
`write_png` writes 8- or 16-bit gray, RGB or RGBA with any of the five
row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel by colour type: gray, RGB, palette, gray + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's rgb_to_gray weights for (0.299, 0.587), as OpenCV sets them:
# floor(w * 100000 * 32768 / 100000), blue the remainder of 32768
GRAY_R, GRAY_G = 9797, 19234
GRAY_B = 32768 - GRAY_R - GRAY_G


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct the [height, stride] u8 scanlines of inflated PNG data
    (each row a filter-type byte, then `stride` bytes; `bpp` bytes per
    pixel), in numpy: the plain reference of the native unfilter."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for r in range(height):
        ft, x = int(rows[r, 0]), rows[r, 1:].astype(np.int64)
        if ft == 0:
            cur = x
        elif ft == 1:       # Sub: a running sum per byte of the pixel
            cur = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ft == 2:       # Up
            cur = (x + prev) % 256
        elif ft in (3, 4):  # Average, Paeth: one pixel after the other
            cur = np.zeros(stride, np.int64)
            zero = np.zeros(bpp, np.int64)
            for i in range(0, stride, bpp):
                a = cur[i - bpp:i] if i else zero
                b = prev[i:i + bpp]
                pred = (a + b) // 2 if ft == 3 else _paeth(a, b, prev[i - bpp:i] if i else zero)
                cur[i:i + bpp] = (x[i:i + bpp] + pred) % 256
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {ft}")
        out[r] = prev = cur
    return out.astype(np.uint8)


def _unfilter(raw, height, stride, bpp):
    from .. import native

    if native.available():
        return native.png_unfilter(raw, height, stride, bpp)
    return unfilter_plain(raw, height, stride, bpp)


def _chunks(data: bytes, path):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _decode(data: bytes, path):
    """(samples [H, W, C] u8 or u16 in the file's channel order, colour
    type) of a PNG file's bytes; a palette image comes back as RGB."""
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if ctype not in CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} is not supported "
                         "(8- or 16-bit gray, gray + alpha, RGB, RGBA; 8-bit palette)")
    ch = CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, not {h * (w * bpp + 1)}")
    buf = _unfilter(raw, h, w * bpp, bpp)
    px = (buf.view(">u2").astype(np.uint16) if depth == 16 else buf).reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        px, ctype = palette[px[..., 0]], 2
    return px, ctype


def _to_gray(px, ctype):
    """cv2.IMREAD_GRAYSCALE of decoded samples: libpng's rgb_to_gray
    (truncating at 8 bits, rounding at 16) and its strip to the high byte."""
    if ctype in (0, 4):
        g = px[..., 0]
    else:
        rgb = px[..., :3].astype(np.int64)
        s = GRAY_R * rgb[..., 0] + GRAY_G * rgb[..., 1] + GRAY_B * rgb[..., 2]
        g = (s + (16384 if px.dtype == np.uint16 else 0)) >> 15
    if px.dtype == np.uint16:
        g = g >> 8
    return np.ascontiguousarray(g, np.uint8)


def read_png(path, gray: bool = True) -> np.ndarray:
    """cv2.imread(path, IMREAD_GRAYSCALE) (gray=True) or IMREAD_UNCHANGED
    (gray=False: [H, W] for gray, [H, W, 3|4] BGR(A) for colour, uint8 or
    uint16 as stored) of a PNG file. A missing file raises
    FileNotFoundError."""
    with open(path, "rb") as fh:
        px, ctype = _decode(fh.read(), path)
    if gray:
        return _to_gray(px, ctype)
    if ctype == 4:
        raise ValueError(f"{path}: gray + alpha is only read as gray")
    if ctype == 0:
        return px[..., 0]
    order = [2, 1, 0, 3][: px.shape[-1]]
    return np.ascontiguousarray(px[..., order])


def _filter_row(x, prev, ft, bpp):
    """Filter one row of raw bytes (int64) with type `ft` (PNG spec 9.2)."""
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][ft]
    return (x - pred) % 256


def write_png(path, img: np.ndarray, filters=0):
    """Write `img` ([H, W] gray or [H, W, 3|4] RGB(A), uint8 or uint16) as a
    PNG. `filters`: the row filter type (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth) for every row, or a sequence giving each row's."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    bpp = ch * img.dtype.itemsize
    data = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = data.view(np.uint8).reshape(h, w * bpp).astype(np.int64)
    fts = [filters] * h if np.isscalar(filters) else list(filters)
    out = np.empty((h, w * bpp + 1), np.uint8)
    prev = np.zeros(w * bpp, np.int64)
    for r in range(h):
        out[r, 0] = fts[r]
        out[r, 1:] = rows[r] if fts[r] == 0 else _filter_row(rows[r], prev, fts[r], bpp)
        prev = rows[r]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as fh:
        fh.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(out.tobytes())) + chunk(b"IEND", b""))
