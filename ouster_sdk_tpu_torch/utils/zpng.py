"""zPNG codec: zstd-compressed delta-filtered images (OSF alternative codec).

Rebuild of the zPNG format used by the reference's ZPngLidarScanEncoder
(ref: ouster_osf/src/zpng_lidarscan_encoder.cpp:30-95,
thirdparty/zpng/zpng.cpp): 8-byte header {u16 magic 0xFBF8, u16 width,
u16 height, u8 channels, u8 bytes_per_channel} + zstd frame of the filtered
pixels. Filtering is a per-row left-delta per byte-lane; 3- and 4-byte
pixels additionally apply the BCIF "GB-RG" color transform and split into
planes. dtype mapping: u8 -> 1x1, u16 -> 1x2, u32 -> 4x1, u64 -> 4x2.

zstd comes from the system libzstd via ctypes (the zstandard package is not
a dependency); a missing libzstd raises when the codec is first used. The
filters are vectorized numpy (cumsum for the sequential left-delta chains).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional

import numpy as np

MAGIC = 0xFBF8
HEADER = struct.Struct("<HHHBB")

_zstd: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _zstd
    if _zstd is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_void_p, ctypes.c_size_t,
                                      ctypes.c_int]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        _zstd = lib
    return _zstd


def zstd_compress(data: bytes, level: int = 1) -> bytes:
    lib = _lib()
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(out, bound, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise RuntimeError("zstd compression failed")
    return out.raw[:n]


def zstd_decompress(data: bytes, out_size: int) -> bytes:
    lib = _lib()
    out = ctypes.create_string_buffer(out_size)
    n = lib.ZSTD_decompress(out, out_size, data, len(data))
    if lib.ZSTD_isError(n):
        raise RuntimeError("zstd decompression failed")
    return out.raw[:n]


def is_zpng(data: bytes) -> bool:
    return len(data) >= 8 and \
        struct.unpack_from("<H", data, 0)[0] == MAGIC


def _color_pack(px: np.ndarray) -> np.ndarray:
    """GB-RG transform + plane split of delta pixels (h, w, c>=3)."""
    r, g, bch = px[..., 0], px[..., 1], px[..., 2]
    y = bch
    u = g - bch
    v = g - r
    planes = [y, u, v]
    if px.shape[-1] == 4:
        planes.append(px[..., 3])
    return np.stack([p.reshape(-1) for p in planes])  # (c, h*w)


def _color_unpack(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of _color_pack -> (h, w, c) delta pixels."""
    c = planes.shape[0]
    y, u, v = planes[0], planes[1], planes[2]
    B = y
    G = (u + B).astype(np.uint8)
    R = (G - v).astype(np.uint8)
    chans = [R, G, B]
    if c == 4:
        chans.append(planes[3])
    return np.stack(chans, axis=-1).reshape(h, w, c)


def _row_delta(img: np.ndarray) -> np.ndarray:
    """Left-delta per row per byte-lane: out[:, 0] = in[:, 0],
    out[:, x] = in[:, x] - in[:, x-1]."""
    out = img.copy()
    out[:, 1:] = img[:, 1:] - img[:, :-1]
    return out


def _row_undelta(img: np.ndarray) -> np.ndarray:
    """Inverse: cumulative sum along rows mod 256."""
    return np.cumsum(img.astype(np.int64), axis=1).astype(np.uint8)


def encode(img2d: np.ndarray, level: int = 1) -> bytes:
    """Encode a 2-D unsigned image with the OSF dtype->zPNG mapping."""
    dt = img2d.dtype
    h, w = img2d.shape
    if dt == np.uint8:
        channels, bpc = 1, 1
    elif dt == np.uint16:
        channels, bpc = 1, 2
    elif dt == np.uint32:
        channels, bpc = 4, 1
    elif dt == np.uint64:
        channels, bpc = 4, 2
    else:
        raise ValueError(f"unsupported zpng dtype {dt}")
    pixel_bytes = channels * bpc
    raw = np.ascontiguousarray(img2d).view(np.uint8).reshape(
        h, w, pixel_bytes)

    deltas = _row_delta(raw)
    if pixel_bytes in (3, 4):
        packed = _color_pack(deltas).tobytes()
    else:
        packed = deltas.tobytes()

    payload = zstd_compress(packed, level)
    return HEADER.pack(MAGIC, w, h, channels, bpc) + payload


def decode(data: bytes) -> np.ndarray:
    """Decode a zPNG buffer to a 2-D unsigned image."""
    magic, w, h, channels, bpc = HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not a zPNG buffer")
    pixel_bytes = channels * bpc
    n = h * w * pixel_bytes
    packed = np.frombuffer(zstd_decompress(data[8:], n), np.uint8)

    if pixel_bytes in (3, 4):
        planes = packed.reshape(pixel_bytes, h * w)
        deltas = _color_unpack(planes, h, w)
    else:
        deltas = packed.reshape(h, w, pixel_bytes)
    raw = _row_undelta(deltas)

    out_dtype = {(1, 1): np.uint8, (1, 2): np.uint16, (4, 1): np.uint32,
                 (4, 2): np.uint64}.get((channels, bpc))
    if out_dtype is None:
        # generic pixel: return bytes image
        return raw.reshape(h, w * pixel_bytes)
    return np.ascontiguousarray(raw).view(out_dtype).reshape(h, w)
