"""PNG encode/decode on numpy + zlib — the OSF field codec.

The reference encodes every >=2-D scan field as a PNG image inside the OSF
container (ref: ouster_osf/src/png_lidarscan_encoder.cpp,
png_tools.cpp): GRAY for 8/16-bit elements, RGB for 24-bit, RGBA for
32/64-bit, multi-byte samples little-endian across channels and 16-bit
sample depth byte-swapped to PNG big-endian. This module implements exactly
that subset (critical chunks, no interlace) without libpng.

Decode handles all five scanline filters; encode uses filter 0 + zlib,
which every PNG reader (incl. libpng in the reference) accepts.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from . import native, profiling

_SIG = b"\x89PNG\r\n\x1a\n"

COLOR_GRAY = 0
COLOR_RGB = 2
COLOR_RGBA = 6

_CHANNELS = {COLOR_GRAY: 1, COLOR_RGB: 3, COLOR_RGBA: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode(img: np.ndarray, color_type: int, sample_depth: int,
           compression_level: int = 1) -> bytes:
    """img: (h, w) for GRAY or (h, w, c) uint8/uint16 samples (native
    endianness)."""
    h, w = img.shape[:2]
    ch = _CHANNELS[color_type]
    if sample_depth == 8:
        raw = img.astype(np.uint8).reshape(h, w * ch)
    else:
        raw = img.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw], axis=1)  # filter byte 0 per row
    idat = zlib.compress(rows.tobytes(), compression_level)
    ihdr = struct.pack(">IIBBBBB", w, h, sample_depth, color_type, 0, 0, 0)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + \
        _chunk(b"IEND", b"")


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-scanline filtering. data: (h, 1+stride) uint8.

    The native library's loop (Paeth and Average carry sequential
    dependencies that defeat numpy); the numpy version where the library
    is not built (no g++)."""
    out = native.png_unfilter(data, h, stride, bpp)
    return _unfilter_py(data, h, stride, bpp) if out is None else out


def _unfilter_py(data: np.ndarray, h: int, stride: int,
                 bpp: int) -> np.ndarray:
    """The numpy unfilter: the route without the native library, and
    the reference its tests hold the library against."""
    filters = data[:, 0]
    rows = data[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)

    for y in range(h):
        f = filters[y]
        cur = rows[y]
        if f == 0:
            rec = cur
        elif f == 2:  # Up
            rec = (cur + prev) & 0xFF
        elif f == 1:  # Sub: cumulative by bpp lanes
            lanes = cur.reshape(-1, bpp) if stride % bpp == 0 else None
            if lanes is not None:
                rec = np.cumsum(lanes, axis=0, dtype=np.int64).astype(
                    np.int32).reshape(stride) & 0xFF
            else:  # fallback scalar
                rec = cur.copy()
                for i in range(bpp, stride):
                    rec[i] = (rec[i] + rec[i - bpp]) & 0xFF
        elif f == 3:  # Average
            rec = np.empty(stride, dtype=np.int32)
            for i in range(stride):
                left = rec[i - bpp] if i >= bpp else 0
                rec[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif f == 4:  # Paeth
            rec = np.empty(stride, dtype=np.int32)
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                if pa <= pb and pa <= pc:
                    pred = a
                elif pb <= pc:
                    pred = b
                else:
                    pred = c
                rec[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {f}")
        out[y] = rec.astype(np.uint8)
        prev = rec

    return out


def decode(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a PNG to ((h, w) or (h, w, ch) array, color_type,
    sample_depth). 16-bit samples are returned native-endian."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    width = height = depth = ctype = None
    idat = bytearray()
    while pos + 8 <= len(data):
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, depth, ctype, comp, filt, interlace = \
                struct.unpack(">IIBBBBB", body)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat.extend(body)
        elif tag == b"IEND":
            break
    if width is None:
        raise ValueError("missing IHDR")
    ch = _CHANNELS[ctype]
    bytes_per_sample = depth // 8
    bpp = ch * bytes_per_sample
    stride = width * bpp
    with profiling.span("png.inflate"):
        raw = zlib.decompress(bytes(idat))
    arr = np.frombuffer(raw, dtype=np.uint8)
    if arr.size != height * (stride + 1):
        raise ValueError("bad PNG payload size")
    recon = _unfilter(arr.reshape(height, stride + 1), height, stride, bpp)
    if depth == 8:
        img = recon.reshape(height, width, ch)
    else:
        img = recon.reshape(height, width, ch, 2).copy().view(">u2")
        img = img.astype(np.uint16).reshape(height, width, ch)
    if ch == 1:
        img = img.reshape(height, width)
    return img, ctype, depth


# ---------------------------------------------------------------------------
# OSF field codec on top of PNG (byte layout per png_lidarscan_encoder.cpp)
# ---------------------------------------------------------------------------

def encode_field_png(img2d: np.ndarray, compression_level: int = 1) -> bytes:
    """Encode a 2-D unsigned image with the reference's dtype->PNG mapping."""
    dt = img2d.dtype
    if dt == np.uint8:
        return encode(img2d, COLOR_GRAY, 8, compression_level)
    if dt == np.uint16:
        return encode(img2d, COLOR_GRAY, 16, compression_level)
    if dt == np.uint32:
        h, w = img2d.shape
        rgba = img2d.copy().view(np.uint8).reshape(h, w, 4)  # LE bytes
        return encode(rgba, COLOR_RGBA, 8, compression_level)
    if dt == np.uint64:
        h, w = img2d.shape
        rgba16 = img2d.copy().view(np.uint16).reshape(h, w, 4)  # LE u16s
        return encode(rgba16, COLOR_RGBA, 16, compression_level)
    raise ValueError(f"unsupported field dtype {dt}")


def decode_field_png(data: bytes) -> np.ndarray:
    """Inverse of encode_field_png; also accepts RGB (24-bit) images."""
    img, ctype, depth = decode(data)
    if ctype == COLOR_GRAY:
        return img  # u8 or u16 (h, w)
    if ctype == COLOR_RGB and depth == 8:
        h, w, _ = img.shape
        out = (img[..., 0].astype(np.uint32)
               | (img[..., 1].astype(np.uint32) << 8)
               | (img[..., 2].astype(np.uint32) << 16))
        return out
    if ctype == COLOR_RGBA and depth == 8:
        h, w, _ = img.shape
        return np.ascontiguousarray(img.astype(np.uint8)).view(
            np.uint32).reshape(h, w)
    if ctype == COLOR_RGBA and depth == 16:
        h, w, _ = img.shape
        return np.ascontiguousarray(img.astype(np.uint16)).view(
            np.uint64).reshape(h, w)
    raise ValueError(f"unsupported PNG layout ct={ctype} depth={depth}")
