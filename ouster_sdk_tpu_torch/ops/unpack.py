"""Frame decode: staged packet words -> LidarScan field arrays.

Every field of a pixel block sits at a fixed (word, bit) position, so
decode is a word index plus shift/mask per field, with no per-pixel
gathers (ref: ouster_client/src/parsing.cpp:653-702, lidar_scan.cpp:
1282-1322). The decode plan is derived from the profile tables
(ops/profiles.py). Two stagings decode to the same fields: word-planar
(`decode_frame_planar[_batch]`) and packet-layout, whole packets at their
slot (`decode_frame[_batch]`).

Staged words are held as int32 tensors (bit-identical views of the u32
words): PyTorch has no `>>`/`<<` for uint32 on the CPU. Bit extraction
runs in int64, masked to 32 bits, and each field is cast to its scan
dtype at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.types import DataFormat, SensorInfo
from .profiles import lookup_profile_entry, lookup_scan_fields, \
    make_packet_geometry

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class FieldPlan:
    """Decode recipe for one field."""

    name: str
    word: int        # word index within the pixel block
    bit: int         # bit offset within that word
    size: int        # field width in bits
    upshift: int
    out_dtype: str   # numpy dtype name of the scan field


@dataclass(frozen=True)
class DecodePlan:
    """Decode recipe for a whole frame.

    Geometry in uint32 words: a lidar packet is
    [pkt_header hw][cpp x ([col_header chw][npx x pw])][col_footer fw]][pkt_footer]
    """

    profile: str
    h: int
    w: int
    cpp: int                 # columns per packet
    n_pkts: int
    pkt_words: int
    hw: int                  # packet header words
    cw: int                  # column block words
    chw: int                 # column header words
    pw: int                  # pixel block words
    legacy: bool
    fields: Tuple[FieldPlan, ...]
    status_word: int         # within the full column block (packet layout)
    status_bit: int
    status_size: int
    mid_word: int
    mid_bit: int
    # planar staging layout: LEGACY keeps status in the column FOOTER,
    # staged as extra col-header row(s) after the chw real header words
    # (schw = chw + footer words staged)
    schw: int = 0
    staged_status_word: int = 0


def make_decode_plan(info_or_format, field_names: Optional[Tuple[str, ...]]
                     = None, raw_fields: bool = False) -> DecodePlan:
    fmt: DataFormat = (info_or_format.format
                       if isinstance(info_or_format, SensorInfo)
                       else info_or_format)
    geom = make_packet_geometry(fmt)
    entry = lookup_profile_entry(fmt.udp_profile_lidar)
    scan_fields = dict(lookup_scan_fields(fmt.udp_profile_lidar))
    if raw_fields:
        # RAW32_WORDk side-channels: the raw u32 words of each pixel block
        # (ref: open_source.h raw_fields); each is one staged plane
        for name in entry.fields:
            if name.startswith("RAW32_WORD") and name not in scan_fields:
                scan_fields[name] = np.dtype(np.uint32)

    plans = []
    for name, finfo in sorted(entry.fields.items()):
        if name not in scan_fields:
            continue
        if field_names is not None and name not in field_names \
                and not (raw_fields and name.startswith("RAW32_WORD")):
            continue
        if finfo.num_elements > 1:
            # RGB-style multi-element: one plan per element
            per = finfo.bit_size // finfo.num_elements
            for e in range(finfo.num_elements):
                bit = finfo.bit_start + e * per
                plans.append(FieldPlan(
                    name=f"{name}#{e}", word=bit // 32, bit=bit % 32,
                    size=per, upshift=0,
                    out_dtype=scan_fields[name].name))
            continue
        plans.append(FieldPlan(
            name=name, word=finfo.bit_start // 32, bit=finfo.bit_start % 32,
            size=finfo.bit_size, upshift=finfo.upshift,
            out_dtype=scan_fields[name].name))

    if geom.legacy:
        # status is the last word of the column block, the col footer
        # (ref: parsing.cpp:516-530); planar staging ships it as one extra
        # col-header row after the 4 real header words
        status_word = geom.col_size // 4 - 1
        status_bit, status_size = 0, 32
        schw = geom.col_header_size // 4 + 1
        staged_status_word = geom.col_header_size // 4
    else:
        status_word, status_bit, status_size = 2, 16, 16
        schw = geom.col_header_size // 4
        staged_status_word = status_word

    return DecodePlan(
        # a custom profile (ops.profiles.add_custom_profile) is its name
        profile=fmt.udp_profile_lidar.value
        if hasattr(fmt.udp_profile_lidar, "value") else str(
            fmt.udp_profile_lidar),
        h=fmt.pixels_per_column,
        w=fmt.columns_per_frame,
        cpp=fmt.columns_per_packet,
        n_pkts=fmt.columns_per_frame // fmt.columns_per_packet,
        pkt_words=geom.lidar_packet_size // 4,
        hw=geom.packet_header_size // 4,
        cw=geom.col_size // 4,
        chw=geom.col_header_size // 4,
        pw=geom.channel_data_size // 4,
        legacy=geom.legacy,
        fields=tuple(plans),
        status_word=status_word,
        status_bit=status_bit,
        status_size=status_size,
        mid_word=2, mid_bit=0,
        schw=schw,
        staged_status_word=staged_status_word,
    )


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 word view -> int64 holding the unsigned value."""
    return words.to(torch.int64) & _U32


def _bits(lo_word: torch.Tensor, hi_word: Optional[torch.Tensor], bit: int,
          size: int, upshift: int = 0) -> torch.Tensor:
    """Bitfield of `size` bits at `bit`, continuing into `hi_word` when it
    crosses the word boundary. Words are int32 views of u32; returns the
    unsigned value in int64."""
    lo = _u32(lo_word) >> bit
    if bit + size > 32:
        lo = (lo | (_u32(hi_word) << (32 - bit))) & _U32
    if size < 32:
        lo = lo & ((1 << size) - 1)
    if upshift:
        lo = (lo << upshift) & _U32
    return lo


def _extract(words: torch.Tensor, word: int, bit: int, size: int,
             upshift: int = 0) -> torch.Tensor:
    """Bitfield extract; `words` has the block's words on the last axis."""
    hi = words[..., word + 1] if bit + size > 32 else None
    return _bits(words[..., word], hi, bit, size, upshift)


_TORCH_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16,
                 "uint32": torch.uint32}


def _to_scan_dtype(v: torch.Tensor, dtype: str) -> torch.Tensor:
    """int64 holding a u32 value -> the field's scan dtype, truncating like
    a u32 -> narrower unsigned conversion; float16 fields are the low 16
    bits reinterpreted."""
    if dtype == "float16":
        v = v & 0xFFFF
        return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16) \
            .view(torch.float16)
    bits = np.dtype(dtype).itemsize * 8
    return (v & ((1 << bits) - 1)).to(_TORCH_DTYPES[dtype])


def decode_frame_planar_batch(planes: torch.Tensor, col_hdrs: torch.Tensor,
                              plan: DecodePlan, zero_invalid: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """Decode every channel field of a batch of word-planar frames.

    planes (B, pw, h, w) and col_hdrs (B, schw, w) hold the staged u32
    words as int32 (FrameReader.iter_planar_chunks layout); col_hdrs rows
    are the chw header words plus, for LEGACY, the staged column-footer
    status word. Returns one (B, h, w) tensor per field in its scan dtype,
    plus 'status' (B, w) u32, 'measurement_id' (B, w) u16 and
    'timestamp_lo'/'_hi' (B, w) u32. Columns whose status bit 0 is clear
    decode to zero (ref: lidar_scan.cpp:1194 zero_fields).
    """
    hdr = col_hdrs.transpose(-1, -2)                      # (B, w, schw)
    status = _extract(hdr, plan.staged_status_word, plan.status_bit,
                      plan.status_size)
    m_id = _extract(hdr, plan.mid_word, plan.mid_bit, 16)
    valid = (status & 1) != 0                             # (B, w)
    zero = torch.zeros((), dtype=torch.int64, device=planes.device)

    out: Dict[str, torch.Tensor] = {}
    for f in plan.fields:
        hi = planes[:, f.word + 1] if f.bit + f.size > 32 else None
        v = _bits(planes[:, f.word], hi, f.bit, f.size, f.upshift)
        if zero_invalid:
            v = torch.where(valid[:, None, :], v, zero)
        out[f.name] = _to_scan_dtype(v, f.out_dtype)

    # batcher parity: a present-but-invalid column's header cells stay 0
    # (ref: lidar_scan.cpp:1207-1255)
    if zero_invalid:
        status = torch.where(valid, status, zero)
    out["status"] = _to_scan_dtype(status, "uint32")
    out["measurement_id"] = _to_scan_dtype(torch.where(valid, m_id, zero),
                                           "uint16")
    out["timestamp_lo"] = _to_scan_dtype(
        torch.where(valid, _u32(col_hdrs[:, 0]), zero), "uint32")
    out["timestamp_hi"] = _to_scan_dtype(
        torch.where(valid, _u32(col_hdrs[:, 1]), zero), "uint32")
    return out


def decode_frame_planar(planes: torch.Tensor, col_hdrs: torch.Tensor,
                        plan: DecodePlan, zero_invalid: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """Single-frame decode: planes (pw, h, w) + col_hdrs (schw, w)."""
    out = decode_frame_planar_batch(planes[None], col_hdrs[None], plan,
                                    zero_invalid)
    return {k: v[0] for k, v in out.items()}


def _scatter_last(v: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """Move source columns (last axis of v, int64) to their destinations:
    out[..., d] = v[..., winner[d]], or 0 where no source claims d
    (winner < 0). `winner` is (B, w) and broadcasts over middle axes."""
    idx = winner.clamp(min=0)
    while idx.ndim < v.ndim:
        idx = idx.unsqueeze(1)
    idx = idx.expand(*v.shape[:-1], winner.shape[-1])
    keep = (winner >= 0).reshape(idx.shape[0], *([1] * (v.ndim - 2)), -1)
    return torch.where(keep, torch.gather(v, -1, idx),
                       torch.zeros((), dtype=v.dtype, device=v.device))


def decode_frame_batch(frames_words: torch.Tensor, plan: DecodePlan,
                       dense: bool = True, zero_invalid: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """Decode a batch of packet-layout frames.

    frames_words (B, n_pkts, pkt_words) holds each frame's lidar packets
    at their slots, the u32 words as int32 (FrameReader.iter_chunks
    layout); a missing packet is a zero row, whose columns decode with
    status 0 and are zeroed. Returns one (B, h, w) tensor per field in its
    scan dtype, plus 'status' (B, w) u32, 'measurement_id' (B, w) u16 and
    'timestamp_lo'/'_hi' (B, w) u32.

    dense=True takes column k of packet p for measurement id p * cpp + k
    (frames staged in order). dense=False scatters each valid column to
    its decoded measurement id: ids >= w are dropped, and of several
    columns with one id the last wins. The winner of each destination is
    found first and then gathered, so the result does not depend on the
    order in which a device applies duplicate writes.
    """
    B, n_pkts, _ = frames_words.shape
    cols = frames_words[:, :, plan.hw:plan.hw + plan.cpp * plan.cw] \
        .reshape(B, n_pkts * plan.cpp, plan.cw)           # (B, W, cw)
    status = _extract(cols, plan.status_word, plan.status_bit,
                      plan.status_size)
    m_id = _extract(cols, plan.mid_word, plan.mid_bit, 16)
    ts_lo, ts_hi = _u32(cols[..., 0]), _u32(cols[..., 1])
    valid = (status & 1) != 0                             # (B, W)
    zero = torch.zeros((), dtype=torch.int64, device=cols.device)
    px = cols[..., plan.chw:plan.chw + plan.h * plan.pw] \
        .reshape(B, -1, plan.h, plan.pw)                  # (B, W, h, pw)

    winner = None
    if not dense:
        # the last source column of each destination; invalid columns and
        # ids beyond the frame go to the dropped bucket plan.w
        dest = torch.where(valid, m_id, plan.w).clamp(max=plan.w)
        src = torch.arange(dest.shape[1], device=cols.device).expand_as(dest)
        winner = torch.full((B, plan.w + 1), -1, dtype=torch.int64,
                            device=cols.device)
        winner.scatter_reduce_(1, dest, src, "amax")
        winner = winner[:, :plan.w]

    out: Dict[str, torch.Tensor] = {}
    for f in plan.fields:
        v = _extract(px, f.word, f.bit, f.size, f.upshift)     # (B, W, h)
        if zero_invalid:
            v = torch.where(valid[..., None], v, zero)
        v = v.transpose(-1, -2)                                # (B, h, W)
        if winner is not None:
            v = _scatter_last(v, winner)
        out[f.name] = _to_scan_dtype(v, f.out_dtype).contiguous()

    if winner is not None:
        status = _scatter_last(status, winner)
        ts_lo = _scatter_last(ts_lo, winner)
        ts_hi = _scatter_last(ts_hi, winner)
        m_id = torch.where((status & 1) != 0,
                           torch.arange(plan.w, device=cols.device), zero)
    else:
        ts_lo = torch.where(valid, ts_lo, zero)
        ts_hi = torch.where(valid, ts_hi, zero)
        m_id = torch.where(valid, m_id, zero)
        if zero_invalid:
            # batcher parity: invalid columns' header cells stay 0
            # (ref: lidar_scan.cpp:1207-1255 per-col skip)
            status = torch.where(valid, status, zero)
    out["status"] = _to_scan_dtype(status, "uint32")
    out["measurement_id"] = _to_scan_dtype(m_id, "uint16")
    out["timestamp_lo"] = _to_scan_dtype(ts_lo, "uint32")
    out["timestamp_hi"] = _to_scan_dtype(ts_hi, "uint32")
    return out


def decode_frame(packet_words: torch.Tensor, plan: DecodePlan,
                 dense: bool = True, zero_invalid: bool = True
                 ) -> Dict[str, torch.Tensor]:
    """Single-frame decode: packet_words (n_pkts, pkt_words)."""
    out = decode_frame_batch(packet_words[None], plan, dense, zero_invalid)
    return {k: v[0] for k, v in out.items()}


def frame_words_from_packets(packets, plan: DecodePlan,
                             m_ids: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """Host-side staging: stack one frame's lidar packet payloads into the
    (n_pkts, pkt_words) uint32 array decode_frame takes, each packet at
    the slot of its first column's measurement id (or of m_ids[i]), gaps
    zero-filled; a later packet of the same slot replaces the earlier."""
    out = np.zeros((plan.n_pkts, plan.pkt_words), dtype=np.uint32)
    for i, p in enumerate(packets):
        buf = p.buf if hasattr(p, "buf") else p
        words = np.frombuffer(
            buf.tobytes() if isinstance(buf, np.ndarray) else buf,
            dtype="<u4", count=plan.pkt_words)
        if m_ids is not None:
            slot = int(m_ids[i]) // plan.cpp
        else:
            slot = int(words[plan.hw + plan.mid_word] & 0xFFFF) // plan.cpp
        if 0 <= slot < plan.n_pkts:
            out[slot] = words
    return out
