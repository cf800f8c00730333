"""BP64: lossless delta/bit-packed wire codec for range-field ingest.

The packed staging (ops/packed.py) ships the floor for incompressible
ranges (nbits a pixel). Real captures are far from incompressible:
neighbouring azimuth steps land millimetres apart on the same surface.
BP64 codes each 64-pixel row block as

  anchor[b]  = first non-zero value of the block (0 if none)   u32 side
  carry c[j] = v[j] if v[j] != 0 else c[j-1]   (c[-1] := anchor)
  z[j]       = zigzag(c[j] - c[j-1])           (0 for dropouts)
  width w    = max bit length of z             (5 bits of the u8 side)
  zmask      = 64-bit dropout bitmask, present only when the block has
               dropouts (flag bit 7 of the width byte)
  payload   += [zmask? 2 words] + z[0..63] packed at w bits = 2*w words

Dropouts (range 0) cost a bit each and do not widen the block. A block is
always a whole number of u32 words, so the payload is a dense word
stream and the decode is a static-shape gather and shift: word offsets by
a cumsum of the widths, two gathers a pixel, variable shifts, the zigzag
undone, a cumsum over the 64 slots plus the anchor, the dropout mask. The
decoded ranges go through the planar projection's epilogue
(ops/planar_kernels.project_ranges_batched). Without poses XYZ is
bit-identical across the planar, packed and BP64 stagings; with poses
the packed and BP64 stagings dewarp in rotate_translate's order, which
differs from the planar kernel's fused dewarp by about one f32 ulp.

The encoder runs on the host: the native library's bp64_encode, or
`bp64_encode_numpy` (the reference the native one is held to, and the
route without g++). w % 64 == 0 holds for every lidar mode.

Two places where torch is not jnp, both handled in `_decode_core`: jnp
gathers clamp out-of-range indices, torch's raise (CPU) or fault (CUDA),
so the indices are clamped to the last word explicitly; and the uint32
arithmetic wraps, so it runs in int64 masked with 0xFFFFFFFF (torch has
no uint32 shifts on the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from .planar_kernels import project_ranges_batched
from .unpack import DecodePlan, _U32, _u32

BLOCK = 64
ZFLAG = np.uint8(0x80)
WMASK = np.uint8(0x1F)


def bp64_encode_numpy(values: np.ndarray, nbits: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference encoder (the native library ships the production one;
    tests assert byte equality). values: (..., w) u32 with w % 64 == 0.
    Returns (payload u32 (P,), widths u8 (..., w//64) [bit7 = has
    dropout mask], anchors u32 (..., w//64)); payload is the dense
    concatenation of every block in C order of the leading axes."""
    if not 1 <= nbits <= 30:
        # widths are 5-bit (WMASK): zigzag deltas of nbits-values need
        # up to nbits+1 bits, so nbits > 30 would truncate width 32 to
        # 0 and decode every delta as zero — corrupt, not slow
        raise ValueError("bp64 supports 1 <= nbits <= 30")
    v = np.ascontiguousarray(values, np.uint32)
    w = v.shape[-1]
    if w % BLOCK:
        raise ValueError("w must be a multiple of 64")
    blocks = v.reshape(-1, BLOCK)                       # (nb, 64)
    nb = len(blocks)
    zero = blocks == 0
    has_z = zero.any(axis=1)
    # carry chain: dropouts inherit the previous value; anchor = first
    # non-zero (or 0 for an all-dropout block)
    idx = np.where(zero, 0, np.arange(1, BLOCK + 1)[None])
    np.maximum.accumulate(idx, axis=1, out=idx)          # last nonzero+1
    first_nz = zero.argmin(axis=1)                       # 0 if none
    anchors = np.where(zero.all(axis=1), np.uint32(0),
                       blocks[np.arange(nb), first_nz])
    padded = np.concatenate([anchors[:, None], blocks], axis=1)  # c[-1]
    carry = padded[np.arange(nb)[:, None], idx]          # (nb, 64)
    prev = np.concatenate([anchors[:, None], carry[:, :-1]], axis=1)
    d = carry - prev                                     # wrapping u32
    z = (d << np.uint32(1)) ^ (0 - (d >> np.uint32(31)))  # zigzag
    maxz = z.max(axis=1)
    widths = np.zeros(nb, np.uint8)
    nzw = maxz > 0
    widths[nzw] = np.floor(
        np.log2(maxz[nzw].astype(np.float64))).astype(np.uint8) + 1
    # block word sizes: optional 2-word zmask + 2*w packed words
    sizes = 2 * widths.astype(np.int64) + 2 * has_z
    word_off = np.zeros(nb, np.int64)
    np.cumsum(sizes[:-1], out=word_off[1:])
    total = int(word_off[-1] + sizes[-1]) if nb else 0
    payload = np.zeros(total, np.uint32)
    if has_z.any():
        zi = np.nonzero(has_z)[0]
        bits = zero[zi].astype(np.uint64) << np.arange(BLOCK,
                                                       dtype=np.uint64)
        zm = bits.sum(axis=1)
        payload[word_off[zi]] = (zm & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
        payload[word_off[zi] + 1] = (zm >> np.uint64(32)).astype(np.uint32)
    data_off = word_off + 2 * has_z
    for wv in np.unique(widths):
        if wv == 0:
            continue
        sel = np.nonzero(widths == wv)[0]
        zb = z[sel]                                      # (m, 64)
        out = np.zeros((len(sel), 2 * int(wv)), np.uint32)
        for j in range(BLOCK):
            bit = j * int(wv)
            w0, s = bit >> 5, bit & 31
            out[:, w0] |= zb[:, j] << np.uint32(s)
            if s + int(wv) > 32:
                out[:, w0 + 1] |= zb[:, j] >> np.uint32(32 - s)
        oidx = data_off[sel, None] + np.arange(2 * int(wv))[None]
        payload[oidx.ravel()] = out.ravel()
    widths |= has_z.astype(np.uint8) << np.uint8(7)
    lead = values.shape[:-1]
    return (payload, widths.reshape(lead + (w // BLOCK,)),
            anchors.reshape(lead + (w // BLOCK,)))


def bp64_decode_numpy(payload: np.ndarray, widths: np.ndarray,
                      anchors: np.ndarray, w: int) -> np.ndarray:
    """Host decode (tests, and the reference of the torch decode):
    payload (P,) u32, widths (..., w // 64) u8, anchors (..., w // 64) u32
    -> (..., w) u32. Two zero slack words go after the payload, so the
    gathers stay inside it."""
    u32 = np.uint32
    pay = np.concatenate([payload.astype(u32), np.zeros(2, u32)])
    wid_b = widths.reshape(-1)
    anc = anchors.reshape(-1).astype(u32)
    wid = (wid_b & WMASK).astype(np.int64)
    has_z = (wid_b >> 7).astype(np.int64)
    sizes = 2 * wid + 2 * has_z
    word_off = np.cumsum(sizes) - sizes                  # exclusive
    data_off = word_off + 2 * has_z
    j = np.arange(BLOCK, dtype=np.int64)
    bit = wid[:, None] * j[None]                         # (nb, 64)
    wi = data_off[:, None] + (bit >> 5)
    sh = (bit & 31).astype(u32)
    lo = pay[wi] >> sh
    hi = np.where(sh == 0, u32(0), pay[wi + 1] << ((u32(32) - sh) & u32(31)))
    mask = (u32(1) << wid[:, None].astype(u32)) - u32(1)
    z = (lo | hi) & mask
    d = (z >> u32(1)) ^ (u32(0) - (z & u32(1)))
    c = anc[:, None] + np.cumsum(d.astype(u32), axis=1, dtype=u32)
    zm_lo = pay[word_off] * has_z.astype(u32)            # 0 when absent
    zm_hi = pay[word_off + 1] * has_z.astype(u32)
    zbit = np.where(j[None] < 32,
                    (zm_lo[:, None] >> (j[None] & 31).astype(u32)),
                    (zm_hi[:, None] >> (j[None] & 31).astype(u32))) & u32(1)
    v = np.where(zbit != 0, u32(0), c)
    return v.reshape(widths.shape[:-1] + (w,)).astype(u32)


def _decode_core(pay: torch.Tensor, wid_b: torch.Tensor,
                 anc: torch.Tensor) -> torch.Tensor:
    """Decode the blocks of B frames: pay (B, P) int64 holding u32 words
    (each frame's word offsets start at its row), wid_b (B, n) int64 width
    bytes, anc (B, n) int64 anchors -> (B, n, 64) int64 values.

    Every gather index is clamped to the last word, as jnp's gathers
    clamp: a payload without slack words decodes as the JAX package's
    decode does. A clamped word is never a value's bits: a lane reads the
    next word only when its bits continue there, and a block without a
    dropout mask or width reads nothing. An empty payload (every block
    constant, width 0) decodes to the anchors."""
    B = pay.shape[0]
    if pay.shape[1] == 0:
        pay = torch.zeros((B, 1), dtype=pay.dtype, device=pay.device)
    last = pay.shape[1] - 1

    def take(idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(pay, 1, idx.clamp(max=last).reshape(B, -1)
                            ).reshape(idx.shape)

    wid = wid_b & int(WMASK)
    has_z = wid_b >> 7
    sizes = 2 * wid + 2 * has_z
    word_off = torch.cumsum(sizes, dim=1) - sizes        # exclusive
    data_off = word_off + 2 * has_z
    j = torch.arange(BLOCK, device=pay.device)
    bit = wid[..., None] * j                             # (B, n, 64)
    wi = data_off[..., None] + (bit >> 5)
    sh = bit & 31
    lo = take(wi) >> sh
    hi = torch.where(sh == 0, 0, (take(wi + 1) << ((32 - sh) & 31)) & _U32)
    mask = (1 << wid[..., None]) - 1
    z = (lo | hi) & mask
    d = ((z >> 1) ^ -(z & 1)) & _U32                     # zigzag undone
    c = (anc[..., None] + torch.cumsum(d, dim=-1)) & _U32
    zm_lo = take(word_off) * has_z                       # 0 when absent
    zm_hi = take(word_off + 1) * has_z
    zbit = torch.where(j < 32, zm_lo[..., None] >> (j & 31),
                       zm_hi[..., None] >> (j & 31)) & 1
    return torch.where(zbit != 0, 0, c)


def bp64_decode_torch(payload: torch.Tensor, widths: torch.Tensor,
                      anchors: torch.Tensor, w: int) -> torch.Tensor:
    """Device decode of one frame's fields, the counterpart of the JAX
    package's bp64_decode_jnp: payload (P,) u32 words (int32 or uint32),
    widths (..., w // 64) uint8, anchors (..., w // 64) u32 words ->
    (..., w) int64 holding the u32 values."""
    v = _decode_core(_u32(payload)[None],
                     widths.reshape(1, -1).to(torch.int64),
                     _u32(anchors).reshape(1, -1))
    return v.reshape(widths.shape[:-1] + (w,))


def project_bp64_batched(payload: torch.Tensor, widths: torch.Tensor,
                         anchors: torch.Tensor, col_hdrs: torch.Tensor,
                         lut_stack: torch.Tensor, plan: DecodePlan,
                         nbits: int, upshifts: Tuple[int, ...] = (0,),
                         precision: str = "dd", dual: bool = False,
                         poses: Optional[torch.Tensor] = None):
    """BP64 stream(s) -> XYZ (B, 3, h, w), a pair when dual. payload
    (B, P) u32 words (each frame's fields concatenated in (F, h, nb) C
    order, padded to a common P), widths (B, F, h, nb) uint8, anchors
    (B, F, h, nb) u32 words, col_hdrs (B, chw, w) mask the columns whose
    status bit is clear; poses (B, w, 4, 4) dewarp per column. `nbits`
    is the staging's (FrameReader.iter_bp64_chunks); the decode reads the
    widths. A single frame (no batch axis) is a batch of one. CPU tensors
    run in plain PyTorch; on CUDA tensors the projection launches the
    planar kernel once (planar_kernels.project_ranges_batched)."""
    if payload.ndim == 1:
        payload, widths = payload[None], widths[None]
        anchors, col_hdrs = anchors[None], col_hdrs[None]
    return project_ranges_batched(
        bp64_ranges(payload, widths, anchors, plan, upshifts, dual),
        col_hdrs, lut_stack, plan, precision=precision, poses=poses)


def bp64_ranges(payload: torch.Tensor, widths: torch.Tensor,
                anchors: torch.Tensor, plan: DecodePlan,
                upshifts: Tuple[int, ...], dual: bool) -> List[torch.Tensor]:
    """The decode half of project_bp64_batched: (B, P) payload, (B, F, h,
    nb) widths and anchors -> RANGE (and RANGE2) as (B, h, w) int64 u32
    values, upshifts applied, columns not yet masked. Each frame's word
    offsets start at its payload row."""
    if len(upshifts) < (2 if dual else 1):
        raise ValueError(
            "upshifts needs one entry per bp64 field "
            f"({2 if dual else 1}); use packed_range_fields(plan, dual)")
    B, F = widths.shape[:2]
    with profiling.span("bp64.decode"):
        vals = _decode_core(_u32(payload),
                            widths.reshape(B, -1).to(torch.int64),
                            _u32(anchors).reshape(B, -1)
                            ).reshape(B, F, plan.h, plan.w)
        ranges = []
        for k in range(2 if dual else 1):
            r = vals[:, k]
            if upshifts[k]:
                r = (r << upshifts[k]) & _U32
            ranges.append(r)
    profiling.count("bp64.ranges_decoded", B * F)
    return ranges
