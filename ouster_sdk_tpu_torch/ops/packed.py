"""Device decode of the bit-packed wire staging (host side:
io.frames.FrameReader.iter_packed_chunks, native group_frames_packed).

Range fields are 15 or 19 bits wide; shipped as 32-bit words they waste
40-60 % of the host->device copy. The packed layout is a dense LSB-first
bitstream per (field, pixel row): 32 pixels always span exactly `nbits`
words, so the unpack is one fixed 32-lane pattern of shifts over
(..., w // 32, nbits) blocks, with no data-dependent addressing. The
decoded ranges go through the planar projection's epilogue
(ops/planar_kernels.project_ranges_batched), so XYZ is the planar
path's, bit for bit, without poses (with poses the epilogue dewarps in
rotate_translate's order, as the JAX package's packed path does).

`unfuse_words` is the device twin of io.frames.ChunkFuser.pack: one
fused u32 upload a chunk, split back into its arrays.

Words are int32 tensors (bit-identical views of the u32 words): torch has
no uint32 shifts on the CPU, so bit work runs in int64 masked to 32 bits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .planar_kernels import project_ranges_batched
from .unpack import DecodePlan, FieldPlan, _U32, _u32

Layout = Tuple[Tuple[int, Tuple[int, ...], str], ...]


def unfuse_words(fused: torch.Tensor, layout: Layout) -> List[torch.Tensor]:
    """Split one fused upload buffer (1-D int32, the u32 words) back into
    the arrays io.frames.ChunkFuser.pack packed, by the (word offset,
    shape, dtype) entries of `layout`. uint32 entries come back as int32
    views of the buffer (the port holds every staged word so), float32 as
    float32 views, uint8 / uint16 as new tensors rebuilt from the words
    with static shifts. Other dtypes raise ValueError: 64-bit values
    (frame ids, timestamps) stay on the host."""
    out = []
    for off, shape, dt in layout:
        n = 1
        for s in shape:
            n *= s
        if dt == "uint32":
            out.append(fused[off:off + n].view(shape))
        elif dt == "float32":
            out.append(fused[off:off + n].view(torch.float32).view(shape))
        elif dt in ("uint8", "uint16"):
            per = 4 if dt == "uint8" else 2
            bits = 32 // per
            w = _u32(fused[off:off + (n + per - 1) // per])
            parts = [(w >> (bits * k)) & ((1 << bits) - 1)
                     for k in range(per)]
            v = torch.stack(parts, dim=-1).reshape(-1)[:n]
            out.append(v.to(torch.uint8 if dt == "uint8" else torch.uint16)
                       .view(shape))
        else:
            raise ValueError(f"unfuse_words: unsupported dtype {dt}")
    return out


def unpack_bits(packed: torch.Tensor, nbits: int, w: int) -> torch.Tensor:
    """(..., w * nbits // 32) int32 words of a dense LSB-first bitstream ->
    (..., w) int64 holding the u32 values. Pixel j of a 32-pixel block
    starts at bit nbits * j of the block's nbits words: a fixed pattern of
    word indices and shifts, so one gather and a few shifts serve all 32
    lanes. w % 32 == 0."""
    if w % 32:
        raise ValueError("w must be a multiple of 32")
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits {nbits} outside 1..32")
    blocks = _u32(packed).reshape(packed.shape[:-1] + (w // 32, nbits))
    bit = [nbits * j for j in range(32)]
    dev = packed.device
    w0 = torch.tensor([b // 32 for b in bit], device=dev)
    s = torch.tensor([b % 32 for b in bit], device=dev)
    # lanes that continue into the next word; the others read word w0
    # again and shift it out of the mask
    spans = torch.tensor([b % 32 + nbits > 32 for b in bit], device=dev)
    w1 = torch.where(spans, w0 + 1, w0)
    hi_shift = torch.where(spans, 32 - s, torch.full_like(s, 32))
    lo = blocks[..., w0] >> s
    hi = (blocks[..., w1] << hi_shift) & _U32
    out = (lo | hi) & ((1 << nbits) - 1)             # (..., w // 32, 32)
    return out.reshape(packed.shape[:-1] + (w,))


def project_packed_batched(packed: torch.Tensor, col_hdrs: torch.Tensor,
                           lut_stack: torch.Tensor, plan: DecodePlan,
                           nbits: int, upshifts: Tuple[int, ...] = (0,),
                           precision: str = "dd", dual: bool = False,
                           poses: Optional[torch.Tensor] = None):
    """Packed range stream(s) -> XYZ (B, 3, h, w), a pair when dual.
    packed (B, n_fields, h, w * nbits // 32) int32 with field 0 = RANGE
    (and 1 = RANGE2 when dual); col_hdrs (B, chw, w) int32 mask the
    columns whose status bit is clear, as on the planar path; poses
    (B, w, 4, 4) dewarp per column. A single frame (no batch axis) is a
    batch of one. CPU tensors run in plain PyTorch; on CUDA tensors the
    projection launches the planar kernel once
    (planar_kernels.project_ranges_batched)."""
    if packed.ndim == 3:
        packed, col_hdrs = packed[None], col_hdrs[None]
    return project_ranges_batched(
        packed_ranges(packed, plan, nbits, upshifts, dual), col_hdrs,
        lut_stack, plan, precision=precision, poses=poses)


def packed_ranges(packed: torch.Tensor, plan: DecodePlan, nbits: int,
                  upshifts: Tuple[int, ...], dual: bool
                  ) -> List[torch.Tensor]:
    """The decode half of project_packed_batched: packed (B, n_fields, h,
    w * nbits // 32) -> RANGE (and RANGE2) as (B, h, w) int64 u32 values,
    upshifts applied, columns not yet masked."""
    if len(upshifts) < (2 if dual else 1):
        raise ValueError(
            "upshifts needs one entry per packed field "
            f"({2 if dual else 1}); use packed_range_fields(plan, dual)")
    ranges = []
    for k in range(2 if dual else 1):
        r = unpack_bits(packed[:, k], nbits, plan.w)
        if upshifts[k]:
            r = (r << upshifts[k]) & _U32
        ranges.append(r)
    return ranges


def packed_range_fields(plan: DecodePlan, dual: bool
                        ) -> Tuple[Tuple[Tuple[int, int], ...], int,
                                   Tuple[int, ...]]:
    """(fields, nbits, upshifts) of RANGE (and RANGE2) for this profile:
    the arguments that pair FrameReader.iter_packed_chunks /
    iter_bp64_chunks with project_packed_batched / project_bp64_batched."""
    def fp(name) -> FieldPlan:
        for f in plan.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    r1 = fp("RANGE")
    fields = [(r1.word, r1.bit)]
    upshifts = [r1.upshift]
    if dual:
        r2 = fp("RANGE2")
        if r2.size != r1.size:
            raise RuntimeError("mixed range widths")
        fields.append((r2.word, r2.bit))
        upshifts.append(r2.upshift)
    return tuple(fields), r1.size, tuple(upshifts)
