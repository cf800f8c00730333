"""BP64 decoded from its format alone, in plain PyTorch on the CPU in int64:
the reference of the wire replay cell. The format (Lemire and Boytsov's
binary packing, blocks of 64 zigzag deltas; the port's ops/bp64.py states
it) codes each 64-pixel block of a row as

    width byte   low 5 bits the width w of the block's packed deltas; bit 7
                 set when the block carries a dropout mask
    anchor       the block's first non-zero value (0 if it has none)
    payload      the blocks' words one after another, in C order of
                 (field, row, block): [dropout mask, 2 words, if bit 7]
                 then the 64 zigzagged deltas packed LSB first at w bits,
                 2 * w words

and the values are v[j] = 0 where mask bit j is set (bit j of the low word
for j < 32, of the high word after), else c[j] = anchor + d[0] + ... + d[j]
modulo 2**32, d the deltas with the zigzag undone. A block's words follow
from the width bytes of the blocks before it.

The shipped buffer is ChunkFuser's: the chunk's arrays one after another in
one u32 buffer, each at a whole word, at the (word offset, shape, dtype)
of its layout entry; `split` takes them apart.

Each block is read on its own from its header: its start bit, its width,
its flag. Blocks of one width are read together, bit by bit from the
payload unrolled into bits, and nothing here depends on how the program
decodes."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

BLOCK = 64
MASK32 = 0xFFFFFFFF


def split(fused: np.ndarray, layout: Sequence[Tuple[int, tuple, str]]
          ) -> List[np.ndarray]:
    """The arrays of one shipped u32 buffer, by its layout."""
    words = np.ascontiguousarray(fused).view(np.uint32)
    out = []
    for off, shape, dtype in layout:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) * dt.itemsize
        raw = words[off:off + (n + 3) // 4].view(np.uint8)[:n]
        out.append(raw.view(dt).reshape(shape))
    return out


def _bits(payload: torch.Tensor, need: int) -> torch.Tensor:
    """The payload's bits, LSB first word after word, as uint8, with zeros
    past its end up to `need` bits."""
    shifts = torch.arange(32, dtype=torch.int64)
    bits = ((payload[:, None] >> shifts) & 1).reshape(-1).to(torch.uint8)
    if bits.numel() < need:
        bits = torch.cat([bits, torch.zeros(need - bits.numel(),
                                            dtype=torch.uint8)])
    return bits


def decode(payload: np.ndarray, widths: np.ndarray, anchors: np.ndarray
           ) -> torch.Tensor:
    """One frame: payload (P,) u32, widths (..., n) u8 and anchors (..., n)
    u32 of its blocks -> (..., 64 n) int64 values."""
    pay = torch.from_numpy(np.ascontiguousarray(payload, np.uint32)
                           .astype(np.int64))
    wb = torch.from_numpy(np.ascontiguousarray(widths, np.uint8)
                          .reshape(-1).astype(np.int64))
    anc = torch.from_numpy(np.ascontiguousarray(anchors, np.uint32)
                           .reshape(-1).astype(np.int64))
    w, flag = wb & 0x1F, (wb >> 7) & 1
    size = 2 * flag + 2 * w                        # words of each block
    start = torch.cumsum(size, 0) - size           # its first word
    # every block's first two words are read as a mask, flag or not: two
    # words of zeros past the last block keep that inside the bits
    bits = _bits(pay, 32 * (int(size.sum()) + 2))
    j = torch.arange(BLOCK, dtype=torch.int64)
    z = torch.zeros((len(wb), BLOCK), dtype=torch.int64)
    data = 32 * (start + 2 * flag)                 # first bit of lane 0
    for width in torch.unique(w).tolist():
        if width == 0:
            continue
        sel = torch.nonzero(w == width).reshape(-1)
        k = torch.arange(width, dtype=torch.int64)
        at = data[sel, None, None] + j[None, :, None] * width + k
        z[sel] = (bits[at].to(torch.int64) << k).sum(-1)
    d = (z >> 1) ^ -(z & 1)                         # zigzag undone
    c = (anc[:, None] + torch.cumsum(d, 1)) & MASK32
    mbits = bits[32 * start[:, None] + j].to(torch.int64)
    dropped = (flag[:, None] == 1) & (mbits == 1)
    v = torch.where(dropped, torch.zeros_like(c), c)
    return v.reshape(tuple(widths.shape[:-1]) + (BLOCK * widths.shape[-1],))
