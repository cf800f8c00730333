"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit) and the bytes a kernel call needs, counted from its
shapes: each input byte read once, each output byte written once."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12          # HBM3


def planar_project_bytes(frames: int, h: int, w: int, returns: int) -> int:
    """One planar_project call over `frames` word-planar frames: the range
    word of each return, the column status words, the (18, h, w) float32
    LUT stack once a call, and the float32 XYZ of each return."""
    hw = h * w
    return (returns * frames * hw * 4
            + frames * w * 4
            + 18 * hw * 4
            + returns * frames * 3 * hw * 4)
