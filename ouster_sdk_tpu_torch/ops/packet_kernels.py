"""Packet-layout range -> XYZ projection: the wrappers, their kernel route
and their plain versions.

`unpack_project_packet_batched` turns packet-layout staged frames (whole
lidar packets at their slots, io/frames.FrameReader.iter_chunks) into
planar XYZ and nothing else: it finds each pixel's range word inside its
packet, zeroes columns whose status bit 0 is clear and evaluates
r * dir + off from four (3, h, w) LUT planes (dir_hi, dir_lo, off_hi,
off_lo). This is the projection that serves sensors with per-pixel angle
tables, whose LUT does not factorize. It is the counterpart of the
reference's `unpack_project_pallas[_batched]` and `unpack_project`
(ops/pallas_kernels.py), without their `tile_w` and `interpret`
arguments, which are TPU block knobs.

A tensor on the CPU takes the plain PyTorch version below; a CUDA tensor
launches the hand-written kernel `packet_project<DUAL>`
(kernels/csrc/packet_project.cu), or the wrapper raises. There is no
fallback from one to the other.

Numerics, which the kernel repeats op for op: precision="dd" is the
generic double-single chain, `precision.dd_mul_f` (Dekker product with a
run-time Veltkamp split of both factors), `precision.dd_add`, then
hi + lo, every product and sum rounded on its own and never contracted
into a fused multiply-add. It gives the same bits as the planar
projection's pre-split chain (ops/planar_kernels._proj_lean): both are
correctly rounded from the same (hi, lo) LUT. precision="f32" is
r * dir_hi + off_hi with two roundings.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from .planar_kernels import PlanarLut, _range_fields
from .precision import dd_add, dd_mul_f
from .unpack import DecodePlan, _extract
from .xyzlut import XYZLutDevice

#: Kernel launches per case, counted by the wrapper where it launches the
#: CUDA kernel and nowhere else: "packet" (one return) and "packet_dual"
#: (both returns from one pixel-region fetch).
launches: Dict[str, int] = {}

CASES = ("packet", "packet_dual")


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

LutPlanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def lut_planes(lut: Union[PlanarLut, XYZLutDevice]) -> LutPlanes:
    """(dir_hi, dir_lo, off_hi, off_lo) as contiguous (3, h, w) planes,
    from a PlanarLut (views of its stack) or an XYZLutDevice (transposed
    copies of its (h, w, 3) tensors)."""
    if isinstance(lut, XYZLutDevice):
        return tuple(t.movedim(-1, 0).contiguous() for t in
                     (lut.dir_hi, lut.dir_lo, lut.off_hi, lut.off_lo))
    s = lut.stack
    return s[0:3], s[9:12], s[12:15], s[15:18]


def _check_frames(frames_words: torch.Tensor, plan: DecodePlan) -> None:
    if frames_words.ndim != 3 or tuple(frames_words.shape[1:]) != (
            plan.n_pkts, plan.pkt_words):
        raise ValueError(
            f"frames must be (B, n_pkts, pkt_words) = (B, {plan.n_pkts}, "
            f"{plan.pkt_words}), got {tuple(frames_words.shape)}")
    if frames_words.dtype != torch.int32:
        raise ValueError(f"frames must be int32 (the u32 words' view), got "
                         f"{frames_words.dtype}")


# -- the plain version -------------------------------------------------------

def _range_to_xyz(r: torch.Tensor, dir_hi, dir_lo, off_hi, off_lo,
                  precision: str) -> torch.Tensor:
    """Integer range (B, h, w) int64 + (3, h, w) LUT planes -> xyz
    (B, 3, h, w) f32, zero where the range is zero."""
    r = r.to(torch.float32)[:, None]                # exact below 2**24
    if precision == "dd":
        p_hi, p_lo = dd_mul_f(dir_hi, dir_lo, r)
        s_hi, s_lo = dd_add(p_hi, p_lo, off_hi, off_lo)
        xyz = s_hi + s_lo
    else:
        xyz = r * dir_hi + off_hi
    return torch.where(r != 0, xyz, torch.zeros((), dtype=torch.float32,
                                                device=xyz.device))


def packet_ranges(frames_words: torch.Tensor, plan: DecodePlan, dual: bool
                  ) -> Tuple[torch.Tensor, ...]:
    """Each range field of packet-layout frames (B, n_pkts, pkt_words) as
    (B, h, w) int64 in mm, zero where the column's status bit is clear."""
    _check_frames(frames_words, plan)
    B = frames_words.shape[0]
    # the pixel-word region of every column and the column's valid bit
    cols = frames_words[:, :, plan.hw:plan.hw + plan.cpp * plan.cw] \
        .reshape(B, plan.w, plan.cw)
    status = _extract(cols, plan.status_word, plan.status_bit,
                      plan.status_size)
    valid = ((status & 1) != 0)[:, None, :]                   # (B, 1, w)
    px = cols[..., plan.chw:plan.chw + plan.h * plan.pw] \
        .reshape(B, plan.w, plan.h, plan.pw)
    zero = torch.zeros((), dtype=torch.int64, device=cols.device)
    return tuple(
        torch.where(valid, _extract(px, f.word, f.bit, f.size, f.upshift)
                    .transpose(1, 2), zero)
        for f in _range_fields(plan, dual))


def unpack_project_packet_batched_plain(
        frames_words: torch.Tensor, dir_hi: torch.Tensor,
        dir_lo: torch.Tensor, off_hi: torch.Tensor, off_lo: torch.Tensor,
        plan: DecodePlan, *, precision: str = "dd", dual: bool = False):
    """The plain PyTorch version of the packet-layout projection: same
    arguments and results as unpack_project_packet_batched, on any
    device."""
    outs = tuple(_range_to_xyz(r, dir_hi, dir_lo, off_hi, off_lo, precision)
                 for r in packet_ranges(frames_words, plan, dual))
    return outs if dual else outs[0]


# -- the wrappers ------------------------------------------------------------

def unpack_project_packet_batched(
        frames_words: torch.Tensor, dir_hi: torch.Tensor,
        dir_lo: torch.Tensor, off_hi: torch.Tensor, off_lo: torch.Tensor,
        plan: DecodePlan, *, precision: str = "dd", dual: bool = False):
    """Fused decode over packet-layout frames: (B, n_pkts, pkt_words), the
    staged u32 words held as int32, -> XYZ (B, 3, h, w) f32, or a pair of
    them (RANGE, RANGE2) when dual=True. The LUT comes as four (3, h, w)
    f32 planes (see lut_planes).

    Counterpart of the reference's unpack_project_pallas_batched. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if precision not in ("dd", "f32"):
        raise ValueError(f"precision must be 'dd' or 'f32', not "
                         f"{precision!r}")
    device = frames_words.device
    if device.type == "cpu":
        return unpack_project_packet_batched_plain(
            frames_words, dir_hi, dir_lo, off_hi, off_lo, plan,
            precision=precision, dual=dual)
    if device.type != "cuda":
        raise ValueError(f"packet projection runs on cpu or cuda tensors, "
                         f"not {device.type}")
    from ..kernels.packet_project import launch

    _check_frames(frames_words, plan)
    out = launch(frames_words, (dir_hi, dir_lo, off_hi, off_lo), plan,
                 _range_fields(plan, dual), precision)
    if frames_words.shape[0]:           # an empty batch launches nothing
        launches["packet_dual" if dual else "packet"] += 1
    return out if dual else out[0]


def unpack_project_packet(frame_words: torch.Tensor, dir_hi: torch.Tensor,
                          dir_lo: torch.Tensor, off_hi: torch.Tensor,
                          off_lo: torch.Tensor, plan: DecodePlan, *,
                          precision: str = "dd") -> torch.Tensor:
    """One packet-layout frame (n_pkts, pkt_words) -> planar XYZ (3, h, w).
    Counterpart of the reference's unpack_project_pallas."""
    return unpack_project_packet_batched(
        frame_words[None], dir_hi, dir_lo, off_hi, off_lo, plan,
        precision=precision)[0]


def unpack_project(frame_words: torch.Tensor,
                   lut: Union[PlanarLut, XYZLutDevice], plan: DecodePlan, *,
                   precision: str = "dd") -> torch.Tensor:
    """Convenience wrapper: accepts a PlanarLut (preferred) or an
    XYZLutDevice; returns (h, w, 3)."""
    planar = unpack_project_packet(frame_words, *lut_planes(lut), plan,
                                   precision=precision)
    return planar.movedim(0, -1)
