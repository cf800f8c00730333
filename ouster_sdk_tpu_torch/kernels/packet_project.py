"""ctypes binding of csrc/packet_project.cu and its launch checks.

The launch allocates the outputs, checks device, dtype, shape and
contiguity of every operand (the kernel takes nothing else), launches on
PyTorch's current stream and raises if the launch was refused. It does
not synchronize.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .build import bind, bit_mask, check_operand

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
(_launch,) = bind("packet_project.cu", (
    "packet_project_launch", "packet_project",
    [_P, _P, _P, _P, _P, _P, _P,        # frames, 4 LUT planes, outs
     _I, _I, _I, _I, _I,                # B n_pkts pkt_words h w
     _I, _I, _I, _I, _I,                # hw cw chw cpp pw
     _I, _I, _U, _I, _I, _I, _U, _I,    # word/bit/mask/up x2
     _I, _I,                            # status word, bit
     _I, _I]))                          # dd dual


def launch(frames: torch.Tensor, lut: Sequence[torch.Tensor], plan,
           fields: Sequence, precision: str) -> Tuple[torch.Tensor, ...]:
    """frames (B, n_pkts, pkt_words) int32; lut = (dir_hi, dir_lo, off_hi,
    off_lo), each (3, h, w) f32; `fields` are the range FieldPlans (one or
    two). Returns one (B, 3, h, w) f32 tensor per range field."""
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"the packet kernel needs CUDA tensors, got "
                         f"{device}")
    B = frames.shape[0]
    h, w = plan.h, plan.w
    check_operand(frames, "frames", torch.int32,
                  (B, plan.n_pkts, plan.pkt_words), device)
    for t, name in zip(lut, ("dir_hi", "dir_lo", "off_hi", "off_lo")):
        check_operand(t, name, torch.float32, (3, h, w), device)

    outs = tuple(torch.empty((B, 3, h, w), dtype=torch.float32,
                             device=device) for _ in fields)
    if B == 0:
        return outs
    f1, f2 = fields[0], fields[-1]
    _launch(device, frames.data_ptr(), *(t.data_ptr() for t in lut),
            outs[0].data_ptr(), outs[-1].data_ptr(),
            B, plan.n_pkts, plan.pkt_words, h, w,
            plan.hw, plan.cw, plan.chw, plan.cpp, plan.pw,
            f1.word, f1.bit, bit_mask(f1.size), f1.upshift,
            f2.word, f2.bit, bit_mask(f2.size), f2.upshift,
            plan.status_word, plan.status_bit, int(precision == "dd"),
            int(len(fields) == 2))
    return outs
