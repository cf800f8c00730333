"""ctypes binding of csrc/planar_project.cu and its launch checks.

The launch allocates the outputs, checks device, dtype, shape and
contiguity of every operand (the kernel takes nothing else), launches on
PyTorch's current stream and raises if the launch was refused. It does
not synchronize.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .build import bind, bit_mask, check_operand

#: Launch geometry (fpb, tx, ty, ry). A block is `tx` threads along w, 4
#: adjacent columns each (1 where a row does not start on a 16-byte
#: boundary: the launcher sees to that), by `ty` rows; it walks `ry` row
#: steps and in each loads its LUT values once and loops over `fpb` frames.
#: tx * ty is at most 256 (the kernel's launch bounds). The values are the
#: best of a sweep on an H100 at 128x2048, B=32 and B=128 (PERF.md §6).
TUNING = (8, 16, 16, 4)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
(_launch,) = bind("planar_project.cu", (
    "planar_project_launch", "planar_project",
    [_P, _P, _P, _P, _P, _P,            # pointers
     _I, _I, _I, _I, _I,                # B P h w schw
     _I, _I,                            # w1 w2
     _I, _U, _I, _I, _U, _I,            # bit/mask/up x2
     _I, _I,                            # status row, bit
     _I, _I,                            # dd dual
     _I, _I, _I, _I]))                  # fpb tx ty ry


def launch(planes: torch.Tensor, col_hdrs: torch.Tensor,
           lut_stack: torch.Tensor, poses: Optional[torch.Tensor],
           plan, fields: Sequence, idx: Sequence[int], precision: str
           ) -> Tuple[torch.Tensor, ...]:
    """planes (B, P, h, w) int32, col_hdrs (B, schw, w) int32, lut_stack
    (18, h, w) f32, poses (B, w, 4, 4) f32 on a 16-byte boundary (the
    bottom row of each is not read) or None; `fields` are the range
    FieldPlans (one or two) and `idx` their plane indices. Returns one
    (B, 3, h, w) f32 tensor per range field."""
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the planar kernel needs CUDA tensors, got "
                         f"{device}")
    if planes.ndim != 4 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (B, P, h, w) int32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    B, P, h, w = planes.shape
    if (h, w) != (plan.h, plan.w):
        raise ValueError(f"planes are {h}x{w}, plan is {plan.h}x{plan.w}")
    check_operand(planes, "planes", torch.int32, (B, P, h, w), device)
    check_operand(col_hdrs, "col_hdrs", torch.int32, (B, plan.schw, w), device)
    check_operand(lut_stack, "lut_stack", torch.float32, (18, h, w), device)
    if poses is not None:
        check_operand(poses, "poses", torch.float32, (B, w, 4, 4), device)
        if poses.data_ptr() % 16:
            raise ValueError("poses must start on a 16-byte boundary")

    outs = tuple(torch.empty((B, 3, h, w), dtype=torch.float32,
                             device=device) for _ in fields)
    if B == 0:
        return outs
    f1, f2 = fields[0], fields[-1]
    w1, w2 = idx[0], idx[-1]
    _launch(device, planes.data_ptr(), col_hdrs.data_ptr(),
            lut_stack.data_ptr(), None if poses is None else poses.data_ptr(),
            outs[0].data_ptr(), outs[-1].data_ptr(),
            B, P, h, w, plan.schw, w1, w2,
            f1.bit, bit_mask(f1.size), f1.upshift,
            f2.bit, bit_mask(f2.size), f2.upshift,
            plan.staged_status_word, plan.status_bit, int(precision == "dd"),
            int(len(fields) == 2), *TUNING)
    return outs
