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

from .build import load

#: Launch geometry. A block is `tx` threads along w, 4 adjacent columns
#: each (1 where a row does not start on a 16-byte boundary: the launcher
#: sees to that), by `ty` rows; it walks `ry` row steps and
#: in each loads its LUT values once and loops over `fpb` frames. tx * ty
#: is at most 256 (the kernel's launch bounds). The values are the best of
#: kernels/bench_planar.py's sweep on an H100 at 128x2048, B=32 and B=128.
TUNING = dict(fpb=8, tx=16, ty=16, ry=4)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ARGTYPES = [_P, _P, _P, _P, _P, _P,            # pointers
             _I, _I, _I, _I, _I,                # B P h w schw
             _I, _I,                            # w1 w2
             _I, _U, _I, _I, _U, _I,            # bit/mask/up x2
             _I, _I,                            # status row, bit
             _I, _I,                            # dd dual
             _I, _I, _I, _I,                    # fpb tx ty ry
             _P]                                # stream


def _lib() -> ctypes.CDLL:
    lib = load("planar_project.cu")
    if lib.planar_project_launch.argtypes is None:
        lib.planar_project_launch.argtypes = _ARGTYPES
        lib.planar_project_launch.restype = ctypes.c_int
        lib.planar_project_error_string.argtypes = [ctypes.c_int]
        lib.planar_project_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the frames on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mask(size: int) -> int:
    return (1 << size) - 1 if size < 32 else 0xFFFFFFFF


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
    _check(planes, "planes", torch.int32, (B, P, h, w), device)
    _check(col_hdrs, "col_hdrs", torch.int32, (B, plan.schw, w), device)
    _check(lut_stack, "lut_stack", torch.float32, (18, h, w), device)
    if poses is not None:
        _check(poses, "poses", torch.float32, (B, w, 4, 4), device)
        if poses.data_ptr() % 16:
            raise ValueError("poses must start on a 16-byte boundary")

    outs = tuple(torch.empty((B, 3, h, w), dtype=torch.float32,
                             device=device) for _ in fields)
    if B == 0:
        return outs
    f1, f2 = fields[0], fields[-1]
    w1, w2 = idx[0], idx[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.planar_project_launch(
            planes.data_ptr(), col_hdrs.data_ptr(), lut_stack.data_ptr(),
            None if poses is None else poses.data_ptr(),
            outs[0].data_ptr(), outs[-1].data_ptr(),
            B, P, h, w, plan.schw, w1, w2,
            f1.bit, _mask(f1.size), f1.upshift,
            f2.bit, _mask(f2.size), f2.upshift,
            plan.staged_status_word, plan.status_bit, int(precision == "dd"),
            int(len(fields) == 2), TUNING["fpb"], TUNING["tx"], TUNING["ty"],
            TUNING["ry"], stream)
    if err != 0:
        msg = lib.planar_project_error_string(err).decode()
        raise RuntimeError(f"planar_project launch failed: {msg} ({err})")
    return outs
