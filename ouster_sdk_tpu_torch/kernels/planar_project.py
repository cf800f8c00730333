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

#: Threads per block (columns of one row) and frames per block: each
#: thread loads its LUT values once and loops over FRAMES_PER_BLOCK frames.
THREADS = 128
FRAMES_PER_BLOCK = 8

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ARGTYPES = [_P, _P, _P, _P, _P, _P,            # pointers
             _I, _I, _I, _I, _I,                # B P h w schw
             _I, _I,                            # w1 w2
             _I, _U, _I, _I, _U, _I,            # bit/mask/up x2
             _I, _I,                            # status row, bit
             _I, _I, _I, _I, _P]                # dd dual fpb threads stream


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
           lut_stack: torch.Tensor, pose_planes: Optional[torch.Tensor],
           plan, fields: Sequence, idx: Sequence[int], precision: str
           ) -> Tuple[torch.Tensor, ...]:
    """planes (B, P, h, w) int32, col_hdrs (B, schw, w) int32, lut_stack
    (18, h, w) f32, pose_planes (B, 12, w) f32 (R row-major, then t) or
    None; `fields` are the range FieldPlans (one or two) and `idx` their
    plane indices. Returns one (B, 3, h, w) f32 tensor per range field."""
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
    if pose_planes is not None:
        _check(pose_planes, "pose_planes", torch.float32, (B, 12, w), device)

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
            None if pose_planes is None else pose_planes.data_ptr(),
            outs[0].data_ptr(), outs[-1].data_ptr(),
            B, P, h, w, plan.schw, w1, w2,
            f1.bit, _mask(f1.size), f1.upshift,
            f2.bit, _mask(f2.size), f2.upshift,
            plan.staged_status_word, plan.status_bit, int(precision == "dd"),
            int(len(fields) == 2), FRAMES_PER_BLOCK, THREADS, stream)
    if err != 0:
        msg = lib.planar_project_error_string(err).decode()
        raise RuntimeError(f"planar_project launch failed: {msg} ({err})")
    return outs
