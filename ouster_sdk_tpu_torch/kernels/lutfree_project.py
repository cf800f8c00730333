"""ctypes binding of csrc/lutfree_project.cu and its launch checks.

Each launch allocates the outputs, checks device, dtype, shape and
contiguity of every operand (the kernels take nothing else), launches on
PyTorch's current stream and raises if the launch was refused. It does
not synchronize.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .build import load
from .planar_project import _check, _mask

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_PACKET_ARGTYPES = [_P, _P, _P, _P, _P,             # frames, rows, cols, outs
                    _I, _I, _I, _I, _I,             # B n_pkts pkt_words h w
                    _I, _I, _I, _I, _I,             # hw cw chw cpp pw
                    _I, _I, _U, _I, _I, _I, _U, _I,  # word/bit/mask/up x2
                    _I, _I,                         # status word, bit
                    _I, _I, _P]                     # dd dual stream
_PLANAR_ARGTYPES = [_P, _P, _P, _P, _P,             # planes hdrs rows cols out
                    _I, _I, _I, _I, _I,             # B P h w schw
                    _I, _I, _U, _I,                 # word bit mask up
                    _I, _I, _P]                     # status row, bit, stream


def _lib() -> ctypes.CDLL:
    lib = load("lutfree_project.cu")
    if lib.lutfree_packet_launch.argtypes is None:
        lib.lutfree_packet_launch.argtypes = _PACKET_ARGTYPES
        lib.lutfree_packet_launch.restype = ctypes.c_int
        lib.lutfree_planar_launch.argtypes = _PLANAR_ARGTYPES
        lib.lutfree_planar_launch.restype = ctypes.c_int
        lib.lutfree_project_error_string.argtypes = [ctypes.c_int]
        lib.lutfree_project_error_string.restype = ctypes.c_char_p
    return lib


def _check_tables(rows: torch.Tensor, cols: torch.Tensor, h: int, w: int,
                  device: torch.device) -> None:
    _check(rows, "tables.rows", torch.float32, (h, 36), device)
    _check(cols, "tables.cols", torch.float32, (w, 4), device)


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        msg = lib.lutfree_project_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def launch_packet(frames: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, plan, fields: Sequence, dd: bool
                  ) -> Tuple[torch.Tensor, ...]:
    """frames (B, n_pkts, pkt_words) int32; rows (h, 36) and cols (w, 4)
    f32, the packed factor tables; `fields` are the range FieldPlans (one,
    or two with dd). Returns one (B, 3, h, w) f32 tensor per range field."""
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"the LUT-free kernel needs CUDA tensors, got "
                         f"{device}")
    if len(fields) == 2 and not dd:
        raise ValueError("the f32 LUT-free kernel projects one return")
    B = frames.shape[0]
    h, w = plan.h, plan.w
    _check(frames, "frames", torch.int32, (B, plan.n_pkts, plan.pkt_words),
           device)
    _check_tables(rows, cols, h, w, device)

    outs = tuple(torch.empty((B, 3, h, w), dtype=torch.float32,
                             device=device) for _ in fields)
    if B == 0:
        return outs
    f1, f2 = fields[0], fields[-1]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.lutfree_packet_launch(
            frames.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            outs[0].data_ptr(), outs[-1].data_ptr(),
            B, plan.n_pkts, plan.pkt_words, h, w,
            plan.hw, plan.cw, plan.chw, plan.cpp, plan.pw,
            f1.word, f1.bit, _mask(f1.size), f1.upshift,
            f2.word, f2.bit, _mask(f2.size), f2.upshift,
            plan.status_word, plan.status_bit, int(dd),
            int(len(fields) == 2), stream)
    _raise_on(err, lib, "lutfree_packet")
    return outs


def launch_planar(planes: torch.Tensor, col_hdrs: torch.Tensor,
                  rows: torch.Tensor, cols: torch.Tensor, plan, field
                  ) -> torch.Tensor:
    """planes (B, pw, h, w) int32, col_hdrs (B, schw, w) int32, the packed
    factor tables, the RANGE FieldPlan. Returns (B, 3, h, w) f32."""
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the LUT-free kernel needs CUDA tensors, got "
                         f"{device}")
    B = planes.shape[0]
    h, w = plan.h, plan.w
    _check(planes, "planes", torch.int32, (B, plan.pw, h, w), device)
    _check(col_hdrs, "col_hdrs", torch.int32, (B, plan.schw, w), device)
    _check_tables(rows, cols, h, w, device)

    out = torch.empty((B, 3, h, w), dtype=torch.float32, device=device)
    if B == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.lutfree_planar_launch(
            planes.data_ptr(), col_hdrs.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), out.data_ptr(), B, plan.pw, h, w, plan.schw,
            field.word, field.bit, _mask(field.size), field.upshift,
            plan.staged_status_word, plan.status_bit, stream)
    _raise_on(err, lib, "lutfree_planar")
    return out
