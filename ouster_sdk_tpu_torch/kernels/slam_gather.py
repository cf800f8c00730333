"""The SLAM frame gather of the device backend: the wrapper, its kernel
route and its plain version.

`slam_gather(range_, status, poses, mid_inv, lut, min_range, max_range)`
gathers one sensor's scan in float64: the pixels with a return whose
column is valid and whose range r * 0.001 m lies strictly between
min_range and max_range, projected through the LUT (r * direction +
offset) and moved by their column's pose relative to the mid pose
(mid_inv @ poses[w]), in row-major (h, w) order. That is
slam/engine.SlamEngine._gather_frame's host path for one sensor (numpy's
`world[valid]`), with the same mask and projection bit for bit.

Operands: range_ (h, w) and status (w,) int32 holding the uint32 bits,
poses (w, 4, 4) and mid_inv (4, 4) f64, lut (6, h, w) f64 (direction x, y,
z, then offset x, y, z). Returns (points, count): points (n, 3) f64 whose
first count[0] rows are the gathered points, count a (1,) int32 tensor on
the operands' device. Nothing waits on the card.

A tensor on the CPU takes the plain PyTorch version
`slam_gather_reference`; a CUDA tensor launches the hand-written kernels
(kernels/csrc/slam_gather.cu: per-tile counts, a scan and the write, one
C call), or the wrapper raises. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .build import bind, check_operand

#: Kernel launches, counted by the wrapper where it launches the CUDA
#: kernels (one a call) and nowhere else.
launches: Dict[str, int] = {}

CASES = ("slam_gather",)

#: columns of a tile in the kernel: one warp (kernels/csrc/slam_gather.cu)
TILE_W = 32


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
(_launch,) = bind("slam_gather.cu", (
    "slam_gather_launch", "slam_gather",
    [_P, _P, _P, _P, _P, _I, _I, _D, _D, _P, _P, _P]))


def slam_gather_reference(range_: torch.Tensor, status: torch.Tensor,
                          poses: torch.Tensor, mid_inv: torch.Tensor,
                          lut: torch.Tensor, min_range: float,
                          max_range: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, operation for operation the kernel's: each
    product and sum rounded on its own, in the kernel's order."""
    r = range_.to(torch.int64) & 0xFFFFFFFF
    r_m = r.to(torch.float64) * 0.001
    valid = (r > 0) & ((status.to(torch.int64) & 1) != 0)[None, :] \
        & (r_m > min_range) & (r_m < max_range)
    # rel[w] = mid_inv @ poses[w], ((m0 P0 + m1 P1) + m2 P2) + m3 P3
    rel = mid_inv[None, :, 0, None] * poses[:, None, 0, :]
    for m in range(1, 4):
        rel = rel + mid_inv[None, :, m, None] * poses[:, None, m, :]
    hh, ww = torch.nonzero(valid, as_tuple=True)        # row-major order
    rv = r[hh, ww].to(torch.float64)
    x, y, z = (rv * lut[c, hh, ww] + lut[3 + c, hh, ww] for c in range(3))
    R = rel[ww]
    points = torch.stack([((R[:, i, 0] * x + R[:, i, 1] * y)
                           + R[:, i, 2] * z) + R[:, i, 3]
                          for i in range(3)], dim=1)
    count = torch.tensor([points.shape[0]], dtype=torch.int32,
                         device=points.device)
    return points, count


def slam_gather(range_: torch.Tensor, status: torch.Tensor,
                poses: torch.Tensor, mid_inv: torch.Tensor,
                lut: torch.Tensor, min_range: float, max_range: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sensor's valid world points relative to the mid pose: (points,
    count), the first count[0] rows of points. CPU tensors take
    slam_gather_reference; CUDA tensors launch the kernels (counted in
    launches["slam_gather"]), with no host sync."""
    device = range_.device
    if device.type == "cpu":
        return slam_gather_reference(range_, status, poses, mid_inv, lut,
                                     min_range, max_range)
    if device.type != "cuda":
        raise ValueError(f"slam_gather runs on the CPU or CUDA, got {device}")
    h, w = range_.shape if range_.dim() == 2 else (-1, -1)
    check_operand(range_, "range", torch.int32, (h, w), device)
    check_operand(status, "status", torch.int32, (w,), device)
    check_operand(poses, "poses", torch.float64, (w, 4, 4), device)
    check_operand(mid_inv, "mid_inv", torch.float64, (4, 4), device)
    check_operand(lut, "lut", torch.float64, (6, h, w), device)
    tiles = torch.empty((h * -(-w // TILE_W),), dtype=torch.int32,
                        device=device)
    points = torch.empty((h * w, 3), dtype=torch.float64, device=device)
    count = torch.empty((1,), dtype=torch.int32, device=device)
    _launch(device, range_.data_ptr(), status.data_ptr(), poses.data_ptr(),
            mid_inv.data_ptr(), lut.data_ptr(), h, w, float(min_range),
            float(max_range), tiles.data_ptr(), points.data_ptr(),
            count.data_ptr())
    launches["slam_gather"] += 1
    return points, count
