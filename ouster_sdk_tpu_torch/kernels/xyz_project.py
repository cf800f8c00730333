"""XYZLut's float64 projection on the card: the wrapper, its kernel route
and its plain version.

`xyz_project(range_, lut)` projects one range image to XYZ in float64:
r * direction + offset, 0 where r == 0, each product and sum rounded on
its own, so the result is ops/xyzlut.XYZLut.__call__'s (numpy's) bit for
bit.

Operands: range_ (h, w) int32 holding the uint32 bits, lut (2, h, w, 3)
f64 (XYZLut.direction, then XYZLut.offset). Returns (h, w, 3) f64 on the
operands' device. Nothing waits on the card.

A tensor on the CPU takes the plain PyTorch version
`xyz_project_reference`; a CUDA tensor launches the hand-written kernel
(kernels/csrc/xyz_project.cu, one thread an output double), or the
wrapper raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .build import bind, check_operand

#: Kernel launches, counted by the wrapper where it launches the CUDA
#: kernel (one a call) and nowhere else.
launches: Dict[str, int] = {}

CASES = ("xyz_project",)


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

_P = ctypes.c_void_p
(_launch,) = bind("xyz_project.cu", (
    "xyz_project_launch", "xyz_project", [_P, _P, ctypes.c_longlong, _P]))


def lut_tensor(direction: np.ndarray, offset: np.ndarray) -> torch.Tensor:
    """The (2, h, w, 3) f64 operand of an XYZLut's direction and offset,
    on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(
        np.stack([direction, offset]), dtype=np.float64))


def xyz_project_reference(range_: torch.Tensor, lut: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version, operation for operation the kernel's: the
    product and the sum are two operations, each rounded on its own."""
    r = (range_.to(torch.int64) & 0xFFFFFFFF).to(torch.float64)[..., None]
    xyz = r * lut[0]
    xyz = xyz + lut[1]
    return torch.where(r == 0, torch.zeros((), dtype=torch.float64,
                                           device=r.device), xyz)


def xyz_project(range_: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """XYZ of `range_` through `lut`, (h, w, 3) f64. CPU tensors take
    xyz_project_reference; CUDA tensors launch the kernel (counted in
    launches["xyz_project"]), with no host sync."""
    device = range_.device
    if device.type == "cpu":
        return xyz_project_reference(range_, lut)
    if device.type != "cuda":
        raise ValueError(f"xyz_project runs on the CPU or CUDA, got {device}")
    h, w = range_.shape if range_.dim() == 2 else (-1, -1)
    check_operand(range_, "range", torch.int32, (h, w), device)
    check_operand(lut, "lut", torch.float64, (2, h, w, 3), device)
    out = torch.empty((h, w, 3), dtype=torch.float64, device=device)
    _launch(device, range_.data_ptr(), lut.data_ptr(), h * w, out.data_ptr())
    launches["xyz_project"] += 1
    return out
