"""The ICP's nearest-neighbour search: the wrapper, its kernel route and
its plain version.

`icp_nn(src, map_pts, map_valid, voxel_size)` returns, for each query of
src (N, 3) f32, the squared distance to and the index of its nearest point
among the valid map points (M, 3) f32 whose voxel lies within Chebyshev
distance 1 of the query's (voxel = floor(p / voxel_size)): the 27-voxel
neighbourhood of the host VoxelHashMap. It is the counterpart of the JAX
package's slam/jax_icp.py `_chunked_nn` with voxel_size set, a
broadcast-reduce that XLA fuses there (no Pallas kernel).

A tensor on the CPU takes the plain PyTorch version `icp_nn_reference`; a
CUDA tensor launches the hand-written kernel (kernels/csrc/icp_nn.cu), or
the wrapper raises. There is no fallback from one to the other.

Numerics, which both repeat: d2 = ((dx * dx) + (dy * dy)) + (dz * dz), each
operation rounded on its own; voxels by IEEE division; ties to the lowest
index; best_d2 = +inf and best_idx = 0 where no map point is a candidate.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .build import load
from .planar_project import _check

#: Kernel launches, counted by the wrapper where it launches the CUDA
#: kernel and nowhere else.
launches: Dict[str, int] = {}

CASES = ("icp_nn",)

#: map points a chunk of the plain version, as the JAX package's _MAP_CHUNK
CHUNK = 8192


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, ctypes.c_float, _P, _P, _P, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = load("icp_nn.cu")
    if lib.icp_nn_launch.argtypes is None:
        lib.icp_nn_launch.argtypes = _ARGTYPES
        lib.icp_nn_launch.restype = ctypes.c_int
        lib.icp_nn_error_string.argtypes = [ctypes.c_int]
        lib.icp_nn_error_string.restype = ctypes.c_char_p
    return lib


def _voxels(p: torch.Tensor, voxel_size: float) -> torch.Tensor:
    # the divisor is a device tensor: CUDA turns division by a Python
    # scalar into multiplication by its reciprocal, which is not IEEE
    # division
    v = torch.tensor(voxel_size, dtype=torch.float32, device=p.device)
    return torch.floor(p / v).to(torch.int32)


def icp_nn_reference(src: torch.Tensor, map_pts: torch.Tensor,
                     map_valid: Optional[torch.Tensor], voxel_size: float,
                     chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: a running (best_d2, best_idx) over map chunks of
    `chunk` points, as the JAX package's _chunked_nn; the (N, chunk)
    distances of a chunk are materialized. The chunk does not change the
    result: the lowest index among the minima wins either way."""
    n, m = src.shape[0], map_pts.shape[0]
    device = src.device
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32,
                         device=device)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=device)
    if n == 0:
        return best_d2, best_idx
    src_vox = _voxels(src, voxel_size)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    for k0 in range(0, m, chunk):
        sl = map_pts[k0:k0 + chunk]
        dx = src[:, None, 0] - sl[None, :, 0]
        dy = src[:, None, 1] - sl[None, :, 1]
        dz = src[:, None, 2] - sl[None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        sl_vox = _voxels(sl, voxel_size)
        near = (src_vox[:, None, 0] - sl_vox[None, :, 0]).abs() <= 1
        for a in (1, 2):
            near &= (src_vox[:, None, a] - sl_vox[None, :, a]).abs() <= 1
        if map_valid is not None:
            near &= map_valid[None, k0:k0 + chunk]
        d2 = torch.where(near, d2, inf)
        cmin, cidx = d2.min(dim=1)        # first minimum: the lowest index
        upd = cmin < best_d2              # strict: earlier chunks keep ties
        best_d2 = torch.where(upd, cmin, best_d2)
        best_idx = torch.where(upd, cidx + k0, best_idx)
    return best_d2, best_idx


def icp_nn(src: torch.Tensor, map_pts: torch.Tensor,
           map_valid: Optional[torch.Tensor], voxel_size: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d2 (N,) f32, best_idx (N,) int64) of each query of src (N, 3)
    f32 over map_pts (M, 3) f32 (map_valid (M,) bool, or None: all valid).
    CPU tensors take icp_nn_reference; CUDA tensors launch the kernel."""
    device = src.device
    if device.type == "cpu":
        # chunks of about 4 M pairs bound the host's temporaries
        chunk = max(256, (1 << 22) // max(src.shape[0], 1))
        return icp_nn_reference(src, map_pts, map_valid, voxel_size, chunk)
    if device.type != "cuda":
        raise ValueError(f"icp_nn runs on the CPU or CUDA, got {device}")
    n, m = src.shape[0], map_pts.shape[0]
    _check(src, "src", torch.float32, (n, 3), device)
    _check(map_pts, "map_pts", torch.float32, (m, 3), device)
    if map_valid is not None:
        _check(map_valid, "map_valid", torch.bool, (m,), device)
    if not voxel_size > 0:
        raise ValueError(f"voxel_size must be positive, got {voxel_size}")
    if n >= 2**31 or m >= 2**31:
        raise ValueError("icp_nn takes fewer than 2**31 queries and points")
    keys = torch.empty((n,), dtype=torch.int64, device=device)
    best_d2 = torch.empty((n,), dtype=torch.float32, device=device)
    best_idx = torch.empty((n,), dtype=torch.int64, device=device)
    if n == 0:
        return best_d2, best_idx
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.icp_nn_launch(
            src.data_ptr(), n, map_pts.data_ptr(),
            None if map_valid is None else map_valid.data_ptr(), m,
            float(voxel_size), keys.data_ptr(), best_d2.data_ptr(),
            best_idx.data_ptr(), sms, stream)
    if err != 0:
        msg = lib.icp_nn_error_string(err).decode()
        raise RuntimeError(f"icp_nn launch failed: {msg} ({err})")
    launches["icp_nn"] += 1
    return best_d2, best_idx
