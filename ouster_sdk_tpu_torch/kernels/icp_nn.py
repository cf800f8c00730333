"""The ICP's nearest-neighbour search: the wrapper, its kernel route and
its plain version.

`icp_nn(src, map_pts, map_valid, voxel_size)` returns, for each query of
src (N, 3) f32, the squared distance to and the index of its nearest point
among the valid map points (M, 3) f32 whose voxel lies within Chebyshev
distance 1 of the query's (voxel = floor(p / voxel_size)): the 27-voxel
neighbourhood of the host VoxelHashMap. It is the counterpart of the JAX
package's slam/jax_icp.py `_chunked_nn` with voxel_size set, a
broadcast-reduce that XLA fuses there (no Pallas kernel).

The map is fixed through a registration, so its index is built once:
`index = build_icp_index(map_pts, map_valid, voxel_size)`, then
`icp_nn(src, index=index)` for every Gauss-Newton iteration. The four-
argument form builds the index itself. On the card the index is a hash
table of the occupied voxels and the valid points packed voxel by voxel
(kernels/csrc/icp_nn.cu), and the search reads only the points of the 27
neighbour voxels; on the CPU the index is just the inputs.

A tensor on the CPU takes the plain PyTorch version `icp_nn_reference`; a
CUDA tensor launches the hand-written kernels, or the wrapper raises. There
is no fallback from one to the other.

Numerics, which both repeat: d2 = ((dx * dx) + (dy * dy)) + (dz * dz), each
operation rounded on its own; voxels by IEEE division; ties to the lowest
index; best_d2 = +inf and best_idx = 0 where no map point is a candidate.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .build import load
from .planar_project import _check

#: Kernel launches, counted by the wrapper where it launches the CUDA
#: kernel and nowhere else.
launches: Dict[str, int] = {}

CASES = ("icp_nn", "icp_nn_index")

#: map points a chunk of the plain version, as the JAX package's _MAP_CHUNK
CHUNK = 8192


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "icp_index_launch": [_P, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "icp_nn_search_launch": [_P, _I, _P, _P, _P, _I, _P, _F, _P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    lib = load("icp_nn.cu")
    if lib.icp_nn_search_launch.argtypes is None:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.icp_nn_error_string.argtypes = [ctypes.c_int]
        lib.icp_nn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.icp_nn_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


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


def table_slots(m: int) -> int:
    """Slots of the index's hash table for m points: the least power of two
    >= 2 m (and >= 2), so that at least half stay empty."""
    return max(2, 1 << max(0, 2 * m - 1).bit_length())


@dataclass
class IcpIndex:
    """A map made searchable by icp_nn: the inputs and, on the card, the
    hash table of its occupied voxels (`cells` (slots, 4) int32: the voxel
    and its point count; `starts` (slots,) int32: where its run begins in
    `points`), the valid points packed voxel by voxel (`points` (M, 4)
    f32: x, y, z and the original index's bits) and `meta` (2,) int32
    (whether a voxel coordinate lies 2**30 or more from 0; the runs'
    cursor). Tensors stay valid while the index lives."""

    map_pts: torch.Tensor
    map_valid: Optional[torch.Tensor]
    voxel_size: float
    cells: Optional[torch.Tensor] = None
    starts: Optional[torch.Tensor] = None
    points: Optional[torch.Tensor] = None
    meta: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.map_pts.device


def build_icp_index(map_pts: torch.Tensor,
                    map_valid: Optional[torch.Tensor], voxel_size: float
                    ) -> IcpIndex:
    """The index of map_pts (M, 3) f32 (map_valid (M,) bool, or None: all
    valid) at `voxel_size`, for icp_nn(src, index=...). On the CPU it holds
    the inputs; on CUDA four kernels build it (one call, counted in
    launches["icp_nn_index"]), with no host sync."""
    device = map_pts.device
    if not voxel_size > 0:
        raise ValueError(f"voxel_size must be positive, got {voxel_size}")
    if device.type == "cpu":
        return IcpIndex(map_pts, map_valid, float(voxel_size))
    if device.type != "cuda":
        raise ValueError(f"icp_nn runs on the CPU or CUDA, got {device}")
    m = map_pts.shape[0]
    _check(map_pts, "map_pts", torch.float32, (m, 3), device)
    if map_valid is not None:
        _check(map_valid, "map_valid", torch.bool, (m,), device)
    if m >= 2**29:
        raise ValueError("icp_nn takes fewer than 2**29 map points")
    slots = table_slots(m)
    i32 = dict(dtype=torch.int32, device=device)
    index = IcpIndex(map_pts, map_valid, float(voxel_size),
                     cells=torch.empty((slots, 4), **i32),
                     starts=torch.empty((slots,), **i32),
                     points=torch.empty((m, 4), dtype=torch.float32,
                                        device=device),
                     meta=torch.empty((2,), **i32))
    vox = torch.empty((m, 4), **i32)
    key = torch.empty((slots,), **i32)
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.icp_index_launch(
            map_pts.data_ptr(), None if map_valid is None
            else map_valid.data_ptr(), m, float(voxel_size), slots,
            vox.data_ptr(), key.data_ptr(), index.cells.data_ptr(),
            index.starts.data_ptr(), index.points.data_ptr(),
            index.meta.data_ptr(), sms, stream)
    _raise_on(lib, err, "icp_nn index")
    launches["icp_nn_index"] += 1
    return index


def icp_nn(src: torch.Tensor, map_pts: Optional[torch.Tensor] = None,
           map_valid: Optional[torch.Tensor] = None,
           voxel_size: Optional[float] = None, *,
           index: Optional[IcpIndex] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d2 (N,) f32, best_idx (N,) int64) of each query of src (N, 3)
    f32 over map_pts (M, 3) f32 (map_valid (M,) bool, or None: all valid)
    at voxel_size; or over a prebuilt `index` (build_icp_index), with the
    map arguments left out. CPU tensors take icp_nn_reference; CUDA
    tensors launch the search kernel (counted in launches["icp_nn"]), after
    the index's kernels when no index is given."""
    if (index is None) == (map_pts is None):
        raise ValueError("icp_nn takes map_pts and voxel_size, or index")
    device = src.device
    if index is not None:
        if index.device != device:
            raise ValueError(f"the index is on {index.device}, src on "
                             f"{device}")
        map_pts, map_valid = index.map_pts, index.map_valid
        voxel_size = index.voxel_size
    if device.type == "cpu":
        # chunks of about 4 M pairs bound the host's temporaries
        chunk = max(256, (1 << 22) // max(src.shape[0], 1))
        return icp_nn_reference(src, map_pts, map_valid, voxel_size, chunk)
    if device.type != "cuda":
        raise ValueError(f"icp_nn runs on the CPU or CUDA, got {device}")
    n = src.shape[0]
    _check(src, "src", torch.float32, (n, 3), device)
    if n >= 2**31:
        raise ValueError("icp_nn takes fewer than 2**31 queries")
    best_d2 = torch.empty((n,), dtype=torch.float32, device=device)
    best_idx = torch.empty((n,), dtype=torch.int64, device=device)
    if index is None:
        _check(map_pts, "map_pts", torch.float32, (map_pts.shape[0], 3),
               device)
    if n == 0:
        return best_d2, best_idx
    if index is None:
        index = build_icp_index(map_pts, map_valid, voxel_size)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        lib = _lib()
        err = lib.icp_nn_search_launch(
            src.data_ptr(), n, index.cells.data_ptr(),
            index.starts.data_ptr(), index.points.data_ptr(),
            index.cells.shape[0], index.meta.data_ptr(), index.voxel_size,
            best_d2.data_ptr(), best_idx.data_ptr(), stream)
    _raise_on(lib, err, "icp_nn")
    launches["icp_nn"] += 1
    return best_d2, best_idx
