"""KISS-ICP's admission rule for the device voxel map: the wrapper, its
kernel route and its plain version.

`voxel_admit(points, starts, sizes, group_keys, rows, fresh_from, res2,
keys, map_pts, count)` adds candidate points to the map held by
slam/device_map.DeviceVoxelMap, in place, and returns how many points each
group admitted. The candidates `points` (N, 3) f64 are sorted by voxel key
(a voxel's candidates in scan order); group g is points[starts[g]:
starts[g] + sizes[g]], one voxel's candidates, bound for map row rows[g]
(< 0: none). The map is `keys` (R,) int64, `map_pts` (R, cap, 3) f64 and
`count` (R,) int32; a row at or past `fresh_from` is a voxel this call
appends, and starts empty. Walking a group's candidates in order, a point
is admitted while the voxel holds fewer than cap points and none of them,
those admitted before it included, lies within the admission radius:
d2 < res2 rejects, d2 = ((dx * dx) + (dy * dy)) + (dz * dz), each operation
rounded on its own. That is VoxelHashMap.add_points (slam/kiss_icp.py) of
the host map, voxel by voxel; rows[g] gets the group's key, its count, and
`added[g]` the points it admitted.

A tensor on the CPU takes the plain PyTorch version `voxel_admit_reference`;
a CUDA tensor launches the hand-written kernel (kernels/csrc/voxel_map.cu,
one thread a group), or the wrapper raises. There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .build import bind, check_operand

#: Kernel launches, counted by the wrapper where it launches the CUDA
#: kernel and nowhere else.
launches: Dict[str, int] = {}

CASES = ("voxel_admit",)


def reset_launches() -> None:
    for case in CASES:
        launches[case] = 0


reset_launches()

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
(_launch,) = bind("voxel_map.cu", (
    "voxel_admit_launch", "voxel_admit",
    [_P, _P, _P, _P, _P, _L, _L, _I, _D, _P, _P, _P, _P]))


def voxel_admit_reference(points: torch.Tensor, starts: torch.Tensor,
                          sizes: torch.Tensor, group_keys: torch.Tensor,
                          rows: torch.Tensor, fresh_from: int, res2: float,
                          keys: torch.Tensor, map_pts: torch.Tensor,
                          count: torch.Tensor) -> torch.Tensor:
    """The plain version: the groups side by side, their k-th candidates
    tested together, k = 0, 1, ...: within a voxel the candidates still go
    one after another."""
    live = torch.nonzero(rows >= 0).squeeze(1)
    row = rows[live]
    cap = map_pts.shape[1]
    c0 = torch.where(row >= fresh_from, 0, count[row].to(torch.int64))
    c = c0.clone()
    first, size = starts[live], sizes[live].to(torch.int64)
    slot = torch.arange(cap, device=map_pts.device)
    for k in range(int(size.max()) if len(live) else 0):
        q = points[torch.minimum(first + k, first + size - 1)]    # (G, 3)
        d = map_pts[row] - q[:, None, :]                          # (G, cap, 3)
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        near = ((d2 < res2) & (slot < c[:, None])).any(dim=1)
        take = torch.nonzero((k < size) & (c < cap) & ~near).squeeze(1)
        map_pts[row[take], c[take]] = q[take]
        c[take] += 1
    keys[row] = group_keys[live]
    count[row] = c.to(torch.int32)
    added = torch.zeros(rows.shape[0], dtype=torch.int32,
                        device=rows.device)
    added[live] = (c - c0).to(torch.int32)
    return added


def voxel_admit(points: torch.Tensor, starts: torch.Tensor,
                sizes: torch.Tensor, group_keys: torch.Tensor,
                rows: torch.Tensor, fresh_from: int, res2: float,
                keys: torch.Tensor, map_pts: torch.Tensor,
                count: torch.Tensor) -> torch.Tensor:
    """Admit `points` into the map (keys, map_pts, count), in place; returns
    added (G,) int32. CPU tensors take voxel_admit_reference; CUDA tensors
    launch the kernel (counted in launches["voxel_admit"]), with no host
    sync."""
    device = points.device
    if device.type == "cpu":
        return voxel_admit_reference(points, starts, sizes, group_keys, rows,
                                     fresh_from, res2, keys, map_pts, count)
    if device.type != "cuda":
        raise ValueError(f"voxel_admit runs on the CPU or CUDA, got {device}")
    n, g, r = points.shape[0], rows.shape[0], keys.shape[0]
    cap = map_pts.shape[1] if map_pts.dim() == 3 else -1
    check_operand(points, "points", torch.float64, (n, 3), device)
    for t, name, dtype in ((starts, "starts", torch.int64),
                           (sizes, "sizes", torch.int32),
                           (group_keys, "group_keys", torch.int64),
                           (rows, "rows", torch.int64)):
        check_operand(t, name, dtype, (g,), device)
    check_operand(keys, "keys", torch.int64, (r,), device)
    check_operand(map_pts, "map_pts", torch.float64, (r, cap, 3), device)
    check_operand(count, "count", torch.int32, (r,), device)
    added = torch.empty((g,), dtype=torch.int32, device=device)
    _launch(device, points.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
            group_keys.data_ptr(), rows.data_ptr(), g, int(fresh_from), cap,
            float(res2), keys.data_ptr(), map_pts.data_ptr(),
            count.data_ptr(), added.data_ptr())
    launches["voxel_admit"] += 1
    return added
