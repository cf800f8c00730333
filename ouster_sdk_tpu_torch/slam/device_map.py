"""KISS-ICP's local map kept on the device: DeviceICP's map.

VoxelHashMap (slam/kiss_icp.py) keeps the map in a Python dict and admits
points in a Python loop; DeviceVoxelMap keeps the same map as tensors on
its device and applies the same rules there, in float64:

- Storage in born order, the order voxels were first admitted in (the
  host dict's order): `keys` (V,) int64, packed voxel coordinates
  (ops.downsample.pack_voxel_coords); `pts` (V, max_points_per_voxel, 3)
  float64; `count` (V,) int32. Rows past V are capacity, grown
  geometrically.
- add_points: the candidates' voxels by IEEE division and floor; a stable
  sort (a voxel's candidates keep scan order); the groups' bounds; each
  group's row, by a searchsorted over a sorted copy of the map's keys; new
  voxels appended, those with two or more candidates first, then those with
  one, each in key order (the host map's order); then one launch of the
  admission kernel (kernels/voxel_map.py), one thread a voxel walking its
  candidates in order.
- remove_far_points: a voxel dies when its first point lies max_distance or
  farther from the origin; the survivors keep their order.
- `device_points()` gives the ICP the map without a copy to the device;
  `pointcloud()` and `_voxels` copy it out for the readers that need host
  arrays (the state export, SlamEngine.get_point_cloud, tests).

An update waits on the device three times: the copy in of the world
points, the count of new voxels with the points admitted, and the
survivors with the points they hold (the tracer's `map.host_syncs`);
`map.new_voxels` counts the voxels an update creates. The host keeps V and
the point total.
"""

from __future__ import annotations

import types
from typing import Mapping, Tuple

import numpy as np
import torch

from ..kernels.voxel_map import voxel_admit
from ..ops.downsample import pack_voxel_coords
from ..utils import profiling
from .kiss_icp import VoxelHashMap, _born_groups


class DeviceVoxelMap(VoxelHashMap):
    """VoxelHashMap with its storage as tensors on `device` (a
    torch.device): the same voxels, points and order, bit for bit."""

    def __init__(self, voxel_size: float, max_distance: float,
                 max_points_per_voxel: int, device: torch.device):
        self.device = device
        super().__init__(voxel_size, max_distance, max_points_per_voxel)

    def _init_storage(self) -> None:
        f64 = dict(dtype=torch.float64, device=self.device)
        # the divisor as a device tensor: CUDA turns division by a Python
        # scalar into multiplication by its reciprocal, which is not IEEE
        # division
        self._voxel_t = torch.full((), self.voxel_size, **f64)
        self._n = 0              # voxels
        self._points = 0         # points they hold
        self._keys = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self._pts = torch.zeros((0, self.max_points_per_voxel, 3), **f64)
        self._count = torch.zeros((0,), dtype=torch.int32, device=self.device)
        self._changed()

    def _changed(self) -> None:
        self._view = None
        self._arrays = None

    def _reserve(self, rows: int) -> None:
        """Room for `rows` voxels: at least double the capacity, the rows
        held copied over."""
        cap = self._keys.shape[0]
        if rows <= cap:
            return
        rows = max(rows, 2 * cap)
        n = self._n
        keys = torch.zeros((rows,), dtype=torch.int64, device=self.device)
        pts = torch.zeros((rows,) + tuple(self._pts.shape[1:]),
                          dtype=torch.float64, device=self.device)
        count = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        keys[:n], pts[:n], count[:n] = \
            self._keys[:n], self._pts[:n], self._count[:n]
        self._keys, self._pts, self._count = keys, pts, count

    @property
    def num_points(self) -> int:
        return self._points

    def clear(self) -> None:
        self._n = self._points = 0
        self._changed()

    def empty(self) -> bool:
        return self._n == 0

    def load(self, keys: np.ndarray, points: np.ndarray) -> None:
        vkeys, row, counts = _born_groups(keys)
        points = np.asarray(points, np.float64).reshape(-1, 3)
        cap = self.max_points_per_voxel
        if len(counts) and counts.max() > cap:
            raise ValueError(f"a voxel of {counts.max()} points; the map "
                             f"holds at most {cap} a voxel")
        order = np.argsort(row, kind="stable")
        slot = np.empty(len(row), np.int64)
        slot[order] = np.arange(len(row)) \
            - np.repeat(np.cumsum(counts) - counts, counts)
        pts = np.zeros((len(vkeys), cap, 3))
        pts[row, slot] = points
        self.clear()
        self._reserve(len(vkeys))
        n = len(vkeys)
        dev = self.device
        self._keys[:n] = torch.from_numpy(vkeys).to(dev)
        self._pts[:n] = torch.from_numpy(pts).to(dev)
        self._count[:n] = torch.from_numpy(counts.astype(np.int32)).to(dev)
        self._n, self._points = n, int(counts.sum())

    def _add(self, points: np.ndarray) -> None:
        dev, n, v = self.device, points.shape[0], self._n
        self._reserve(v + n)          # a call adds at most n voxels
        world = torch.from_numpy(
            np.ascontiguousarray(points, np.float64)).to(dev)
        profiling.count("map.host_syncs")       # the pageable copy in
        keys = pack_voxel_coords(
            torch.floor(world / self._voxel_t).to(torch.int64))
        keys, order = torch.sort(keys, stable=True)
        cand = world[order]
        # groups: the runs of one key; group g's bounds, key and size, and
        # g >= the number of groups left empty (size 0)
        first = torch.ones((n,), dtype=torch.bool, device=dev)
        first[1:] = keys[1:] != keys[:-1]
        gid = torch.cumsum(first, 0) - 1
        at = torch.arange(n, device=dev)
        starts = torch.zeros((n + 1,), dtype=torch.int64, device=dev) \
            .scatter_(0, torch.where(first, gid, n), at)[:n]
        sizes = torch.zeros((n,), dtype=torch.int32, device=dev) \
            .scatter_add_(0, gid, torch.ones_like(gid, dtype=torch.int32))
        group_keys = keys[starts]
        group = sizes > 0
        if v:
            held, held_row = torch.sort(self._keys[:v])
            pos = torch.searchsorted(held, group_keys).clamp_(max=v - 1)
            found = held[pos] == group_keys
            old = held_row[pos]
        else:
            found = torch.zeros((n,), dtype=torch.bool, device=dev)
            old = found.to(torch.int64)
        new = group & ~found
        multi = new & (sizes > 1)
        single = new & (sizes == 1)
        rank = torch.where(multi, torch.cumsum(multi, 0) - 1,
                           multi.sum() + torch.cumsum(single, 0) - 1)
        rows = torch.where(found, old, v + rank)
        rows = torch.where(group, rows, -1)
        added = voxel_admit(cand, starts, sizes, group_keys, rows, v,
                            self._map_resolution2, self._keys, self._pts,
                            self._count)
        n_new, n_added = torch.stack([new.sum(), added.sum()]).tolist()
        profiling.count("map.host_syncs")
        profiling.count("map.new_voxels", n_new)
        self._n += n_new
        self._points += n_added
        self._changed()

    def _remove_far(self, origin: np.ndarray) -> None:
        v = self._n
        if v == 0:
            return
        first = self._pts[:v, 0]
        # the host map's float64 sum, each operation rounded on its own
        dx, dy, dz = (first[:, k] - float(origin[k]) for k in range(3))
        alive = (dx * dx + dy * dy) + dz * dz \
            < self.max_distance * self.max_distance
        keep = torch.sort((~alive).to(torch.uint8), stable=True).indices
        survivors, points = torch.stack([
            alive.sum(), torch.where(alive, self._count[:v], 0).sum()
        ]).tolist()
        profiling.count("map.host_syncs")
        if survivors < v:
            keep = keep[:survivors]
            self._keys[:survivors] = self._keys[keep]
            self._pts[:survivors] = self._pts[keep]
            self._count[:survivors] = self._count[keep]
            self._n, self._points = survivors, points
            self._changed()

    def device_points(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The map for the ICP, on the device: every slot of the held
        voxels as float32 points (V * max_points_per_voxel, 3), voxel by
        voxel, and which slots hold a point (V * max_points_per_voxel,)
        bool. The points held come in pointcloud()'s order."""
        v, cap = self._n, self.max_points_per_voxel
        slot = torch.arange(cap, device=self.device)
        valid = slot[None, :] < self._count[:v, None]
        return (self._pts[:v].reshape(v * cap, 3).to(torch.float32),
                valid.reshape(v * cap))

    def _host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """keys, pts and count of the held voxels, copied to the host (a
        copy on the CPU too: the views must not follow later changes)."""
        v = self._n
        keys, pts, count = (t[:v].to("cpu", copy=True).numpy() for t in
                            (self._keys, self._pts, self._count))
        pts.flags.writeable = False
        return keys, pts, count

    def pointcloud(self) -> np.ndarray:
        if self._n == 0:
            return np.zeros((0, 3))
        _, pts, count = self._host()
        return pts[np.arange(pts.shape[1])[None, :] < count[:, None]]

    @property
    def _voxels(self) -> Mapping[int, np.ndarray]:
        """Voxel key -> its points (k, 3) float64, in born order: a
        read-only copy, made at the first read after a change."""
        if self._view is None:
            keys, pts, count = self._host()
            self._view = types.MappingProxyType({
                key: pts[r, :c] for r, (key, c) in enumerate(
                    zip(keys.tolist(), count.tolist()))})
        return self._view
