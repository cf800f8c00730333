"""Viz accumulators: key-frame clouds, trajectory tracks, global map.

Rebuild of the reference accumulator stack (ref: python/src/ouster/sdk/viz/
{scans_accumulator,tracks_accumulator,map_accumulator,accumulators}.py):
ScansAccumulator keeps key-frame clouds by distance/count, TracksAccumulator
draws the trajectory, MapAccumulator maintains a voxel-downsampled global
map — all fed by scans whose per-column poses were written by SLAM.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence

import numpy as np

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..ops.downsample import voxel_downsample
from ..ops.xyzlut import make_xyz_lut


def _world_points(scan: LidarScan, lut, max_points: int = 0
                  ) -> np.ndarray:
    rng = scan.field(ChanField.RANGE)
    xyz = lut(rng)
    valid = rng > 0
    pts = xyz[valid]
    cols = np.broadcast_to(np.arange(scan.w)[None, :],
                           rng.shape)[valid]
    poses = scan.pose[cols]
    pts = np.einsum("nij,nj->ni", poses[:, :3, :3], pts) + poses[:, :3, 3]
    if max_points and pts.shape[0] > max_points:
        idx = np.linspace(0, pts.shape[0] - 1, max_points).astype(int)
        pts = pts[idx]
    return pts


class ScansAccumulator:
    """Key-frame cloud accumulation (ref: scans_accumulator.py):
    keep a scan when the sensor moved far enough or N scans elapsed."""

    def __init__(self, infos: Sequence[SensorInfo], *,
                 accum_max_num: int = 32,
                 accum_min_dist_meters: float = 2.0,
                 accum_min_dist_num: int = 0,
                 points_per_scan: int = 30_000):
        self._luts = [make_xyz_lut(i, use_extrinsics=True) for i in infos]
        self.max_num = accum_max_num
        self.min_dist = accum_min_dist_meters
        self.min_num = accum_min_dist_num
        self.points_per_scan = points_per_scan
        self.keyframes: List[np.ndarray] = []
        self._last_pose_t: Optional[np.ndarray] = None
        self._since_last = 0

    def accept(self, scans: Sequence[Optional[LidarScan]]) -> bool:
        anchor = next((s for s in scans if s is not None), None)
        if anchor is None:
            return False
        t = anchor.get_first_valid_column_pose()[:3, 3]
        take = self._last_pose_t is None
        if not take and self.min_dist > 0:
            take = np.linalg.norm(t - self._last_pose_t) >= self.min_dist
        if not take and self.min_num > 0:
            take = self._since_last >= self.min_num
        self._since_last += 1
        if not take:
            return False
        self._since_last = 0
        self._last_pose_t = t.copy()
        pts = [
            _world_points(s, lut, self.points_per_scan)
            for s, lut in zip(scans, self._luts) if s is not None]
        self.keyframes.append(np.concatenate(pts, axis=0)
                              if pts else np.zeros((0, 3)))
        if len(self.keyframes) > self.max_num:
            self.keyframes.pop(0)
        return True

    def points(self) -> np.ndarray:
        if not self.keyframes:
            return np.zeros((0, 3))
        return np.concatenate(self.keyframes, axis=0)


class TracksAccumulator:
    """Trajectory positions (ref: tracks_accumulator.py)."""

    def __init__(self, max_track_points: int = 100_000):
        self.max_points = max_track_points
        self._positions: List[np.ndarray] = []

    def accept(self, scans: Sequence[Optional[LidarScan]]) -> None:
        anchor = next((s for s in scans if s is not None), None)
        if anchor is None:
            return
        self._positions.append(
            anchor.get_first_valid_column_pose()[:3, 3].copy())
        if len(self._positions) > self.max_points:
            self._positions.pop(0)

    def points(self) -> np.ndarray:
        if not self._positions:
            return np.zeros((0, 3))
        return np.stack(self._positions)


class MapAccumulator:
    """Global voxel-downsampled map (ref: map_accumulator.py)."""

    def __init__(self, infos: Sequence[SensorInfo], *,
                 map_ratio: float = 1.0,
                 map_size: int = 1_500_000,
                 map_voxel_size: float = 0.0):
        self._luts = [make_xyz_lut(i, use_extrinsics=True) for i in infos]
        self.map_size = map_size
        self.voxel_size = map_voxel_size
        self.ratio = map_ratio
        self._points = np.zeros((0, 3))

    def accept(self, scans: Sequence[Optional[LidarScan]]) -> None:
        pts = [
            _world_points(s, lut)
            for s, lut in zip(scans, self._luts) if s is not None]
        if not pts:
            return
        new = np.concatenate(pts, axis=0)
        if 0 < self.ratio < 1.0:
            idx = np.linspace(0, new.shape[0] - 1,
                              int(new.shape[0] * self.ratio)).astype(int)
            new = new[idx]
        self._points = np.concatenate([self._points, new], axis=0)
        if self.voxel_size > 0:
            self._points, _ = voxel_downsample(self._points, self.voxel_size)
        if self._points.shape[0] > self.map_size:
            self._points = self._points[-self.map_size:]

    def points(self) -> np.ndarray:
        return self._points
