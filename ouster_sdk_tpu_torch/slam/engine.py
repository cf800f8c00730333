"""SLAM engine: KISS-ICP odometry over LidarScanSets with per-column pose
writeback, plus localization against a prior map.

Rebuild of the reference mapping layer (ref: ouster_mapping/src/
slam_engine.cpp:22, kiss_slam.cpp:72-128, kiss_localization.cpp,
deskew_method.cpp). The registration runs on the host (backend "host",
slam/kiss_icp.py) or on the device (backend "device", slam/device_icp.py:
the Gauss-Newton loop, and the map in slam/device_map.py). The device
backend also gathers the frame on its device (kernels/slam_gather.py), in
float64; the host backend gathers it in numpy. Preprocessing and
voxelization stay on the host for both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from ..kernels.slam_gather import slam_gather
from ..ops.fused import resolve_device
from ..ops.xyzlut import XYZLut, make_xyz_lut
from ..utils import profiling
from .device_icp import DeviceICP
from .kiss_icp import KissConfig, KissICP
from .time_correction import ActiveTimeCorrection


@dataclass
class SlamConfig:
    """(ref: slam_backend.h:18)"""

    min_range: float = 5.0
    max_range: float = 100.0
    voxel_size: float = -1.0  # <= 0: estimate from data
    initial_pose: Optional[np.ndarray] = None
    # "none" | "constant_velocity" | "imu_deskew" | "auto" (auto picks
    # IMU integration when scans carry IMU fields, else constant
    # velocity; ref: source_mapping.py --deskew-method)
    deskew: str = "constant_velocity"
    # registration backend: "host" (voxel-hash KissICP) or "device"
    # (slam/device_icp.py: the GN ICP loop and the voxel map on the device)
    backend: str = "host"


BACKENDS = ("host", "device")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        hint = (' (the device backend of this package is "device")'
                if backend == "tpu" else "")
        raise ValueError(f"unknown SLAM backend {backend!r}; expected one "
                         f"of {BACKENDS}{hint}")


def _make_icp(config: "SlamConfig", kiss_config: "KissConfig", device):
    """Registration-backend factory shared by SlamEngine and
    LocalizationEngine (config.backend: host voxel-hash vs device ICP)."""
    _check_backend(config.backend)
    if config.backend == "device":
        return DeviceICP(kiss_config, device=device)
    return KissICP(kiss_config)


def _interp_poses_along(t_frac: np.ndarray, pose0: np.ndarray,
                        pose1: np.ndarray) -> np.ndarray:
    """Per-column SE(3) interpolation pose0 -> pose1, genuinely f64 —
    f32 would quantize world coordinates to ~1 mm at 10 km."""
    from ..utils.pose_util import interp_pose_pair

    return interp_pose_pair(t_frac, pose0, pose1)


def determine_voxel_size(scans: Sequence[LidarScan],
                         default: float = 1.0) -> float:
    """Estimate voxel size from the scan's range distribution
    (ref: kiss_slam.cpp determine_voxel_size: scale with scene extent)."""
    ranges = []
    for s in scans:
        if s is None or not s.has_field(ChanField.RANGE):
            continue
        r = s.field(ChanField.RANGE)
        nz = r[r > 0]
        if nz.size:
            ranges.append(np.percentile(nz, 90) * 0.001)
    if not ranges:
        return default
    # ~1m voxels at 100m scale, smaller indoors
    return float(np.clip(np.mean(ranges) / 100.0, 0.05, 1.5))


def _first_frame_id(scans: Sequence[Optional[LidarScan]]
                    ) -> Optional[int]:
    """The frame id of the first scan of a set: the key of its spans."""
    return next((s.frame_id for s in scans if s is not None), None)


class SlamEngine:
    """Facade (ref: slam_engine.h:29): update(LidarScanSet) registers the
    scans and writes world per-column poses back into them. `device` is
    used by the device backend alone: CUDA when none is named (raises
    without a GPU); the host backend needs no device."""

    def __init__(self, infos: List[SensorInfo],
                 config: Optional[SlamConfig] = None, device=None):
        self.config = config or SlamConfig()
        _check_backend(self.config.backend)
        self.device = (resolve_device(device)
                       if self.config.backend == "device" else None)
        self.infos = infos
        self._luts: List[XYZLut] = [make_xyz_lut(i, use_extrinsics=True)
                                    for i in infos]
        # the device backend's gather: each LUT as (6, h, w) f64 planes on
        # the device, made at its first use, and one staging buffer
        # (pinned on CUDA) reused by every sensor and scan
        self._device_luts: List[Optional[torch.Tensor]] = [None] * len(infos)
        self._staging: Optional[torch.Tensor] = None
        self._kiss: Optional[KissICP] = None
        self._last_pose = (self.config.initial_pose.copy()
                           if self.config.initial_pose is not None
                           else np.eye(4))
        self._prev_pose: Optional[np.ndarray] = None
        self._voxel_size = self.config.voxel_size
        self._time_correction = ActiveTimeCorrection(infos)
        self._imu_deskew = None  # resolved on first update for auto

    def _ensure_kiss(self, scans: Sequence[Optional[LidarScan]]) -> KissICP:
        if self._kiss is None:
            if self._voxel_size <= 0:
                self._voxel_size = determine_voxel_size(
                    [s for s in scans if s is not None])
            self._kiss = _make_icp(self.config, KissConfig(
                voxel_size=self._voxel_size,
                min_range=self.config.min_range,
                max_range=self.config.max_range), self.device)
        return self._kiss

    # ------------------------------------------------------------------
    def _predict_poses(self, scans: Sequence[Optional[LidarScan]]) -> None:
        """Constant-velocity deskew: extrapolate last motion across the new
        scan's columns (ref: deskew_method.cpp
        ConstantVelocityDeskewMethod)."""
        with profiling.span("slam.predict", _first_frame_id(scans)):
            if self.config.deskew == "none" or self._prev_pose is None:
                for s in scans:
                    if s is not None:
                        s.pose[:] = self._last_pose
                return
            rel = np.linalg.solve(self._prev_pose, self._last_pose)
            # columns sweep one frame; extrapolate the same motion forward
            pose1 = self._last_pose @ rel
            for s in scans:
                if s is None:
                    continue
                w = s.w
                frac = np.linspace(0.0, 1.0, w, dtype=np.float64)
                s.pose[:] = _interp_poses_along(frac, self._last_pose, pose1)

    def _gather_frame(self, scans: Sequence[Optional[LidarScan]],
                      mid_pose_inv: np.ndarray) -> np.ndarray:
        """Valid world points from all sensors, relative to the mid pose
        (ref: kiss_slam.cpp:96-111 + core::dewarp), (N, 3) float64: on the
        engine's device for the device backend, in numpy for the host
        backend."""
        with profiling.span("slam.gather", _first_frame_id(scans)):
            if self.device is not None:
                return self._gather_on_device(scans, mid_pose_inv)
            pts = []
            for s, lut in zip(scans, self._luts):
                if s is None:
                    continue
                rng = s.field(ChanField.RANGE)
                xyz = lut(rng)  # (H, W, 3) staggered, sensor/extrinsic
                valid = (rng > 0) & ((s.status & 1)[None, :].astype(bool))
                r_m = rng * 0.001
                valid &= (r_m > self.config.min_range) & \
                    (r_m < self.config.max_range)
                # per-column pose relative to mid
                rel = np.einsum("ij,wjk->wik", mid_pose_inv, s.pose)
                world = np.einsum("wij,hwj->hwi", rel[:, :3, :3], xyz) \
                    + rel[None, :, :3, 3]
                pts.append(world[valid])
            if not pts:
                return np.zeros((0, 3))
            return np.concatenate(pts, axis=0)

    def _gather_on_device(self, scans: Sequence[Optional[LidarScan]],
                          mid_pose_inv: np.ndarray) -> np.ndarray:
        """The host path's points, gathered by kernels/slam_gather on the
        engine's device: a sensor's mid pose, column poses, RANGE and
        status copied in at once through the staging buffer, its count
        and then its points copied back (two waits a sensor)."""
        pts = []
        for k, s in enumerate(scans):
            if s is None:
                continue
            points, count = slam_gather(
                *self._stage(s, mid_pose_inv), self._device_lut(k),
                self.config.min_range, self.config.max_range)
            n = int(count[0])
            pts.append(points[:n].to("cpu", copy=True).numpy())
        profiling.count("slam.device_gathers")
        if not pts:
            return np.zeros((0, 3))
        return pts[0] if len(pts) == 1 else np.concatenate(pts, axis=0)

    def _stage(self, s: LidarScan, mid_pose_inv: np.ndarray):
        """mid_inv (4, 4) f64, poses (w, 4, 4) f64, range (h, w) and status
        (w,) int32 (the uint32 bits) of scan `s` on the engine's device,
        copied in from the staging buffer, whose previous copy has been
        waited for (the previous gather read its count)."""
        h, w = s.h, s.w
        sizes = (16 * 8, w * 16 * 8, h * w * 4, w * 4)
        nbytes = sum(sizes)
        if self._staging is None or self._staging.numel() < nbytes:
            self._staging = torch.empty(
                nbytes, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        host = self._staging[:nbytes].numpy()
        ends = np.cumsum(sizes).tolist()
        mid, poses, rng, status = (host[e - n:e]
                                   for n, e in zip(sizes, ends))
        mid.view(np.float64)[:] = mid_pose_inv.ravel()
        poses.view(np.float64).reshape(w, 4, 4)[:] = s.pose
        rng.view(np.uint32).reshape(h, w)[:] = s.field(ChanField.RANGE)
        status.view(np.uint32)[:] = s.status
        dev = self._staging[:nbytes].to(self.device, non_blocking=True)
        mid, poses, rng, status = (dev[e - n:e]
                                   for n, e in zip(sizes, ends))
        return (rng.view(torch.int32).view(h, w),
                status.view(torch.int32),
                poses.view(torch.float64).view(w, 4, 4),
                mid.view(torch.float64).view(4, 4))

    def _device_lut(self, k: int) -> torch.Tensor:
        """Sensor k's LUT on the engine's device: direction x, y, z, then
        offset x, y, z, each an (h, w) f64 plane."""
        lut = self._device_luts[k]
        if lut is None:
            host = self._luts[k]
            planes = np.ascontiguousarray(np.concatenate(
                [np.moveaxis(host.direction, -1, 0),
                 np.moveaxis(host.offset, -1, 0)]))
            lut = self._device_luts[k] = torch.from_numpy(planes).to(
                self.device)
        return lut

    def update(self, scan_set) -> None:
        """(ref: kiss_slam.cpp:72-128)"""
        scans = list(scan_set) if not isinstance(scan_set, LidarScan) \
            else [scan_set]
        kiss = self._ensure_kiss(scans)

        # reconcile sensor clocks (ref: kiss_slam.cpp:84
        # active_time_correction_.update)
        self._time_correction.update(scans)

        mode = (self.config.deskew or "none").lower()
        if mode in ("imu", "imu_deskew") or (mode == "auto" and any(
                s is not None and s.has_field(ChanField.IMU_GYRO)
                for s in scans)):
            if self._imu_deskew is None:
                from .deskew import InertialIntegrationImuDeskewMethod

                self._imu_deskew = InertialIntegrationImuDeskewMethod(
                    self.infos)
                self._imu_deskew.set_last_pose(0, self._last_pose)
            self._imu_deskew.update(scans)
        else:
            self._predict_poses(scans)

        # mid-scan column pose = registration anchor
        anchor = None
        for s in scans:
            if s is not None:
                anchor = s
                break
        if anchor is None:
            return
        mid_col = (anchor.first_valid_column()
                   + anchor.last_valid_column()) // 2
        mid_pose = anchor.pose[max(mid_col, 0)].copy()

        frame = self._gather_frame(scans, np.linalg.inv(mid_pose))
        if frame.shape[0] == 0:
            # restore timestamps before bailing: the scans flow on to
            # save/viz and must not keep the packet-offset shift
            self._time_correction.reset(scans)
            return

        frame = kiss.preprocess(frame)
        new_pose = kiss.register_frame(frame, mid_pose, update_map=True)

        # rebase per-column poses: col_pose' = new_pose @ mid^-1 @ col_pose
        fix = new_pose @ np.linalg.inv(mid_pose)
        for s in scans:
            if s is not None:
                s.pose[:] = np.einsum("ij,wjk->wik", fix, s.pose)

        self._time_correction.reset(scans)
        self._prev_pose = self._last_pose
        self._last_pose = new_pose
        if self._imu_deskew is not None:
            anchor_ts = int(anchor.first_valid_column_timestamp() or 0)
            self._imu_deskew.set_last_pose(anchor_ts, new_pose)

    def get_point_cloud(self) -> np.ndarray:
        if self._kiss is None:
            return np.zeros((0, 3))
        return self._kiss.local_map.pointcloud()

    @property
    def last_pose(self) -> np.ndarray:
        return self._last_pose


class LocalizationEngine(SlamEngine):
    """Registration against a fixed prior map — no map updates
    (ref: localization_engine.h:32, kiss_localization.cpp)."""

    def __init__(self, infos: List[SensorInfo], map_points: np.ndarray,
                 config: Optional[SlamConfig] = None, device=None):
        super().__init__(infos, config, device)
        if self._voxel_size <= 0:
            self._voxel_size = 1.0
        self._kiss = _make_icp(self.config, KissConfig(
            voxel_size=self._voxel_size,
            min_range=self.config.min_range,
            max_range=self.config.max_range), self.device)
        self._kiss.local_map.add_points(np.asarray(map_points,
                                                   dtype=np.float64))
        self._kiss._frame_count = 10  # never clear the prior map

    def update(self, scan_set) -> None:
        scans = list(scan_set) if not isinstance(scan_set, LidarScan) \
            else [scan_set]
        self._predict_poses(scans)
        anchor = next((s for s in scans if s is not None), None)
        if anchor is None:
            return
        mid_col = (anchor.first_valid_column()
                   + anchor.last_valid_column()) // 2
        mid_pose = anchor.pose[max(mid_col, 0)].copy()
        frame = self._gather_frame(scans, np.linalg.inv(mid_pose))
        if frame.shape[0] == 0:
            # restore timestamps before bailing: the scans flow on to
            # save/viz and must not keep the packet-offset shift
            self._time_correction.reset(scans)
            return
        frame = self._kiss.preprocess(frame)
        new_pose = self._kiss.register_frame(frame, mid_pose,
                                             update_map=False)
        fix = new_pose @ np.linalg.inv(mid_pose)
        for s in scans:
            if s is not None:
                s.pose[:] = np.einsum("ij,wjk->wik", fix, s.pose)
        self._prev_pose = self._last_pose
        self._last_pose = new_pose


@dataclass
class LocalizationConfig(SlamConfig):
    """LocalizationEngine options: SlamConfig plus the prior map source
    (ref: localization_backend.h:19-48)."""

    map_path: str = ""
