"""Motion deskew methods: constant-velocity extrapolation and IMU
integration.

Rebuild of the reference deskew machinery (ref: ouster_mapping/src/
deskew_method.{h,cpp}:32-514): a DeskewMethod updates each scan's
per-column pose array before registration so points are motion-compensated.
The per-column SE(3) interpolation itself is the batched device op
(ops/pose.interp_pose).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo


def _interp_cols(scan: LidarScan, pose0: np.ndarray,
                 pose1: np.ndarray) -> None:
    # genuine f64: f32 interpolation quantizes km-scale trajectories
    # at the millimeter level (same fix as engine._interp_poses_along)
    from ..utils.pose_util import interp_pose_pair

    frac = np.linspace(0.0, 1.0, scan.w)
    scan.pose[:] = interp_pose_pair(frac, pose0, pose1)


class DeskewMethod:
    """Interface (ref: deskew_method.h:32)."""

    def update(self, scans: Sequence[Optional[LidarScan]]) -> None:
        raise NotImplementedError

    def set_last_pose(self, ts: int, pose: np.ndarray) -> None:
        raise NotImplementedError


class NoneDeskewMethod(DeskewMethod):
    def __init__(self):
        self._last_pose = np.eye(4)

    def update(self, scans) -> None:
        for s in scans:
            if s is not None:
                s.pose[:] = self._last_pose

    def set_last_pose(self, ts: int, pose: np.ndarray) -> None:
        self._last_pose = np.asarray(pose).reshape(4, 4).copy()


class ConstantVelocityDeskewMethod(DeskewMethod):
    """Extrapolate the last relative motion across the new scan's columns
    (ref: deskew_method.h:102, deskew_method.cpp)."""

    def __init__(self):
        self._last_ts: Optional[int] = None
        self._last_pose = np.eye(4)
        self._prev_ts: Optional[int] = None
        self._prev_pose: Optional[np.ndarray] = None

    def update(self, scans) -> None:
        anchor = next((s for s in scans if s is not None), None)
        if anchor is None:
            return
        if self._prev_pose is None or self._prev_ts is None or \
                self._last_ts is None or self._last_ts == self._prev_ts:
            for s in scans:
                if s is not None:
                    s.pose[:] = self._last_pose
            return

        t0 = anchor.first_valid_column_timestamp()
        t1 = anchor.last_valid_column_timestamp()
        if not t0:
            # no valid columns anywhere: extrapolating from ts=0 would
            # produce an astronomically-scaled garbage pose
            for s in scans:
                if s is not None:
                    s.pose[:] = self._last_pose
            return
        dt_hist = self._last_ts - self._prev_ts
        rel = np.linalg.solve(self._prev_pose, self._last_pose)
        # true SE(3) geodesic scaling: xi = log(rel), pose(a) =
        # last @ exp(a * xi) — scaling the raw translation as the exp
        # rho argument would NOT reproduce rel at a=1
        from ..utils.pose_util import _se3_exp64, _se3_log64

        xi = _se3_log64(rel)

        def pose_at(ts: int) -> np.ndarray:
            a = (ts - self._last_ts) / dt_hist
            return self._last_pose @ _se3_exp64(a * xi)

        for s in scans:
            if s is None:
                continue
            st = s.first_valid_column_timestamp() or t0
            en = s.last_valid_column_timestamp() or t1
            _interp_cols(s, pose_at(st), pose_at(en if en > st else st + 1))

    def set_last_pose(self, ts: int, pose: np.ndarray) -> None:
        self._prev_ts, self._prev_pose = self._last_ts, \
            (self._last_pose.copy() if self._last_ts is not None else None)
        self._last_ts = int(ts)
        self._last_pose = np.asarray(pose).reshape(4, 4).copy()


class InertialIntegrationImuDeskewMethod(DeskewMethod):
    """Gyro/accel integration between column timestamps
    (ref: deskew_method.h:133, deskew_method.cpp inertial integration)."""

    def __init__(self, infos: List[SensorInfo]):
        self._infos = infos
        self._last_ts: Optional[int] = None
        self._last_pose = np.eye(4)
        # gyro rates arrive in the IMU frame; rotate them into the body
        # frame via extrinsic @ imu_to_sensor (ref: deskew_method.cpp
        # imu_to_body)
        self._imu_to_body_R: List[np.ndarray] = []
        for info in infos:
            R = (np.asarray(info.extrinsic)[:3, :3]
                 @ np.asarray(info.imu_to_sensor_transform)[:3, :3]) \
                if info is not None else np.eye(3)
            self._imu_to_body_R.append(R)

    def update(self, scans) -> None:
        from .kiss_icp import se3_exp

        for k, s in enumerate(scans):
            if s is None:
                continue
            if not s.has_field(ChanField.IMU_GYRO) or \
                    not s.has_field(ChanField.IMU_TIMESTAMP):
                s.pose[:] = self._last_pose
                continue
            R_ib = (self._imu_to_body_R[k]
                    if k < len(self._imu_to_body_R) else np.eye(3))
            gyro = s.field(ChanField.IMU_GYRO) @ R_ib.T  # body frame
            imu_ts = s.field(ChanField.IMU_TIMESTAMP).astype(np.float64)
            valid = imu_ts > 0
            if valid.sum() < 2:
                s.pose[:] = self._last_pose
                continue
            gyro = np.deg2rad(gyro[valid])
            imu_ts = imu_ts[valid] * 1e-9
            col_ts = s.timestamp.astype(np.float64) * 1e-9

            # integrate gyro into incremental rotations at IMU rate, then
            # sample per column
            dts = np.diff(imu_ts)
            inc = np.zeros((len(imu_ts), 3))
            inc[1:] = np.cumsum(gyro[:-1] * dts[:, None], axis=0)
            col_rot = np.stack([
                np.interp(col_ts, imu_ts, inc[:, k]) for k in range(3)],
                axis=1)
            base = col_rot[max(len(col_rot) // 2, 0)]
            for c in range(s.w):
                s.pose[c] = self._last_pose @ se3_exp(
                    np.concatenate([np.zeros(3), col_rot[c] - base]))

    def set_last_pose(self, ts: int, pose: np.ndarray) -> None:
        self._last_ts = int(ts)
        self._last_pose = np.asarray(pose).reshape(4, 4).copy()


def make_deskew_method(name: str,
                       infos: Optional[List[SensorInfo]] = None
                       ) -> DeskewMethod:
    """Factory (ref: deskew_method.h:203 DeskewMethodFactory)."""
    name = (name or "none").lower()
    if name in ("none", "off"):
        return NoneDeskewMethod()
    if name in ("constant_velocity", "default"):
        return ConstantVelocityDeskewMethod()
    if name in ("imu", "inertial", "inertial_integration"):
        return InertialIntegrationImuDeskewMethod(infos or [])
    raise ValueError(f"unknown deskew method {name!r}")


class DeskewMethodFactory:
    """Named-method factory (ref: deskew_method.h:203
    DeskewMethodFactory::create)."""

    @staticmethod
    def create(name: str, **kwargs) -> DeskewMethod:
        return make_deskew_method(name, **kwargs)
