"""Pose utilities at the Python API surface.

Rebuild of the reference numpy pose helpers (ref: python/src/ouster/sdk/
util/pose_util.py): log/exp maps, pose (de)composition, trajectory
evaluation at query timestamps, and dewarp — thin host wrappers over the
tensor ops in ops/pose.py. The wrappers that evaluate on a device
(exp_pose6, log_pose, pose_interp, Trajectory.pose_at) take `device`:
CUDA when none is named (raises without a GPU); pass device="cpu" to stay
on the host.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops import pose as _ops
from ..ops.fused import resolve_device

Numeric = Union[np.ndarray, Sequence[float]]


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def exp_pose6(xi: Numeric, device=None) -> np.ndarray:
    """se(3) (rot, trans) -> 4x4 (float64), computed in float32."""
    device = resolve_device(device)
    return _ops.exp_pose(_f32(xi, device)).cpu().numpy().astype(np.float64)


def log_pose(T: Numeric, device=None) -> np.ndarray:
    device = resolve_device(device)
    return _ops.log_pose(_f32(T, device)).cpu().numpy().astype(np.float64)


def pose_interp(t, pose0: Numeric, pose1: Numeric,
                device=None) -> np.ndarray:
    device = resolve_device(device)
    return _ops.interp_pose(_f32(t, device), _f32(pose0, device),
                            _f32(pose1, device)).cpu().numpy() \
        .astype(np.float64)


def dewarp(points: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """(ref: pose_util.py dewarp): points (..., W, 3) x poses (W, 4, 4)."""
    return _ops.dewarp_np(np.asarray(points, np.float64),
                          np.asarray(poses, np.float64))


def transform(points: np.ndarray, pose: np.ndarray) -> np.ndarray:
    return _ops.transform_np(np.asarray(points, np.float64),
                             np.asarray(pose, np.float64))


def euler_pose_to_matrix(pose: Numeric) -> np.ndarray:
    """(roll, pitch, yaw, x, y, z) -> 4x4 homogeneous matrix; rotation
    applied yaw*pitch*roll (ref: pose_conversion.cpp:7-27)."""
    roll, pitch, yaw, x, y, z = np.asarray(pose, np.float64).reshape(6)
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    out = np.eye(4)
    out[:3, :3] = rz @ ry @ rx
    out[:3, 3] = (x, y, z)
    return out


def quaternion_pose_to_matrix(pose: Numeric) -> np.ndarray:
    """(qw, qx, qy, qz, x, y, z) -> 4x4 homogeneous matrix; the
    quaternion is normalized first (ref: pose_conversion.cpp:29-48)."""
    qw, qx, qy, qz, x, y, z = np.asarray(pose, np.float64).reshape(7)
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    out = np.eye(4)
    out[:3, :3] = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])
    out[:3, 3] = (x, y, z)
    return out


def _so3_log64(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2.0
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _se3_exp64(xi: np.ndarray) -> np.ndarray:
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        R = np.eye(3) + K + K @ K / 2.0
        V = np.eye(3) + K / 2.0 + K @ K / 6.0
    else:
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th**2 * (K @ K))
        V = (np.eye(3) + (1 - np.cos(th)) / th**2 * K
             + (th - np.sin(th)) / th**3 * (K @ K))
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = V @ v
    return out


def _se3_log64(T: np.ndarray) -> np.ndarray:
    w = _so3_log64(T[:3, :3])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        Vinv = np.eye(3) - K / 2.0 + K @ K / 12.0
    else:
        Vinv = (np.eye(3) - K / 2.0
                + (1.0 - th * np.cos(th / 2.0) / (2.0 * np.sin(th / 2.0)))
                / th**2 * (K @ K))
    return np.concatenate([w, Vinv @ T[:3, 3]])


def interp_pose(x_interp: Numeric, x_known: Numeric,
                poses_known: Numeric) -> np.ndarray:
    """Interpolate 4x4 poses at query x values, double precision
    (ref: processing.cpp:848-862 "interp_pose" binding over
    pose_util.h interp_pose<double, double>). Out-of-range queries
    extrapolate along the first/last interval."""
    x_interp = np.asarray(x_interp, np.float64).reshape(-1)
    x_known = np.asarray(x_known, np.float64).reshape(-1)
    P = np.asarray(poses_known, np.float64).reshape(-1, 4, 4)
    if len(x_known) != len(P):
        raise ValueError("x_known and poses_known length mismatch")
    if len(x_known) == 0:
        raise ValueError("empty trajectory")
    if len(x_known) == 1:
        return np.broadcast_to(P[0], (len(x_interp), 4, 4)).copy()
    idx = np.clip(np.searchsorted(x_known, x_interp, side="right") - 1,
                  0, len(x_known) - 2)
    out = np.empty((len(x_interp), 4, 4))
    for i, (q, k) in enumerate(zip(x_interp, idx)):
        t0, t1 = x_known[k], x_known[k + 1]
        f = (q - t0) / (t1 - t0 if t1 != t0 else 1.0)
        rel = np.linalg.solve(P[k], P[k + 1])
        out[i] = P[k] @ _se3_exp64(f * _se3_log64(rel))
    return out


def interp_pose_float(x_interp: Numeric, x_known: Numeric,
                      poses_known: Numeric) -> np.ndarray:
    """Float-pose variant of interp_pose (ref: processing.cpp:863-878)."""
    return interp_pose(x_interp, x_known,
                       np.asarray(poses_known, np.float64)
                       ).astype(np.float32)


class Trajectory:
    """Pose trajectory with timestamped knots, evaluable at arbitrary
    timestamps (ref: pose_util.py TrajectoryEvaluator). pose_at evaluates
    on `device` (CUDA when none is named; raises without a GPU)."""

    def __init__(self, timestamps: np.ndarray, poses: np.ndarray,
                 device=None):
        order = np.argsort(np.asarray(timestamps))
        self.timestamps = np.asarray(timestamps, dtype=np.int64)[order]
        self.poses = np.asarray(poses, dtype=np.float64).reshape(
            -1, 4, 4)[order]
        if len(self.timestamps) < 1:
            raise ValueError("trajectory needs at least one knot")
        self.device = device

    def pose_at(self, ts) -> np.ndarray:
        """Evaluate at ts (scalar or array); out-of-range queries
        extrapolate along the first/last interval (reference semantics).
        Times are converted to frame-local seconds before f32 interp."""
        ts = np.atleast_1d(np.asarray(ts, dtype=np.int64))
        if len(self.timestamps) == 1:
            out = np.broadcast_to(self.poses[0], (ts.size, 4, 4)).copy()
            return out if ts.size > 1 else out[0]

        base = self.timestamps[0]
        knots_s = (self.timestamps - base) * 1e-9
        query_s = (ts - base) * 1e-9
        device = resolve_device(self.device)
        out = _ops.interp_trajectory(
            _f32(query_s, device), _f32(knots_s, device),
            _f32(self.poses, device)).cpu().numpy().astype(np.float64)
        return out if ts.size > 1 else out[0]

    def dewarp_scan(self, scan) -> None:
        """Write interpolated per-column poses into a scan."""
        ts = scan.timestamp.astype(np.int64)
        valid = scan.status.astype(bool) & (ts > 0)
        if valid.any():
            scan.pose[valid] = self.pose_at(ts[valid])


def get_rot_matrix_to_align_to_gravity(accel_x: float, accel_y: float,
                                       accel_z: float) -> np.ndarray:
    """Rotation aligning the measured gravity (accelerometer mean) with
    [0, 0, 1], yaw fixed to zero (ref: sdk/util/pose_util.py:636
    get_rot_matrix_to_align_to_gravity — Rodrigues + counter-yaw)."""
    g = np.array([0.0, 0.0, 1.0])
    a = np.array([accel_x, accel_y, accel_z], dtype=np.float64)
    a = a / np.linalg.norm(a)
    axis = np.cross(a, g)
    n = np.linalg.norm(axis)
    if n > 0:
        axis = axis / n
    angle = np.arccos(np.clip(np.dot(a, g), -1.0, 1.0))
    K = np.array([[0.0, -axis[2], axis[1]],
                  [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    R_align = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    fwd = R_align @ np.array([1.0, 0.0, 0.0])
    yaw = np.arctan2(fwd[1], fwd[0])
    c, s = np.cos(-yaw), np.sin(-yaw)
    R_yaw = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return R_yaw @ R_align


def load_kitti_poses(path: str) -> np.ndarray:
    """(ref: slam_util.cpp KITTI import): (N, 4, 4) from N x 12 rows."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.broadcast_to(np.eye(4), (rows.shape[0], 4, 4)).copy()
    out[:, :3, :] = rows
    return out


def _se3_exp64_batch(xi: np.ndarray) -> np.ndarray:
    """Vectorized f64 SE(3) exp for (N, 6) twists (rot, trans)."""
    xi = np.asarray(xi, np.float64).reshape(-1, 6)
    w, v = xi[:, :3], xi[:, 3:]
    n = len(xi)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -w[:, 2], w[:, 1]
    K[:, 1, 0], K[:, 1, 2] = w[:, 2], -w[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -w[:, 1], w[:, 0]
    th = np.linalg.norm(w, axis=1)
    small = th < 1e-10
    ts = np.where(small, 1.0, th)
    A = np.where(small, 1.0, np.sin(th) / ts)[:, None, None]
    B = np.where(small, 0.5, (1 - np.cos(th)) / ts**2)[:, None, None]
    C = np.where(small, 1.0 / 6.0,
                 (th - np.sin(th)) / ts**3)[:, None, None]
    K2 = K @ K
    eye = np.eye(3)[None]
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = (V @ v[:, :, None])[:, :, 0]
    return T


def interp_pose_pair(fracs: np.ndarray, pose0: np.ndarray,
                     pose1: np.ndarray) -> np.ndarray:
    """Geodesic pose0 -> pose1 at each fraction, full float64
    (ref: pose_util.h:207-232 semantics). Vectorized over fracs —
    used for per-column deskew poses where f32 would quantize
    kilometer-scale trajectories to millimeters."""
    pose0 = np.asarray(pose0, np.float64)
    pose1 = np.asarray(pose1, np.float64)
    xi = _se3_log64(np.linalg.solve(pose0, pose1))
    fr = np.asarray(fracs, np.float64).reshape(-1)
    return pose0[None] @ _se3_exp64_batch(fr[:, None] * xi[None])
