"""Extrinsics file resolution.

Rebuild of the reference's extrinsics utilities
(ref: python/src/ouster/sdk/util/extrinsics.py): supports a per-sensor
json file mapping serial numbers to 4x4 transforms, or a directory of
`<sn>.json` files.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..core.types import SensorInfo


def _parse_single(obj) -> Optional[np.ndarray]:
    arr = np.asarray(obj, dtype=np.float64)
    if arr.size == 16:
        return arr.reshape(4, 4)
    return None


def resolve_extrinsics(path: str, infos: List[SensorInfo]
                       ) -> List[Optional[np.ndarray]]:
    """Resolve an extrinsics source for each sensor; None when absent."""
    out: List[Optional[np.ndarray]] = [None] * len(infos)

    if os.path.isdir(path):
        for i, info in enumerate(infos):
            p = os.path.join(path, f"{info.sn}.json")
            if os.path.exists(p):
                with open(p) as f:
                    out[i] = _parse_single(json.load(f))
        return out

    if not os.path.exists(path):
        return out

    with open(path) as f:
        data = json.load(f)

    # layout 1: {"transforms": [{"source_frame": sn, "p_x": ..,
    #            "q_w": ..}, ...]} (reference multi-sensor calibration dump)
    if isinstance(data, dict) and "transforms" in data:
        by_sn = {}
        for t in data["transforms"]:
            sn = str(t.get("source_frame", ""))
            q = np.array([t.get("q_w", 1), t.get("q_x", 0),
                          t.get("q_y", 0), t.get("q_z", 0)], dtype=np.float64)
            p = np.array([t.get("p_x", 0), t.get("p_y", 0),
                          t.get("p_z", 0)], dtype=np.float64)
            w, x, y, z = q / np.linalg.norm(q)
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)],
            ])
            m = np.eye(4)
            m[:3, :3] = R
            m[:3, 3] = p
            by_sn[sn] = m
        for i, info in enumerate(infos):
            out[i] = by_sn.get(str(info.sn))
        return out

    # layout 2: {"<sn>": [16 floats], ...}
    if isinstance(data, dict):
        for i, info in enumerate(infos):
            if str(info.sn) in data:
                out[i] = _parse_single(data[str(info.sn)])
        return out

    # layout 3: a bare 16-element list applied to every sensor
    if isinstance(data, list):
        m = _parse_single(data)
        return [None if m is None else m.copy() for _ in infos]

    return out


def fov_vertical(info: SensorInfo) -> float:
    """Vertical FOV in degrees from beam altitude angles
    (ref: util/extrinsics.py:9-23)."""
    alt = np.asarray(info.beam_altitude_angles, dtype=np.float64)
    if np.count_nonzero(alt == 0.0) > 1:
        alt = alt[np.nonzero(alt)]
    fov = float(np.max(alt) - np.min(alt)) if alt.size else 0.0
    return 1.0 if fov < 1e-9 and alt.size > 1 else fov


def fov_horizontal(info: SensorInfo) -> float:
    """Horizontal FOV in degrees (360 for full-rotation sensors;
    ref: util/extrinsics.py:25-41)."""
    az = np.asarray(info.beam_azimuth_angles, dtype=np.float64)
    if az.size == info.format.pixels_per_column:
        return 360.0
    if np.count_nonzero(az == 0.0) > 1:
        az = az[np.nonzero(az)]
    fov = float(np.max(az) - np.min(az)) if az.size else 0.0
    return 1.0 if fov < 1e-9 else fov


def img_aspect_ratio(info: SensorInfo) -> float:
    """FOV_vertical / FOV_horizontal (ref: util/extrinsics.py:44-50)."""
    return fov_vertical(info) / fov_horizontal(info)


def quaternion_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion [w, x, y, z] -> 3x3 rotation (normalized first;
    ref: util/extrinsics.py:53-64 — same component order)."""
    qw, qx, qy, qz = np.asarray(q, np.float64).reshape(4)
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])


def rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion [w, x, y, z]
    (ref: util/extrinsics.py:67-98 — same component order, same
    4-branch numerically-stable conversion)."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    tr = np.trace(R)
    if tr > 0:
        s4 = 2.0 * np.sqrt(tr + 1.0)
        w = 0.25 * s4
        x = (R[2, 1] - R[1, 2]) / s4
        y = (R[0, 2] - R[2, 0]) / s4
        z = (R[1, 0] - R[0, 1]) / s4
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s4 = 2.0 * np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
        w = (R[2, 1] - R[1, 2]) / s4
        x = 0.25 * s4
        y = (R[0, 1] + R[1, 0]) / s4
        z = (R[0, 2] + R[2, 0]) / s4
    elif R[1, 1] > R[2, 2]:
        s4 = 2.0 * np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2])
        w = (R[0, 2] - R[2, 0]) / s4
        x = (R[0, 1] + R[1, 0]) / s4
        y = 0.25 * s4
        z = (R[1, 2] + R[2, 1]) / s4
    else:
        s4 = 2.0 * np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1])
        w = (R[1, 0] - R[0, 1]) / s4
        x = (R[0, 2] + R[2, 0]) / s4
        y = (R[1, 2] + R[2, 1]) / s4
        z = 0.25 * s4
    return np.array([w, x, y, z])


def position_quaternion_to_transform(p: np.ndarray,
                                     q: np.ndarray) -> np.ndarray:
    """Translation + quaternion [w, x, y, z] -> 4x4
    (ref: util/extrinsics.py:101-106)."""
    out = np.eye(4)
    out[:3, :3] = quaternion_to_rotation_matrix(q)
    out[:3, 3] = np.asarray(p, np.float64).reshape(3)
    return out


def euler_pose_to_matrix(pose) -> np.ndarray:
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


def euler_to_rotation_matrix(roll: float, pitch: float,
                             yaw: float) -> np.ndarray:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll), radians
    (ref: util/extrinsics.py:107-135, pose_conversion.cpp)."""
    return euler_pose_to_matrix([roll, pitch, yaw, 0, 0, 0])[:3, :3]


def xyzrpy_to_matrix(px, py, pz, r, p, y) -> np.ndarray:
    """Translation + euler angles (rad) -> 4x4
    (ref: util/extrinsics.py:137-152)."""
    return euler_pose_to_matrix([r, p, y, px, py, pz])


def xyzq_to_matrix(px, py, pz, qx, qy, qz, qw) -> np.ndarray:
    """Translation + quaternion (x,y,z,w args like the reference's CLI
    form) -> 4x4 (ref: util/extrinsics.py:154-169 — reorders to
    [w,x,y,z] internally)."""
    return position_quaternion_to_transform([px, py, pz],
                                            [qw, qx, qy, qz])


def parse_extrinsics_from_string(extrinsics: str, degrees: bool = True):
    """Parse CLI extrinsics: 'identity', a filename, 'X Y Z R P Y',
    'X Y Z QX QY QZ QW', or 16 row-major floats
    (ref: util/extrinsics.py:171-230). Returns a 4x4 matrix or the
    filename string."""
    sep = "," if "," in extrinsics else " "
    elements = extrinsics.split(sep)
    if len(elements) == 1:
        return np.eye(4) if elements[0] == "identity" else elements[0]
    try:
        vals = [float(e) for e in elements]
    except Exception:
        raise ValueError(
            f"extrinsics values: {elements} could not be parsed as numbers")
    if len(vals) == 6:
        rpy = [np.deg2rad(e) for e in vals[3:]] if degrees else vals[3:]
        return xyzrpy_to_matrix(*vals[:3], *rpy)
    if len(vals) == 7:
        return xyzq_to_matrix(*vals)
    if len(vals) == 16:
        return np.array(vals).reshape(4, 4)
    raise ValueError("Unsupported extrinsics format")
