"""From-the-manual reference implementations of the core projections
(ref: python/src/ouster/sdk/examples/reference.py — same role: spell the
Software User Manual math out directly so users can audit the optimized
paths against it).

These are deliberately *plain*: one beam row at a time, every
intermediate named after the manual's symbols, no LUTs. They exist for
study and cross-checking — `ouster_sdk_tpu_torch.XYZLut` / `destagger`
are the production paths (device-accelerated), and the test suite
asserts these stay in agreement with them.
"""

from __future__ import annotations

import numpy as np

from .. import ChanField

MM_TO_M = 0.001


def xyz_proj_beam_to_sensor_transform(metadata, scan) -> np.ndarray:
    """Project a scan to sensor-frame points using the current manual's
    beam-to-lidar-transform formulation (fw 2.5/3.x sensors).

    For each beam u and measurement column v, with range r (mm):

        theta_enc = 2*pi * (1 - v / W)           (encoder angle)
        theta_az  = -2*pi * azimuth_u / 360      (beam azimuth offset)
        phi       =  2*pi * altitude_u / 360     (beam altitude)
        n         = ||(B[0,3], B[2,3])||         (beam origin offset,
                                                  B = beam_to_lidar_transform)

        x = (r - n) cos(theta_enc + theta_az) cos(phi) + B[0,3] cos(theta_enc)
        y = (r - n) sin(theta_enc + theta_az) cos(phi) + B[0,3] sin(theta_enc)
        z = (r - n) sin(phi) + B[2,3]

    then rotate/translate by lidar_to_sensor_transform and scale mm -> m.
    Zero ranges (no return) stay at the origin. Returns (H, W, 3) float64.
    """
    h, w = scan.h, scan.w
    rng = np.asarray(scan.field(ChanField.RANGE), dtype=np.float64)
    beam = metadata.beam_to_lidar_transform
    n = float(np.hypot(beam[0, 3], beam[2, 3]))

    theta_enc = 2.0 * np.pi * (1.0 - np.arange(w) / w)          # (W,)
    lidar = np.zeros((h, w, 4))
    lidar[..., 3] = 1.0
    for u in range(h):
        theta = theta_enc - 2.0 * np.pi * metadata.beam_azimuth_angles[u] / 360.0
        phi = 2.0 * np.pi * metadata.beam_altitude_angles[u] / 360.0
        r = rng[u]
        lidar[u, :, 0] = ((r - n) * np.cos(theta) * np.cos(phi)
                          + beam[0, 3] * np.cos(theta_enc))
        lidar[u, :, 1] = ((r - n) * np.sin(theta) * np.cos(phi)
                          + beam[0, 3] * np.sin(theta_enc))
        lidar[u, :, 2] = (r - n) * np.sin(phi) + beam[2, 3]
    lidar[rng == 0] = 0.0

    sensor = lidar @ metadata.lidar_to_sensor_transform.T
    return sensor[..., :3] * MM_TO_M


def xyz_proj_origin_to_origin_mm(metadata, scan) -> np.ndarray:
    """Project a scan using the legacy fw 2.0 manual formulation, where
    the beam origin offset is the scalar `lidar_origin_to_beam_origin_mm`
    (valid for OS-0/1/2 spinning sensors; returns zeros for OS-DOME,
    whose geometry this formula cannot express). Returns (H, W, 3) m.
    """
    h, w = scan.h, scan.w
    out = np.zeros((h, w, 3))
    if "OS-DOME" in metadata.prod_line:
        return out
    rng = np.asarray(scan.field(ChanField.RANGE), dtype=np.float64)
    n = float(metadata.lidar_origin_to_beam_origin_mm)

    theta_enc = 2.0 * np.pi * (1.0 - np.arange(w) / w)
    lidar = np.zeros((h, w, 4))
    lidar[..., 3] = 1.0
    for u in range(h):
        theta = theta_enc - 2.0 * np.pi * metadata.beam_azimuth_angles[u] / 360.0
        phi = 2.0 * np.pi * metadata.beam_altitude_angles[u] / 360.0
        r = rng[u]
        lidar[u, :, 0] = ((r - n) * np.cos(theta) * np.cos(phi)
                          + n * np.cos(theta_enc))
        lidar[u, :, 1] = ((r - n) * np.sin(theta) * np.cos(phi)
                          + n * np.sin(theta_enc))
        lidar[u, :, 2] = (r - n) * np.sin(phi)
    lidar[rng == 0] = 0.0

    sensor = lidar @ metadata.lidar_to_sensor_transform.T
    return sensor[..., :3] * MM_TO_M


def destagger(pixel_shift_by_row, field: np.ndarray) -> np.ndarray:
    """Destagger a staggered H x W field: circularly shift each beam row
    by its metadata pixel shift so every column shares one azimuth angle
    (the image-like representation). Reference semantics for
    `ouster_sdk_tpu_torch.destagger`.
    """
    field = np.asarray(field, dtype=np.float64)
    if len(pixel_shift_by_row) != field.shape[0]:
        raise ValueError(
            f"pixel_shift_by_row has {len(pixel_shift_by_row)} entries "
            f"for a {field.shape[0]}-row field")
    out = np.empty_like(field)
    for u, shift in enumerate(pixel_shift_by_row):
        out[u] = np.roll(field[u], int(shift))
    return out
