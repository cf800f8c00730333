"""Range to XYZ in float64, written from Ouster's published formula (sensor
documentation, "Lidar Range to XYZ"): for beam i at measurement id m of a
w-column frame, with encoder angle theta_e = 2 pi (1 - m / w), azimuth
theta_a = -2 pi az_i / 360, altitude phi = 2 pi alt_i / 360 and the beam
origin (bx, bz) of beam_to_lidar_transform, n = |(bx, bz)|:

    x = (r - n) cos(theta_e + theta_a) cos(phi) + bx cos(theta_e)
    y = (r - n) sin(theta_e + theta_a) cos(phi) + bx sin(theta_e)
    z = (r - n) sin(phi) + bz

in the lidar frame (mm), then lidar_to_sensor_transform, then metres.
A zero range has no point: its XYZ is 0. Staggered (packet) column order.
"""

from __future__ import annotations

import numpy as np


def _matrix(values) -> np.ndarray:
    return np.asarray(values, np.float64).reshape(4, 4)


class Lut:
    """The formula's angle tables for one sensor's metadata."""

    def __init__(self, metadata: dict):
        fmt = metadata["lidar_data_format"]
        beams = metadata["beam_intrinsics"]
        w = int(fmt["columns_per_frame"])
        b2l = _matrix(beams["beam_to_lidar_transform"])
        l2s = _matrix(
            metadata["lidar_intrinsics"]["lidar_to_sensor_transform"])
        self.bx, self.bz = b2l[0, 3], b2l[2, 3]
        self.n = np.hypot(self.bx, self.bz)
        theta_e = 2 * np.pi * (1 - np.arange(w) / w)                 # (w,)
        theta_a = -2 * np.pi * np.asarray(beams["beam_azimuth_angles"]) / 360
        phi = 2 * np.pi * np.asarray(beams["beam_altitude_angles"]) / 360
        ang = theta_e[None, :] + theta_a[:, None]                     # (h, w)
        self.cx = np.cos(ang) * np.cos(phi)[:, None]
        self.cy = np.sin(ang) * np.cos(phi)[:, None]
        self.sz = np.sin(phi)[:, None]
        self.ex, self.ey = self.bx * np.cos(theta_e), self.bx * np.sin(theta_e)
        self.rot, self.trans = l2s[:3, :3], l2s[:3, 3]

    def __call__(self, ranges: np.ndarray) -> np.ndarray:
        """ranges (h, w) in mm, staggered -> (h, w, 3) metres."""
        r = np.asarray(ranges, np.float64) - self.n
        p = np.stack([r * self.cx + self.ex, r * self.cy + self.ey,
                      r * self.sz + self.bz], axis=-1)
        p = p @ self.rot.T + self.trans
        return np.where(np.asarray(ranges)[..., None] == 0, 0.0, p * 1e-3)

    def rays(self):
        """(origin, step), each (h, w, 3) in the sensor frame: the point of
        range 0 in metres, and the metres a millimetre of range moves it
        (p(r) = origin + r * step for r > 0)."""
        d = np.stack([self.cx, self.cy, np.broadcast_to(self.sz,
                                                        self.cx.shape)], -1)
        e = np.stack(np.broadcast_arrays(self.ex, self.ey, self.bz), -1)
        origin = ((e - self.n * d) @ self.rot.T + self.trans) * 1e-3
        return origin, d @ self.rot.T * 1e-3


def destagger(image: np.ndarray, shifts) -> np.ndarray:
    """Destagger an (h, w, ...) image: row i moves right by shifts[i]
    columns, wrapping."""
    out = np.empty_like(image)
    for i, s in enumerate(np.asarray(shifts, np.int64)):
        out[i] = np.roll(image[i], int(s), axis=0)
    return out
