"""XYZ projection LUT and cartesian conversion.

Rebuild of the reference XYZLut (ref: ouster_client/src/xyzlut.cpp:10-129,
ouster_client/include/ouster/cartesian.h:36-69). The LUT is built once per
sensor in float64 on the host; the device carries it as (hi, lo) float32
pairs ((h, w, 3) in XYZLutDevice, planar in ops/planar_kernels.PlanarLut)
and evaluates xyz = r * dir + off in double-single arithmetic
(ops/precision.py). XYZLutCard runs the host LUT's own float64 product on
a card, bit-equal to it (kernels/xyz_project).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.constants import RANGE_UNIT
from ..core.types import SensorInfo
from ..kernels.xyz_project import lut_tensor, xyz_project
from ..utils import profiling
from .precision import dd_add, dd_mul_f, split_f64_array


@dataclass
class XYZLut:
    """Host LUT: unit directions and offsets per pixel, float64, shape
    (h, w, 3), in staggered (packet) order like the reference."""

    direction: np.ndarray
    offset: np.ndarray

    def __call__(self, range_img: np.ndarray) -> np.ndarray:
        """Reference-precision numpy projection (float64)."""
        with profiling.span("xyzlut"):
            r = range_img.astype(np.float64)[..., None]
            return np.where(r == 0, 0.0, r * self.direction + self.offset)


class XYZLutCard:
    """An XYZLut's float64 projection on a device, bit-equal to
    XYZLut.__call__ (kernels/xyz_project: the hand-written kernel on CUDA,
    its plain version on the CPU).

    For each device the LUT is uploaded once, with a staging buffer for the
    range (pinned on CUDA). A call copies the range in through that buffer
    (one host-to-device copy), projects, and copies the XYZ straight into a
    fresh array that the caller owns (one pageable device-to-host copy,
    which waits for the work: the buffer is free again when the call
    returns). Calls hold a lock, so threads may share the buffers."""

    def __init__(self, lut: XYZLut):
        self.lut = lut
        self.shape: Tuple[int, int] = lut.direction.shape[:2]
        self._on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def takes(self, range_img: np.ndarray) -> bool:
        """Whether `range_img` is an image of the LUT's (h, w) that the
        kernel's uint32 operand holds exactly (unsigned, 32 bits or
        fewer)."""
        return (range_img.shape == self.shape
                and range_img.dtype.kind == "u"
                and range_img.dtype.itemsize <= 4)

    def _buffers(self, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        bufs = self._on.get(device)
        if bufs is None:
            bufs = self._on[device] = (
                lut_tensor(self.lut.direction, self.lut.offset).to(device),
                torch.empty(self.shape, dtype=torch.int32,
                            pin_memory=device.type == "cuda"))
        return bufs

    def __call__(self, range_img: np.ndarray,
                 device: torch.device) -> np.ndarray:
        """XYZ (h, w, 3) float64 of a range image that `takes` accepts,
        projected on `device`."""
        with self._lock:
            planes, range_buf = self._buffers(device)
            np.copyto(range_buf.numpy().view(np.uint32), range_img)
            xyz = xyz_project(range_buf.to(device, non_blocking=True),
                              planes)
            out = np.empty(xyz.shape, dtype=np.float64)
            torch.from_numpy(out).copy_(xyz)
            return out


@dataclass
class XYZLutFloat:
    """Single-precision host LUT (ref: processing.cpp:652 XYZLutFloat, the
    f32 variant of XYZLutT). Same staggered layout as XYZLut."""

    direction: np.ndarray
    offset: np.ndarray

    def __call__(self, range_img: np.ndarray) -> np.ndarray:
        r = range_img.astype(np.float32)[..., None]
        return np.where(r == 0, np.float32(0.0),
                        r * self.direction + self.offset)


@dataclass
class XYZLutDevice:
    """Device LUT: (hi, lo) float32 splits of direction and offset, each an
    (h, w, 3) tensor."""

    dir_hi: torch.Tensor
    dir_lo: torch.Tensor
    off_hi: torch.Tensor
    off_lo: torch.Tensor


def make_xyz_lut(
    sensor_or_w: Union[SensorInfo, int],
    use_extrinsics: bool = False,
    *,
    h: Optional[int] = None,
    range_unit: float = RANGE_UNIT,
    beam_to_lidar_transform: Optional[np.ndarray] = None,
    transform: Optional[np.ndarray] = None,
    azimuth_angles_deg: Optional[np.ndarray] = None,
    altitude_angles_deg: Optional[np.ndarray] = None,
) -> XYZLut:
    """Build the per-pixel projection LUT (ref: xyzlut.cpp:10-114).

    Either pass a SensorInfo (+ use_extrinsics) or the raw parameters.
    """
    if isinstance(sensor_or_w, SensorInfo):
        sensor = sensor_or_w
        w = sensor.format.columns_per_frame
        h = sensor.format.pixels_per_column
        beam_to_lidar_transform = sensor.beam_to_lidar_transform
        transform = sensor.lidar_to_sensor_transform
        if use_extrinsics:
            # extrinsics applied after lidar_to_sensor, translation in mm
            # (ref: xyzlut.cpp:98-109)
            ext = sensor.extrinsic.copy()
            ext[:3, 3] /= RANGE_UNIT
            transform = ext @ sensor.lidar_to_sensor_transform
        azimuth_angles_deg = np.asarray(sensor.beam_azimuth_angles,
                                        dtype=np.float64)
        altitude_angles_deg = np.asarray(sensor.beam_altitude_angles,
                                         dtype=np.float64)
    else:
        w = int(sensor_or_w)
        if h is None or beam_to_lidar_transform is None or transform is None:
            raise ValueError("raw make_xyz_lut needs h/transforms/angles")
        azimuth_angles_deg = np.asarray(azimuth_angles_deg, dtype=np.float64)
        altitude_angles_deg = np.asarray(altitude_angles_deg,
                                         dtype=np.float64)

    if w <= 0 or h <= 0:
        raise ValueError("lut dimensions must be greater than zero")
    # both tables must be per-beam (h) or both per-pixel (w*h) — mixed
    # sizes are rejected up front like the reference
    # (ref: xyzlut.cpp "unexpected scan dimensions")
    if not ((azimuth_angles_deg.size == h
             and altitude_angles_deg.size == h)
            or (azimuth_angles_deg.size == w * h
                and altitude_angles_deg.size == w * h)):
        raise ValueError("unexpected scan dimensions")

    # beam origin euclidean distance (ref: xyzlut.cpp:25-30)
    b2l = np.asarray(beam_to_lidar_transform, dtype=np.float64)
    beam_dist = b2l[0, 3]
    if b2l[2, 3] != 0:
        beam_dist = np.sqrt(b2l[0, 3] ** 2 + b2l[2, 3] ** 2)

    col = np.arange(w, dtype=np.float64)
    if azimuth_angles_deg.size == h:
        # OS sensor: per-row angles, encoder sweeps the full circle
        # (ref: xyzlut.cpp:38-50)
        encoder = (2.0 * np.pi - col * (2.0 * np.pi / w))[None, :]  # (1, w)
        azimuth = (-azimuth_angles_deg * np.pi / 180.0)[:, None]    # (h, 1)
        altitude = (altitude_angles_deg * np.pi / 180.0)[:, None]
        encoder = np.broadcast_to(encoder, (h, w))
        azimuth = np.broadcast_to(azimuth, (h, w))
        altitude = np.broadcast_to(altitude, (h, w))
    else:
        # DF sensor: per-pixel angle tables, no encoder sweep
        # (ref: xyzlut.cpp:52-64); tables are stored row-major (h, w)
        encoder = np.zeros((h, w), dtype=np.float64)
        azimuth = azimuth_angles_deg.reshape(h, w) * np.pi / 180.0
        altitude = altitude_angles_deg.reshape(h, w) * np.pi / 180.0

    direction = np.empty((h, w, 3), dtype=np.float64)
    direction[..., 0] = np.cos(encoder + azimuth) * np.cos(altitude)
    direction[..., 1] = np.sin(encoder + azimuth) * np.cos(altitude)
    direction[..., 2] = np.sin(altitude)

    offset = np.empty((h, w, 3), dtype=np.float64)
    offset[..., 0] = np.cos(encoder) * b2l[0, 3] - direction[..., 0] * beam_dist
    offset[..., 1] = np.sin(encoder) * b2l[0, 3] - direction[..., 1] * beam_dist
    offset[..., 2] = -direction[..., 2] * beam_dist + b2l[2, 3]

    # apply transform (ref: xyzlut.cpp:84-89): row-vector convention
    t = np.asarray(transform, dtype=np.float64)
    rot = t[:3, :3]
    trans = t[:3, 3]
    direction = direction @ rot.T
    offset = offset @ rot.T + trans

    direction *= range_unit
    offset *= range_unit
    return XYZLut(direction=direction, offset=offset)


def make_xyz_lut_float(sensor_or_w, use_extrinsics: bool = False,
                       **kwargs) -> XYZLutFloat:
    """Single-precision LUT factory (ref: processing.cpp XYZLutFloat).
    Built in f64 then rounded once, like the reference's XYZLutT<float>."""
    lut = make_xyz_lut(sensor_or_w, use_extrinsics, **kwargs)
    return XYZLutFloat(direction=lut.direction.astype(np.float32),
                       offset=lut.offset.astype(np.float32))


def to_device_lut(lut: XYZLut, device=None) -> XYZLutDevice:
    """Split the f64 LUT into (hi, lo) f32 pairs on `device` (CUDA when
    none is named; raises without a GPU)."""
    if device is None:
        from .fused import default_device

        device = default_device()
    dh, dl = split_f64_array(lut.direction)
    oh, ol = split_f64_array(lut.offset)
    return XYZLutDevice(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (dh, dl, oh, ol)))


def range_f32(range_img: torch.Tensor) -> torch.Tensor:
    """Integer range in mm -> float32, exact below 2**24. uint32 has no
    CPU conversion kernels of its own, so it goes through its int32 view
    and int64."""
    if range_img.dtype == torch.uint32:
        range_img = range_img.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return range_img.to(torch.float32)


def cartesian_dd(range_img: torch.Tensor, lut: XYZLutDevice) -> torch.Tensor:
    """xyz = r * dir + off in double-single f32, within 1 f32 ulp of the
    reference's f64 value.

    range_img: (..., h, w) integer range in mm; returns (..., h, w, 3) f32
    meters. Zero range maps to (0, 0, 0) like the reference
    (ref: cartesian.h:47-66).
    """
    r = range_f32(range_img)[..., None]
    p_hi, p_lo = dd_mul_f(lut.dir_hi, lut.dir_lo, r)
    s_hi, s_lo = dd_add(p_hi, p_lo, lut.off_hi, lut.off_lo)
    return torch.where(r == 0, torch.zeros((), dtype=torch.float32,
                                           device=r.device), s_hi + s_lo)


def cartesian_f32(range_img: torch.Tensor, lut: XYZLutDevice
                  ) -> torch.Tensor:
    """Plain f32 projection: r * dir_hi + off_hi, two roundings."""
    r = range_f32(range_img)[..., None]
    return torch.where(r == 0, torch.zeros((), dtype=torch.float32,
                                           device=r.device),
                       r * lut.dir_hi + lut.off_hi)


def cartesian(range_img: torch.Tensor, lut: XYZLutDevice) -> torch.Tensor:
    """Default device projection (double-single precision)."""
    return cartesian_dd(range_img, lut)
