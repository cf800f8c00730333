"""Point-cloud file (PLY/PCD/CSV/LAS) scan sources.

The reference enumerates these IoTypes (ref: io_type.h:17-25) and reads the
files via cloud_io (ref: cloud_io.cpp); here each file opens as an indexed
one-scan ScanSource: points are packed into an h x w grid scan carrying a
RANGE image (mm, from |p|) plus an exact `XYZ` f32 pixel field, so the
clip/viz/save/slam pipeline stages all compose over cloud files too.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

from ..core.constants import ChanField
from ..core.field import FieldClass, FieldType
from ..core.lidar_scan import LidarScan
from ..core.types import LidarMode, SensorInfo
from .sources import (
    IoType,
    LidarScanSet,
    ScanSource,
    ScanSourceOptions,
    populate_extrinsics,
    register_scan_source,
)

# attribute-name aliases -> canonical channel fields
_ATTR_FIELDS = {
    "reflectivity": (ChanField.REFLECTIVITY, np.uint8),
    "signal": (ChanField.SIGNAL, np.uint16),
    "intensity": (ChanField.SIGNAL, np.uint16),
    "near_ir": (ChanField.NEAR_IR, np.uint16),
    "ambient": (ChanField.NEAR_IR, np.uint16),
}


def scan_from_points(points: np.ndarray, attributes=None,
                     h: Optional[int] = None) -> LidarScan:
    """Pack an (N, 3) cloud (meters) into a one-frame LidarScan."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = points.shape[0]
    if h is None:
        h = 128 if n >= 128 else max(n, 1)
    w = max(math.ceil(n / h), 1)

    info = SensorInfo.from_default(LidarMode(1024, 10))
    info.format.pixels_per_column = h
    info.format.columns_per_frame = w
    info.format.columns_per_packet = min(16, w)
    info.format.pixel_shift_by_row = [0] * h
    info.format.column_window = (0, w - 1)
    info.beam_azimuth_angles = [0.0] * h
    info.beam_altitude_angles = [0.0] * h

    scan = LidarScan(info)
    pad = h * w - n
    xyz = np.concatenate([points, np.zeros((pad, 3))]) \
        .reshape(w, h, 3).transpose(1, 0, 2)
    rng_mm = np.linalg.norm(xyz, axis=-1) * 1000.0
    scan.field(ChanField.RANGE)[:] = np.clip(
        np.round(rng_mm), 0, np.iinfo(np.uint32).max).astype(np.uint32)
    scan.add_field(FieldType("XYZ", np.dtype(np.float32), (3,),
                             FieldClass.PIXEL_FIELD), xyz.astype(np.float32))
    for name, vals in (attributes or {}).items():
        key = name.lower()
        if key in _ATTR_FIELDS:
            fname, dt = _ATTR_FIELDS[key]
            if fname in scan.fields:
                v = np.concatenate(
                    [np.asarray(vals).reshape(-1)[:n], np.zeros(pad)])
                scan.field(fname)[:] = v.reshape(w, h).T.astype(
                    scan.field(fname).dtype)
    scan.status[:] = 1
    scan.frame_id = 0
    return scan


class CloudScanSource(ScanSource):
    """Indexed single-scan source over a point-cloud file
    (ref: io_type.h:17-25 PLY/PCD/CSV/LAS)."""

    def __init__(self, path: str, *,
                 extrinsics: Optional[List[np.ndarray]] = None,
                 extrinsics_file: Optional[str] = None):
        from .cloud_io import read_pointcloud

        points, attrs = read_pointcloud(path)
        self._scan = scan_from_points(points, attrs)
        infos = [self._scan.sensor_info]
        populate_extrinsics(infos, extrinsics, extrinsics_file)
        super().__init__(infos)

    @property
    def is_indexed(self) -> bool:
        return True

    def __len__(self) -> int:
        return 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(1))]
        if i not in (0, -1):
            raise IndexError(i)
        return LidarScanSet([self._scan])

    def _iter_sets(self) -> Iterator[LidarScanSet]:
        yield LidarScanSet([self._scan])

    @property
    def scans_num(self) -> List[int]:
        return [1]


def _build(source: str, opts: ScanSourceOptions):
    src = CloudScanSource(
        source,
        extrinsics=opts.take("extrinsics"),
        extrinsics_file=opts.take("extrinsics_file"),
    )
    opts.take("index")  # always indexed; accept the option silently
    opts.take("error_handler")  # no recoverable-error surface here
    return src


for _t in (IoType.PLY, IoType.PCD, IoType.CSV, IoType.LAS):
    register_scan_source(_t)(_build)
