"""Derived scan transforms: clip, mask, reduce (beam decimation).

Rebuild of the reference derived sources (ref: python/src/ouster/sdk/core/
{clipped,masked,reduced}_scan_source.py with kernels in
sdk/core/scan_ops.py:33,192,242).

Every transform runs on the host in numpy over scans from any source. A
live scan whose pixel fields still wait on the device (a deferred fill) is
resolved before it is copied: deepcopy goes through LidarScan.__getstate__
and the copy constructor resolves first, so a view never copies the
zero-initialized arrays. A view fails where its parent fails.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..core.constants import ChanField
from ..core.lidar_scan import LidarScan
from ..core.types import SensorInfo
from .sources import LidarScanSet, ScanSource


def clip(scan: LidarScan, fields: Sequence[str], lower: float,
         upper: float, invalid: int = 0) -> None:
    """Zero (or `invalid`) values of the given pixel fields outside
    [lower, upper] — RAW field units like the reference (mm for RANGE)
    (ref: scan_ops.py:33 clip)."""
    for name in _resolve_pixel_fields(scan, list(fields) or None):
        m = scan.field(name)
        m[(m < lower) | (m > upper)] = invalid


def clip_scan(scan: LidarScan, min_range_m: float, max_range_m: float,
              fields: Sequence[str] = (ChanField.RANGE, ChanField.RANGE2)
              ) -> LidarScan:
    """Meters-based convenience over `clip` for RANGE-like fields, in
    place (CLI `clip --min/max-range` takes meters)."""
    lo = int(min_range_m * 1000)
    hi = int(max_range_m * 1000) if np.isfinite(max_range_m) else 2**32
    clip(scan, [f for f in fields if scan.has_field(f)], lo, hi)
    return scan


def mask_scan(scan: LidarScan, mask: np.ndarray,
              fields: Optional[Sequence[str]] = None) -> LidarScan:
    """Zero all pixel fields where mask (H, W) is falsy, in place
    (ref: scan_ops.py:192-206 mask: shape validated, pixel-field targets
    only, empty/None field list means all pixel fields)."""
    mask = np.asarray(mask)
    if mask.shape[0] != scan.h or mask.shape[1] != scan.w:
        raise ValueError(
            f"Used mask size {mask.shape} doesn't match scan size "
            f"({scan.h}, {scan.w})")
    mask = mask.astype(bool)
    for name in _resolve_pixel_fields(scan, list(fields) if fields
                                      else None):
        f = scan.field(name)
        if f.ndim >= 2 and f.shape[:2] == (scan.h, scan.w):
            f[~mask] = 0
    return scan


def _resolve_pixel_fields(scan: LidarScan,
                          fields: Optional[Sequence[str]] = None
                          ) -> List[str]:
    """Pixel-field targets (ref: scan_ops.py:8): default all pixel
    fields; an explicit list ignores MISSING fields (field sets vary
    mid-stream) but rejects present non-pixel fields."""
    def is_pixel(name: str) -> bool:
        f = scan.field(name)
        return f.ndim >= 2 and f.shape[:2] == (scan.h, scan.w)

    requested = list(fields) if fields else list(scan.fields)
    present = [n for n in requested if scan.has_field(n)]
    non_pixel = [n for n in present if not is_pixel(n)]
    if fields and non_pixel:
        raise ValueError(
            f"cannot operate on non-pixel fields: {non_pixel}")
    return [n for n in present if is_pixel(n)]


def filter_field(scan: LidarScan, field: str, lower: float, upper: float,
                 invalid: int = 0,
                 filtered_fields: Optional[Sequence[str]] = None
                 ) -> LidarScan:
    """Set pixels of the filtered fields to `invalid` wherever `field`'s
    value falls in [lower, upper], in place (ref: scan_ops.py:47)."""
    targets = _resolve_pixel_fields(scan, filtered_fields)
    m = scan.field(field)
    if m.shape[:2] != (scan.h, scan.w):
        raise ValueError(
            f"filter_field needs an (h, w) pixel field; {field!r} has "
            f"shape {m.shape} for scan ({scan.h}, {scan.w})")
    hit = (m >= lower) & (m <= upper)
    for name in targets:
        scan.field(name)[hit] = invalid
    return scan


def filter_uv(scan: LidarScan, coord_2d: str, lower, upper,
              invalid: int = 0,
              filtered_fields: Optional[Sequence[str]] = None) -> LidarScan:
    """Set pixels inside the image-index band [lower, upper) of axis
    'u' (rows) or 'v' (destaggered columns) to `invalid`, in place.
    Float bounds in [0, 1] are fractions of the axis size
    (ref: scan_ops.py:77 — the 'v' axis filters the DESTAGGERED image)."""
    from ..ops.destagger import destagger

    if coord_2d not in ("u", "v"):
        raise ValueError(f"coord_2d == {coord_2d!r} must be 'u' or 'v'")
    size = scan.h if coord_2d == "u" else scan.w

    def as_index(v) -> int:
        if v == float("-inf"):
            return 0
        if v == float("inf"):
            return size
        if isinstance(v, float) and 0 <= v <= 1:
            return int(size * v)
        return int(v)

    lo, hi = as_index(lower), as_index(upper)
    if lo < 0 or hi > size:
        raise ValueError(f"bounds [{lo}, {hi}] outside [0, {size}]")
    if lo > hi:
        raise ValueError(f"lower {lo} must not exceed upper {hi}")
    targets = _resolve_pixel_fields(scan, filtered_fields)
    for name in targets:
        f = scan.field(name)
        if coord_2d == "u":
            f[lo:hi] = invalid
        else:
            img = destagger(scan.sensor_info, f)
            img[:, lo:hi] = invalid
            f[:] = destagger(scan.sensor_info, img, inverse=True)
    return scan


_SECOND_RETURN_FIELDS = frozenset(
    {ChanField.RANGE2, ChanField.SIGNAL2, ChanField.REFLECTIVITY2,
     ChanField.FLAGS2})


def filter_xyz(scan: LidarScan, xyzlut, axis_idx: int,
               lower: float = float("-inf"), upper: float = float("inf"),
               invalid: int = 0,
               filtered_fields: Optional[Sequence[str]] = None,
               dewarp_points: bool = False) -> LidarScan:
    """Set pixels whose Cartesian coordinate (axis_idx: 0=X 1=Y 2=Z,
    meters) falls in [lower, upper] to `invalid`, in place. Second-return
    fields use the RANGE2 projection; everything else uses RANGE. With
    dewarp_points, coordinates are world-frame via scan.pose
    (ref: scan_ops.py:132). An `XYZLut(info)` serves the scan's XYZ cache
    (the OSF projector's, both returns) while the range is unchanged; any
    other LUT projects the range image."""
    from ..ops.pose import dewarp_np

    if not 0 <= axis_idx <= 2:
        raise ValueError(f"axis_idx == {axis_idx} must be in [0, 2]")
    targets = _resolve_pixel_fields(scan, filtered_fields)
    return_xyz = getattr(xyzlut, "return_xyz", None)

    def coord_mask(range_field: str):
        if return_xyz is not None:
            pts = return_xyz(scan, int(range_field == ChanField.RANGE2))
        else:
            pts = np.asarray(xyzlut(scan.field(range_field)))
        if dewarp_points:
            pts = dewarp_np(pts, scan.pose)
        c = pts[:, :, axis_idx]
        return (c >= lower) & (c <= upper)

    m1 = coord_mask(ChanField.RANGE) if scan.has_field(ChanField.RANGE) \
        else None
    m2 = coord_mask(ChanField.RANGE2) if scan.has_field(ChanField.RANGE2) \
        else None
    if m1 is None and m2 is None:
        return scan
    for name in targets:
        hit = (m2 if m2 is not None else m1) \
            if name in _SECOND_RETURN_FIELDS \
            else (m1 if m1 is not None else m2)
        scan.field(name)[hit] = invalid
    return scan


def reduce_scan(scan: LidarScan, beams: int) -> LidarScan:
    """Decimate beams to `beams` rows (ref: scan_ops.py:242 reduce_by_factor;
    beams must divide the current count evenly)."""
    h = scan.h
    if beams <= 0 or h % beams != 0:
        raise ValueError(
            f"beam count {beams} must evenly divide {h}")
    factor = h // beams
    if factor == 1:
        return scan

    info = scan.sensor_info
    new_info = None
    if info is not None:
        import copy

        new_info = copy.deepcopy(info)
        new_info.format.pixels_per_column = beams
        new_info.format.pixel_shift_by_row = \
            list(info.format.pixel_shift_by_row[::factor])
        new_info.beam_azimuth_angles = info.beam_azimuth_angles[::factor]
        new_info.beam_altitude_angles = info.beam_altitude_angles[::factor]

    out = LidarScan(w=scan.w, h=beams,
                    field_types=[],
                    columns_per_packet=scan.columns_per_packet)
    out.sensor_info = new_info
    out.frame_id = scan.frame_id
    out.frame_status = scan.frame_status
    out.timestamp[:] = scan.timestamp
    out.measurement_id[:] = scan.measurement_id
    out.status[:] = scan.status
    out.packet_timestamp[:] = scan.packet_timestamp
    out.alert_flags[:] = scan.alert_flags
    out.pose[:] = scan.pose

    from ..core.field import FieldClass

    for ft in scan.field_types:
        data = scan.field(ft.name)
        if ft.field_class == FieldClass.PIXEL_FIELD and \
                data.ndim >= 2 and data.shape[0] == h:
            out.add_field(ft, data[::factor])
        else:
            out.add_field(ft, data)
    return out


class _ForwardsParent:
    """Derived views forward liveness/index state to their parent
    (ref: clipped_scan_source.py:28-43 and the masked/reduced twins)."""

    _parent: ScanSource

    @property
    def is_live(self) -> bool:
        return self._parent.is_live

    @property
    def is_indexed(self) -> bool:
        return self._parent.is_indexed

    @property
    def scans_num(self):
        return self._parent.scans_num

    def __len__(self) -> int:
        return len(self._parent)


class ClippedScanSource(_ForwardsParent, ScanSource):
    """Clips field values to [lower, upper] in RAW field units (mm for
    RANGE), yielding CLIPPED COPIES so other consumers of the parent
    stream see unmodified scans
    (ref: sdk/core/clipped_scan_source.py)."""

    def __init__(self, parent: ScanSource, fields: Sequence[str],
                 lower: float, upper: float):
        if upper < lower:
            raise ValueError("`upper` value can't be less than `lower`")
        super().__init__(parent.sensor_info)
        self._parent = parent
        self._fields = list(fields)
        self._lower, self._upper = lower, upper

    def _iter_sets(self):
        from copy import deepcopy

        for ls_set in self._parent:
            out = []
            for s in ls_set:
                if s is None:
                    out.append(None)
                    continue
                cpy = deepcopy(s)
                clip(cpy, self._fields, self._lower, self._upper)
                out.append(cpy)
            yield LidarScanSet(out)


class MaskedScanSource(_ForwardsParent, ScanSource):
    """Masks are given in DESTAGGERED (image) coordinates and are
    inverse-destaggered per sensor at construction; scans are yielded as
    modified copies (ref: sdk/core/masked_scan_source.py:11-57)."""

    def __init__(self, parent: ScanSource, fields: Sequence[str],
                 masks: List[Optional[np.ndarray]]):
        from ..ops.destagger import destagger

        if len(parent.sensor_info) != len(masks):
            raise ValueError(
                "the number of masks should match the count of sensors")
        super().__init__(parent.sensor_info)
        self._parent = parent
        self._fields = list(fields)
        self._masks = [
            destagger(si, m, inverse=True) if m is not None else None
            for si, m in zip(parent.sensor_info, masks)]

    def _iter_sets(self):
        for ls_set in self._parent:
            out: List[Optional[LidarScan]] = []
            for idx, s in enumerate(ls_set):
                if s is None:
                    out.append(None)
                    continue
                cpy = LidarScan(s)
                if self._masks[idx] is not None:
                    mask_scan(cpy, self._masks[idx], self._fields)
                out.append(cpy)
            yield LidarScanSet(out)


class ReducedScanSource(_ForwardsParent, ScanSource):
    """(ref: sdk/core/reduced_scan_source.py)"""

    def __init__(self, parent: ScanSource, beams: List[int]):
        import copy

        if len(beams) != len(parent.sensor_info):
            raise ValueError(
                f"beams count ({len(beams)}) must match the number of "
                f"sensors ({len(parent.sensor_info)})")
        infos = []
        for info, b in zip(parent.sensor_info, beams):
            h = info.format.pixels_per_column
            if b <= 0 or h % b != 0:
                raise ValueError(
                    f"beam count {b} must evenly divide {h}")
            ni = copy.deepcopy(info)
            factor = h // b
            ni.format.pixels_per_column = b
            ni.format.pixel_shift_by_row = \
                list(info.format.pixel_shift_by_row[::factor])
            ni.beam_azimuth_angles = info.beam_azimuth_angles[::factor]
            ni.beam_altitude_angles = info.beam_altitude_angles[::factor]
            infos.append(ni)
        super().__init__(infos)
        self._parent = parent
        self._beams = beams

    def _iter_sets(self):
        for ls_set in self._parent:
            yield LidarScanSet([
                reduce_scan(s, self._beams[i]) if s is not None else None
                for i, s in enumerate(ls_set)])
