"""Carry state built elsewhere into the port: a PlanarLut stack, the four
tensors of an XYZLutDevice, the sixteen leaves of a FactorTables and a
DecodePlan given as plain numpy / dict data (e.g. the reference package's
`np.asarray(PlanarLut(...).stack)`, `np.asarray(lut.dir_hi)`,
`np.asarray(tables.P)` and `dataclasses.asdict(plan)`), so two
implementations can be fed the same LUT, tables and plan; and a LidarScan
given as numpy arrays, or as another implementation's scan object read
through its public attributes, so two implementations' scans compare with
`==`."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .core.field import FieldClass, FieldType
from .core.lidar_scan import LidarScan
from .core.types import SensorInfo
from .ops.lutfree_kernels import FactorTables
from .ops.planar_kernels import PlanarLut
from .ops.unpack import DecodePlan, FieldPlan
from .ops.xyzlut import XYZLutDevice


def planar_lut_from_numpy(stack: np.ndarray, device) -> PlanarLut:
    """An (18, h, w) float32 LUT stack -> PlanarLut on `device`."""
    stack = np.asarray(stack)
    if stack.ndim != 3 or stack.shape[0] != 18:
        raise ValueError(f"LUT stack must be (18, h, w), got {stack.shape}")
    return PlanarLut.from_stack(stack, device)


def xyz_lut_device_from_numpy(dir_hi: np.ndarray, dir_lo: np.ndarray,
                              off_hi: np.ndarray, off_lo: np.ndarray,
                              device) -> XYZLutDevice:
    """Four (h, w, 3) float32 arrays, the (hi, lo) splits of direction and
    offset -> XYZLutDevice on `device`."""
    arrays = [np.asarray(a) for a in (dir_hi, dir_lo, off_hi, off_lo)]
    for a in arrays:
        if a.ndim != 3 or a.shape[-1] != 3 or a.shape != arrays[0].shape:
            raise ValueError(f"LUT arrays must all be (h, w, 3), got "
                             f"{[x.shape for x in arrays]}")
    return XYZLutDevice(*(torch.from_numpy(
        np.array(a, dtype=np.float32, order="C")).to(device)
        for a in arrays))


def factor_tables_from_numpy(leaves: Dict[str, np.ndarray], device
                             ) -> FactorTables:
    """The sixteen FactorTables leaves as numpy arrays, keyed by the names
    in FactorTables._LEAVES (P, Q, S, E, F, G as (3, h, 1), ce, se as
    (1, w), each with its `_lo`) -> FactorTables on `device`."""
    return FactorTables.from_leaves(leaves, device)


def decode_plan_from_jax_fields(fields: Dict[str, Any]) -> DecodePlan:
    """DecodePlan from the dict of its fields (dataclasses.asdict form:
    field plans as dicts)."""
    d = dict(fields)
    d["fields"] = tuple(FieldPlan(**dict(f)) for f in d["fields"])
    return DecodePlan(**d)


_SCAN_HEADERS = ("timestamp", "measurement_id", "status", "packet_timestamp",
                 "alert_flags", "pose")
_SCAN_SCALARS = ("frame_id", "frame_status", "shutdown_countdown",
                 "shot_limiting_countdown")


def lidar_scan_from_numpy(info: SensorInfo, headers: Dict[str, Any],
                          fields: Dict[str, np.ndarray],
                          field_types: Optional[Sequence[FieldType]] = None
                          ) -> LidarScan:
    """A LidarScan of `info` from plain data. `fields` maps names to
    arrays, taken with their dtype and shape as they are; `headers` holds
    any of the per-column and per-packet arrays (timestamp,
    measurement_id, status, packet_timestamp, alert_flags, pose) and of
    the scalars (frame_id, frame_status, shutdown_countdown,
    shot_limiting_countdown). `field_types` declares the fields (class and
    extra dims); by default every field is a pixel field whose extra dims
    follow its (h, w) axes, or a scan field when it does not start with
    them."""
    h, w = info.format.pixels_per_column, info.format.columns_per_frame
    if field_types is None:
        field_types = []
        for name, arr in fields.items():
            arr = np.asarray(arr)
            pixel = arr.shape[:2] == (h, w)
            field_types.append(FieldType(
                name, arr.dtype, arr.shape[2:] if pixel else arr.shape,
                FieldClass.PIXEL_FIELD if pixel else FieldClass.SCAN_FIELD))
    ls = LidarScan(info, field_types=list(field_types))
    for name, arr in fields.items():
        dst = ls.field(name)
        arr = np.asarray(arr)
        if arr.dtype != dst.dtype or arr.shape != dst.shape:
            raise ValueError(f"field {name}: {arr.dtype} {arr.shape} does "
                             f"not fit {dst.dtype} {dst.shape}")
        dst[...] = arr
    for key in _SCAN_HEADERS:
        if key in headers:
            getattr(ls, key)[...] = np.asarray(headers[key])
    for key in _SCAN_SCALARS:
        if key in headers:
            setattr(ls, key, int(headers[key]))
    return ls


def lidar_scan_from_jax(info: SensorInfo, scan) -> LidarScan:
    """The port's LidarScan of `info` carrying what `scan`, the reference
    package's LidarScan, carries: every field (read through `field_types`
    and `field()`, so a deferred scan resolves) with its dtype, class and
    extra dims, every header array and scalar."""
    fts = []
    for ft in scan.field_types:
        # a char field reports "S<n>" and keeps n as its last extra dim:
        # hand over the storage dtype and the dims as they are
        fts.append(FieldType(str(ft.name), np.dtype(ft.storage_dtype),
                             tuple(ft.extra_dims),
                             FieldClass(int(ft.field_class))))
    return lidar_scan_from_numpy(
        info,
        {**{k: getattr(scan, k) for k in _SCAN_HEADERS},
         **{k: getattr(scan, k) for k in _SCAN_SCALARS}},
        {str(ft.name): scan.field(ft.name) for ft in scan.field_types},
        field_types=fts)
