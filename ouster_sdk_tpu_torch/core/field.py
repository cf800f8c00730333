"""Field descriptors and classes for LidarScan fields.

The SDK's Field/FieldDescriptor/FieldClass model
(ref: ouster_client/include/ouster/field.h:75,283,710-756). Fields are
plain numpy arrays on the host plus an attached FieldClass; on the device
a decoded frame is a dict of tensors (ops/unpack.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Tuple

import numpy as np


class FieldClass(IntEnum):
    """What a field's leading dimension(s) index (ref: field.h:710-737)."""

    PIXEL_FIELD = 0      # (h, w, ...)
    COLUMN_FIELD = 1     # (w, ...)
    PACKET_FIELD = 2     # (packets, ...)
    SCAN_FIELD = 3       # scan-level, arbitrary shape
    COLLATION_FIELD = 4


class ChanFieldType(IntEnum):
    """Runtime dtype tags (ref: chanfield.h:113)."""

    VOID = 0
    UINT8 = 1
    UINT16 = 2
    UINT32 = 3
    UINT64 = 4
    INT8 = 5
    INT16 = 6
    INT32 = 7
    INT64 = 8
    FLOAT16 = 13
    FLOAT32 = 9
    FLOAT64 = 10
    UNREGISTERED = 100
    CHAR = 11
    ZONE_STATE = 12


_TAG_TO_DTYPE = {
    ChanFieldType.UINT8: np.dtype(np.uint8),
    ChanFieldType.UINT16: np.dtype(np.uint16),
    ChanFieldType.UINT32: np.dtype(np.uint32),
    ChanFieldType.UINT64: np.dtype(np.uint64),
    ChanFieldType.INT8: np.dtype(np.int8),
    ChanFieldType.INT16: np.dtype(np.int16),
    ChanFieldType.INT32: np.dtype(np.int32),
    ChanFieldType.INT64: np.dtype(np.int64),
    ChanFieldType.FLOAT16: np.dtype(np.float16),
    ChanFieldType.FLOAT32: np.dtype(np.float32),
    ChanFieldType.FLOAT64: np.dtype(np.float64),
    ChanFieldType.CHAR: np.dtype("S1"),
}

_DTYPE_TO_TAG = {v: k for k, v in _TAG_TO_DTYPE.items()}


def dtype_of(tag: ChanFieldType) -> np.dtype:
    return _TAG_TO_DTYPE[tag]


def tag_of(dtype: np.dtype) -> ChanFieldType:
    return _DTYPE_TO_TAG.get(np.dtype(dtype), ChanFieldType.UNREGISTERED)


def field_type_size(tag: ChanFieldType) -> int:
    return _TAG_TO_DTYPE[tag].itemsize if tag in _TAG_TO_DTYPE else 0


def field_type_mask(tag: ChanFieldType) -> int:
    size = field_type_size(tag)
    return (1 << (8 * size)) - 1 if size else 0


# numpy structured dtype mirroring the reference's ZoneState record
# (ref: ouster_client/include/ouster/zone_state.h; fixed 37-byte wire record
# parsed from zone packets, parsing.cpp:1361)
ZONE_STATE_DTYPE = np.dtype([
    ("live", np.uint8),
    ("id", np.uint8),
    ("error_flags", np.uint8),
    ("trigger_type", np.uint8),
    ("trigger_status", np.uint8),
    ("triggered_frames", np.uint32),
    ("count", np.uint32),
    ("occlusion_count", np.uint32),
    ("invalid_count", np.uint32),
    ("max_count", np.uint32),
    ("min_range", np.uint32),
    ("max_range", np.uint32),
    ("mean_range", np.uint32),
])


@dataclass
class FieldType:
    """Declared type of one scan field (ref: lidar_scan.h FieldType).

    Fixed-length string dtypes follow the reference binding
    (ref: python/src/cpp/client/field.cpp:99-124): a char field stores
    element type CHAR (S1 here) with the string length folded into the
    LAST extra dim — constructing with np.dtype("S25") appends 25 to
    extra_dims, the `element_type` property reports "S<last dim>", and
    re-assigning it pops/pushes that dim.
    """

    name: str
    element_type: np.dtype
    extra_dims: Tuple[int, ...] = ()
    field_class: FieldClass = FieldClass.PIXEL_FIELD

    def __post_init__(self) -> None:
        dt = self.__dict__["_etype"]  # raw ctor value via the setter
        dims = tuple(self.extra_dims)
        if dt.kind == "S" and dt.itemsize > 1:
            dims = dims + (dt.itemsize,)
            dt = np.dtype("S1")
        self.__dict__["_etype"] = dt
        self.__dict__["extra_dims"] = dims
        self.__dict__["_init_done"] = True

    def _get_element_type(self) -> np.dtype:
        dt = self.__dict__["_etype"]
        if dt.kind == "S":
            dims = self.__dict__.get("extra_dims", ())
            if dims:
                return np.dtype(f"S{dims[-1]}")
        return dt

    def _set_element_type(self, value) -> None:
        dt = value if isinstance(value, np.dtype) else np.dtype(value)
        if self.__dict__.get("_init_done"):
            # reassignment: pop the old char dim, push the new one
            # (ref: field.cpp:109-122 element_type setter;
            # python/tests/test_data.py:792-809 fieldtype_char_dtype)
            dims = tuple(self.__dict__.get("extra_dims", ()))
            if self.__dict__["_etype"].kind == "S" and dims:
                dims = dims[:-1]
            if dt.kind == "S" and dt.itemsize > 0:
                dims = dims + (dt.itemsize,)
                dt = np.dtype("S1")
            self.__dict__["extra_dims"] = dims
        self.__dict__["_etype"] = dt

    @property
    def storage_dtype(self) -> np.dtype:
        """The dtype arrays are allocated with: S1 for char fields (the
        string length lives in extra_dims), the element type otherwise."""
        return self.__dict__["_etype"]

    def shape(self, h: int, w: int, packets: int) -> Tuple[int, ...]:
        if self.field_class == FieldClass.PIXEL_FIELD:
            return (h, w) + self.extra_dims
        if self.field_class == FieldClass.COLUMN_FIELD:
            return (w,) + self.extra_dims
        if self.field_class == FieldClass.PACKET_FIELD:
            return (packets,) + self.extra_dims
        return self.extra_dims


# element_type as a class-level property so the dataclass-generated
# __init__ routes through _set_element_type while plain attribute reads
# (name, extra_dims, field_class) stay native-speed
FieldType.element_type = property(FieldType._get_element_type,
                                  FieldType._set_element_type)
