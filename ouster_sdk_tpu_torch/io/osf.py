"""OSF container: reader, writer, scan codec, ScanSource.

The reference OSF backend (ref: ouster_osf/ — basics.h framing,
reader.h:246, writer.h:90, stream_lidar_scan.h:151, fb/*.fbs schemas) on the
minimal flatbuffers runtime (utils/flatbuf.py), the PNG codec (utils/png.py,
scanlines unfiltered by the native library) and the zPNG codec
(utils/zpng.py, libzstd). Field decompression runs on the host; replay
projects RANGE/RANGE2 to XYZ on the device (io/device_engine
.OsfDeviceProjector, the planar kernel) and attaches it to each scan.

The writer reproduces the JAX package's files byte for byte: the same
flatbuffer layout, codecs, sensor json (core/types.SensorInfo
.to_json_string) and metadata id.

File framing (ref: ouster_osf/src/basics.cpp:140-161):
  [u32 size][fb Header "OSF$"][u32 crc32]          -- crc over size+fb bytes
  repeated: [u32 size][fb Chunk "OSF!"][u32 crc32]
  at Header.metadata_offset: [u32 size][fb Metadata "OSF#"][u32 crc32]
The header is written INVALID first and flipped VALID on close (crash
consistency).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.constants import ChanField
from ..core.error_handler import (
    ErrorHandler,
    Severity,
    default_error_handler,
)
from ..core.field import FieldClass, FieldType, ZONE_STATE_DTYPE
from ..core.lidar_scan import LidarScan, get_field_types
from ..core.metadata import sensor_info_from_metadata
from ..core.types import SDK_NAME, SensorInfo
from ..ops.destagger import destagger as _destagger, stagger as _stagger
from ..utils import flatbuf as fb
from ..utils import png as png_codec
from ..utils import profiling
from ..utils import zpng as zpng_codec
from .sources import (
    LidarScanSet,
    ScanSource,
    collate_scans,
    populate_extrinsics,
)

_U32 = struct.Struct("<I")

HEADER_IDENT = b"OSF$"
CHUNK_IDENT = b"OSF!"
METADATA_IDENT = b"OSF#"

STATUS_INVALID = 1
STATUS_VALID = 2

OSF_VERSION = 21  # V_2_1 (ref: basics.h:37-53)

# CHAN_FIELD enum (ref: fb/os_sensor/lidar_scan_stream.fbs)
_CHAN_FIELD_TO_NAME = {
    1: ChanField.RANGE, 2: ChanField.RANGE2, 3: ChanField.SIGNAL,
    4: ChanField.SIGNAL2, 5: ChanField.REFLECTIVITY,
    6: ChanField.REFLECTIVITY2, 7: ChanField.NEAR_IR, 8: ChanField.FLAGS,
    9: ChanField.FLAGS2, 40: ChanField.RAW_HEADERS,
    45: ChanField.RAW32_WORD5, 46: ChanField.RAW32_WORD6,
    47: ChanField.RAW32_WORD7, 48: ChanField.RAW32_WORD8,
    49: ChanField.RAW32_WORD9,
    60: ChanField.RAW32_WORD1, 61: ChanField.RAW32_WORD2,
    62: ChanField.RAW32_WORD3, 63: ChanField.RAW32_WORD4,
}
for _i in range(10):
    _CHAN_FIELD_TO_NAME[50 + _i] = f"CUSTOM{_i}"
_NAME_TO_CHAN_FIELD = {v: k for k, v in _CHAN_FIELD_TO_NAME.items()}

# CHAN_FIELD_TYPE enum (ref: fb/os_sensor/common.fbs)
_TYPE_TO_DTYPE = {
    1: np.dtype(np.uint8), 2: np.dtype(np.uint16), 3: np.dtype(np.uint32),
    4: np.dtype(np.uint64), 5: np.dtype(np.int8), 6: np.dtype(np.int16),
    7: np.dtype(np.int32), 8: np.dtype(np.int64), 9: np.dtype(np.float32),
    10: np.dtype(np.float64), 11: np.dtype("S1"), 12: np.dtype(np.float16),
}
_DTYPE_TO_TYPE = {v: k for k, v in _TYPE_TO_DTYPE.items()}

# FIELD_CLASS enum (fb) <-> core FieldClass
_FB_TO_FIELD_CLASS = {
    1: FieldClass.PIXEL_FIELD, 2: FieldClass.COLUMN_FIELD,
    3: FieldClass.PACKET_FIELD, 4: FieldClass.SCAN_FIELD,
}
_FIELD_CLASS_TO_FB = {v: k for k, v in _FB_TO_FIELD_CLASS.items()}

_METADATA_ENTRY_LIDAR_SENSOR = "ouster/v1/os_sensor/LidarSensor"
_METADATA_ENTRY_LIDAR_SCAN_STREAM = "ouster/v1/os_sensor/LidarScanStream"
_METADATA_ENTRY_EXTRINSICS = "ouster/v1/os_sensor/Extrinsics"
_METADATA_ENTRY_STREAMING_INFO = "ouster/v1/streaming/StreamingInfo"
_METADATA_ENTRY_COLLATION_STREAM = "ouster/v1/os_sensor/CollationStream"

#: marks "no scan from this sensor" in a collation
#: (ref: collation_stream.h:97 INVALID_SCAN_ID)
INVALID_SCAN_ID: Tuple[int, int] = (0xFFFF, 0)

#: lazy-resolution sentinel (None is a meaningful "policy off" value)
_UNSET = object()

# ScanID struct: u32 sensor_id @0, u64 scan_idx @8 (size 16, align 8)
# (ref: fb/os_sensor/collation_stream.fbs:5-8)
_SCAN_ID_NP = np.dtype({"names": ["sensor_id", "scan_idx"],
                        "formats": [np.uint32, np.uint64],
                        "offsets": [0, 8], "itemsize": 16})


def _block_crc_ok(block: memoryview) -> bool:
    """crc32 over [size prefix + fb bytes] (ref: basics.cpp:147-161)."""
    size = _U32.unpack_from(block, 0)[0]
    stored = _U32.unpack_from(block, 4 + size)[0]
    return stored == zlib.crc32(block[: 4 + size])


def _frame_block(fb_bytes: bytes) -> bytes:
    """size-prefixed fb + crc32."""
    crc = zlib.crc32(fb_bytes)
    return fb_bytes + _U32.pack(crc)


@dataclass
class MetadataEntry:
    id: int
    type: str
    buffer: bytes


@dataclass
class MessageRef:
    """One stamped message (ref: reader.h:353 MessageRef)."""

    ts: int
    ts_sensor: int
    id: int
    buffer: "np.ndarray"  # u8 view into the reader's mmap (or bytes)
    reader: "Reader"

    @property
    def sensor_idx(self) -> int:
        return self.reader.stream_sensor_idx.get(self.id, 0)

    def is_lidar_scan(self) -> bool:
        return self.id in self.reader.scan_streams

    def decode(self, fields: Optional[List[str]] = None
               ) -> Optional[LidarScan]:
        if not self.is_lidar_scan():
            return None
        info = self.reader.sensor_info[self.sensor_idx]
        with profiling.span("osf.decode"):
            return decode_lidar_scan_msg(self.buffer, info, fields,
                                         self.reader.error_handler)


# ---------------------------------------------------------------------------
# LidarScanMsg codec
# ---------------------------------------------------------------------------

def _decode_channel(data: bytes) -> np.ndarray:
    """Decode a PNG- or zPNG-encoded channel buffer
    (ref: lidarscan_encoder.h:30-59 pluggable encoders)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return png_codec.decode_field_png(data)
    if zpng_codec.is_zpng(data):
        return zpng_codec.decode(data)
    raise ValueError("unknown channel encoding (bad_encoding)")


def _uint_view(arr: np.ndarray) -> np.ndarray:
    """Bit-pattern view as unsigned of the same element width
    (ref: field.h uint_view)."""
    nbytes = arr.dtype.itemsize
    udt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[nbytes]
    return np.ascontiguousarray(arr).view(udt)


def _encode_field_payload(arr: np.ndarray, encoder: str,
                          compression_level: int) -> bytes:
    """Field-table payload (ref: fb_common.cpp encode_fields +
    png_lidarscan_encoder.cpp:44-58 encode_field): 1-D and structured
    fields go raw; ndim>=2 goes through the active codec over a uint
    view collapsed to (shape[0], -1), with NO px_offset destagger —
    the real SDK's decode_field (png_tools.cpp:715-796) requires
    exactly this shape convention to read the bytes back."""
    if arr.ndim <= 1 or arr.dtype.names is not None:
        return np.ascontiguousarray(arr).tobytes()
    view = _uint_view(arr)
    if view.ndim > 2:
        view = view.reshape(view.shape[0], -1)
    if encoder == "zpng":
        return zpng_codec.encode(view, compression_level)
    return png_codec.encode_field_png(view, compression_level)


def encode_lidar_scan_msg(ls: LidarScan, info: SensorInfo,
                          field_types: Optional[List[FieldType]] = None,
                          compression_level: int = 1,
                          encoder: str = "png") -> bytes:
    """LidarScan -> LidarScanMsg flatbuffer
    (ref: stream_lidar_scan.cpp create_lidar_scan_msg)."""
    px_offset = info.format.pixel_shift_by_row
    b = fb.Builder()

    # split standard (CHAN_FIELD enum) vs custom fields
    wanted = None if field_types is None else {ft.name for ft in field_types}
    standard: List[Tuple[int, str]] = []
    custom: List[str] = []
    for name in ls.fields:
        if wanted is not None and name not in wanted:
            continue
        enum_val = _NAME_TO_CHAN_FIELD.get(name)
        if enum_val is not None and ls.field_class(name) == \
                FieldClass.PIXEL_FIELD and ls.field(name).ndim == 2:
            standard.append((enum_val, name))
        else:
            custom.append(name)
    standard.sort()

    def encode_img(img):
        if encoder == "zpng":
            return zpng_codec.encode(img, compression_level)
        return png_codec.encode_field_png(img, compression_level)

    # channels: encoded standard fields. PNG channels are stored
    # DESTAGGERED; zPNG channels are stored STAGGERED — the reference's
    # ZPngLidarScanEncoder ignores px_offset (zpng_lidarscan_encoder.cpp:24
    # `/*px_offset*/`) and its decoder restaggers only on the PNG path
    # (png_tools.cpp:715-796 tries zPNG raw first, then PNG+px_offset)
    channel_offs = []
    chan_field_structs = bytearray()
    for enum_val, name in standard:
        arr = _uint_view(ls.field(name))
        img = arr if encoder == "zpng" else _destagger(px_offset, arr)
        data = encode_img(img)
        vec = b.vector_bytes(data)
        b.start_table()
        b.slot_offset(0, vec)
        channel_offs.append(b.end_table())
        tag = _DTYPE_TO_TYPE[ls.field(name).dtype]
        chan_field_structs += struct.pack("<BB", enum_val, tag)

    channels_vec = b.vector_offsets(channel_offs) if channel_offs else None
    field_types_vec = (b.vector_structs(bytes(chan_field_structs),
                                        len(standard), align=1)
                       if standard else None)

    # custom fields -> Field tables with raw/PNG payloads
    custom_offs = []
    for name in custom:
        arr = ls.field(name)
        shape = arr.shape
        payload = _encode_field_payload(arr, encoder, compression_level)
        name_off = b.string(name)
        shape_off = b.vector_scalar(list(shape), np.uint64)
        data_off = b.vector_bytes(payload)
        b.start_table()
        b.slot_offset(0, name_off)
        tag = 30 if arr.dtype.names is not None else \
            _DTYPE_TO_TYPE.get(arr.dtype, 1)
        b.slot_scalar(1, "B", tag)
        b.slot_offset(2, shape_off)
        b.slot_scalar(3, "q", _FIELD_CLASS_TO_FB.get(
            ls.field_class(name), 4))
        b.slot_offset(4, data_off)
        b.slot_scalar(5, "Q", arr.nbytes)
        custom_offs.append(b.end_table())
    custom_vec = b.vector_offsets(custom_offs) if custom_offs else None

    ts_off = b.vector_scalar(ls.timestamp, np.uint64)
    mid_off = b.vector_scalar(ls.measurement_id, np.uint16)
    status_off = b.vector_scalar(ls.status, np.uint32)
    # pose: col-major 4x4 per column (ref: lidar_scan_stream.fbs pose)
    pose_cm = np.ascontiguousarray(
        np.transpose(ls.pose, (0, 2, 1))).reshape(-1)
    pose_off = None
    if not np.allclose(ls.pose, np.eye(4)):
        pose_off = b.vector_scalar(pose_cm, np.float64)
    pkt_ts_off = b.vector_scalar(ls.packet_timestamp, np.uint64)
    alert_off = b.vector_scalar(ls.alert_flags, np.uint8)

    b.start_table()
    if channels_vec:
        b.slot_offset(0, channels_vec)
    if field_types_vec:
        b.slot_offset(1, field_types_vec)
    b.slot_offset(2, ts_off)
    b.slot_offset(3, mid_off)
    b.slot_offset(4, status_off)
    b.slot_scalar(5, "i", ls.frame_id, default=0)
    if pose_off:
        b.slot_offset(6, pose_off)
    b.slot_offset(7, pkt_ts_off)
    if custom_vec:
        b.slot_offset(8, custom_vec)
    b.slot_scalar(9, "Q", ls.frame_status)
    b.slot_scalar(10, "B", ls.shutdown_countdown)
    b.slot_scalar(11, "B", ls.shot_limiting_countdown)
    b.slot_offset(12, alert_off)
    root = b.end_table()
    return b.finish(root, size_prefix=True)


def decode_lidar_scan_msg(buf: bytes, info: SensorInfo,
                          fields: Optional[List[str]] = None,
                          error_handler: Optional[ErrorHandler] = None
                          ) -> LidarScan:
    """LidarScanMsg flatbuffer -> LidarScan
    (ref: stream_lidar_scan.cpp restore_lidar_scan). Undecodable or
    unsupported fields are skipped through ``error_handler`` as WARNINGs
    (ref: fb_common.cpp:249-331 fb_restore_fields). Each channel decoded
    counts one `osf.fields_decoded`."""
    handler = error_handler or default_error_handler
    t = fb.root_auto(buf)
    h = info.format.pixels_per_column
    w = info.format.columns_per_frame
    px_offset = info.format.pixel_shift_by_row

    # channel specs: vector of ChannelField structs (u8, u8)
    cf = t.vector_np(1, np.dtype([("f", np.uint8), ("t", np.uint8)]))
    channels = t.vector_tables(0)

    field_types: List[FieldType] = []
    arrays: Dict[str, np.ndarray] = {}
    for i, spec in enumerate(cf):
        name = _CHAN_FIELD_TO_NAME.get(int(spec["f"]))
        dtype = _TYPE_TO_DTYPE.get(int(spec["t"]))
        if name is None or dtype is None:
            handler(Severity.WARNING,
                    f"Skipping channel with unsupported spec "
                    f"(field={int(spec['f'])} tag={int(spec['t'])})")
            continue
        if fields is not None and name not in fields:
            continue
        data = channels[i].vector_bytes(0)
        try:
            img = _decode_channel(data)
        except (ValueError, RuntimeError, zlib.error, struct.error) as e:
            handler(Severity.WARNING,
                    f"Skipping field '{name}': {e}")
            continue
        profiling.count("osf.fields_decoded")
        if zpng_codec.is_zpng(data):
            # zPNG channels are staggered on the wire (see encode)
            arr = img.view(dtype).astype(dtype, copy=False)
        else:
            arr = _stagger(px_offset, img).view(dtype) \
                .astype(dtype, copy=False)
        field_types.append(FieldType(name, dtype, (), FieldClass.PIXEL_FIELD))
        arrays[name] = arr

    # custom fields
    for ft_tbl in t.vector_tables(8):
        name = ft_tbl.string(0)
        if fields is not None and name not in fields:
            continue
        tag = ft_tbl.scalar(1, "B")
        shape = tuple(int(x) for x in ft_tbl.vector_np(2, np.uint64))
        fclass = _FB_TO_FIELD_CLASS.get(ft_tbl.scalar(3, "q"),
                                        FieldClass.SCAN_FIELD)
        payload = ft_tbl.vector_bytes(4)
        if tag == 30:  # ZONE_STATE structured records
            arr = np.frombuffer(payload, dtype=ZONE_STATE_DTYPE,
                                count=shape[0] if shape else -1)
            dtype = ZONE_STATE_DTYPE
        else:
            dtype = _TYPE_TO_DTYPE.get(tag)
            if dtype is None:
                # field from a newer SDK version (ref: fb_common.cpp:290)
                handler(Severity.WARNING,
                        f"Skipping field '{name}' with unsupported type "
                        f"(tag={tag})")
                continue
            if len(shape) >= 2 and (
                    payload[:8] == b"\x89PNG\r\n\x1a\n"
                    or zpng_codec.is_zpng(payload)):
                try:
                    img = _decode_channel(payload)
                except (ValueError, RuntimeError, zlib.error,
                        struct.error) as e:
                    handler(Severity.WARNING,
                            f"Skipping field '{name}': {e}")
                    continue
                arr = img.reshape(shape[0], -1).view(dtype).reshape(shape)
            else:
                arr = np.frombuffer(payload, dtype=dtype)
                if shape:
                    arr = arr.reshape(shape)
        extra = tuple(shape[2:]) if fclass == FieldClass.PIXEL_FIELD else \
            tuple(shape[1:]) if fclass in (FieldClass.COLUMN_FIELD,
                                           FieldClass.PACKET_FIELD) else shape
        field_types.append(FieldType(name, dtype, extra, fclass))
        arrays[name] = arr

    ls = LidarScan(w=w, h=h, field_types=[],
                   columns_per_packet=info.format.columns_per_packet)
    ls.sensor_info = info
    for ft in field_types:
        ls.add_field(ft, arrays[ft.name])

    ts = t.vector_np(2, np.uint64)
    if ts.size == w:
        ls.timestamp[:] = ts
    mid = t.vector_np(3, np.uint16)
    if mid.size == w:
        ls.measurement_id[:] = mid
    status = t.vector_np(4, np.uint32)
    if status.size == w:
        ls.status[:] = status
    ls.frame_id = t.scalar(5, "i", 0)
    pose = t.vector_np(6, np.float64)
    if pose.size == 16 * w:
        ls.pose[:] = np.transpose(pose.reshape(w, 4, 4), (0, 2, 1))
    pkt_ts = t.vector_np(7, np.uint64)
    n = min(pkt_ts.size, len(ls.packet_timestamp))
    ls.packet_timestamp[:n] = pkt_ts[:n]
    ls.frame_status = t.scalar(9, "Q", 0)
    ls.shutdown_countdown = t.scalar(10, "B", 0)
    ls.shot_limiting_countdown = t.scalar(11, "B", 0)
    alerts = t.vector_np(12, np.uint8)
    n = min(alerts.size, len(ls.alert_flags))
    ls.alert_flags[:n] = alerts[:n]
    return ls


# ---------------------------------------------------------------------------
# CollationMsg codec (ref: ouster_osf/src/collation_stream.cpp,
# fb/os_sensor/collation_stream.fbs)
# ---------------------------------------------------------------------------

def encode_collation_msg(scan_ids: List[Tuple[int, int]],
                         set_fields: Optional[Dict[str, np.ndarray]] = None,
                         compression_level: int = 1,
                         encoder: str = "png") -> bytes:
    """(sensor_id, scan_idx) list + set-level fields -> CollationMsg
    flatbuffer (ref: collation_stream.cpp create_collation_msg; set
    fields ride fb_save_fields, so multi-dim payloads are codec-encoded
    exactly like LidarScanMsg custom fields)."""
    b = fb.Builder()
    packed = b"".join(struct.pack("<I4xQ", sid, idx)
                      for sid, idx in scan_ids)
    ids_vec = b.vector_structs(packed, len(scan_ids), align=8)

    field_offs = []
    for name in sorted(set_fields or {}):
        arr = np.asarray(set_fields[name])
        name_off = b.string(name)
        shape_off = b.vector_scalar(list(arr.shape), np.uint64)
        data_off = b.vector_bytes(
            _encode_field_payload(arr, encoder, compression_level))
        b.start_table()
        b.slot_offset(0, name_off)
        tag = 30 if arr.dtype.names is not None else \
            _DTYPE_TO_TYPE.get(arr.dtype, 1)
        b.slot_scalar(1, "B", tag)
        b.slot_offset(2, shape_off)
        b.slot_scalar(3, "q", 4)  # SCAN_FIELD
        b.slot_offset(4, data_off)
        b.slot_scalar(5, "Q", arr.nbytes)
        field_offs.append(b.end_table())
    fields_vec = b.vector_offsets(field_offs) if field_offs else None

    b.start_table()
    b.slot_offset(0, ids_vec)
    if fields_vec:
        b.slot_offset(1, fields_vec)
    root = b.end_table()
    return b.finish(root, size_prefix=True)


def decode_collation_msg(buf: bytes) -> Tuple[List[Tuple[int, int]],
                                              Dict[str, np.ndarray]]:
    """CollationMsg flatbuffer -> ((sensor_id, scan_idx) list, set fields)
    (ref: collation_stream.cpp decode_msg)."""
    t = fb.root_auto(buf)
    ids = t.vector_np(0, _SCAN_ID_NP)
    scan_ids = [(int(r["sensor_id"]), int(r["scan_idx"])) for r in ids]
    set_fields: Dict[str, np.ndarray] = {}
    for ft_tbl in t.vector_tables(1):
        name = ft_tbl.string(0)
        tag = ft_tbl.scalar(1, "B")
        shape = tuple(int(x) for x in ft_tbl.vector_np(2, np.uint64))
        payload = ft_tbl.vector_bytes(4)
        dtype = _TYPE_TO_DTYPE.get(tag, np.dtype(np.uint8))
        if len(shape) >= 2 and (payload[:8] == b"\x89PNG\r\n\x1a\n"
                                or zpng_codec.is_zpng(payload)):
            img = _decode_channel(payload)
            arr = img.reshape(shape[0], -1).view(dtype).reshape(shape)
        else:
            arr = np.frombuffer(payload, dtype=dtype)
            if shape:
                arr = arr.reshape(shape)
        set_fields[name] = arr
    return scan_ids, set_fields


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class Reader:
    """OSF file reader (ref: reader.h:246, reader_base.cpp:34-66).

    ``error_handler(severity, message)`` receives recoverable problems
    (schema version skew, corrupt chunks, undecodable fields); the default
    logs WARNINGs and raises on ERROR, matching the reference default
    (ref: error_handler.cpp:12)."""

    def __init__(self, path: str,
                 error_handler: Optional[ErrorHandler] = None):
        self._path = path
        self.error_handler: ErrorHandler = \
            error_handler or default_error_handler
        # mmap the file (ref: memory_mapped_osf_file.cpp): chunk bytes are
        # paged in on demand, so opening a multi-GB OSF costs no RSS
        import mmap

        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._data = memoryview(self._mm)
        except (ValueError, OSError):  # empty file or fs without mmap
            self._mm = None
            self._data = memoryview(self._f.read())

        if len(self._data) < 12:
            raise ValueError("invalid OSF file: too short")
        hdr_size = _U32.unpack_from(self._data, 0)[0]
        hdr_block = self._data[: 4 + hdr_size + 4]
        if bytes(self._data[8:12]) != HEADER_IDENT:
            raise ValueError("invalid OSF file: bad header identifier")
        if not _block_crc_ok(hdr_block):
            raise ValueError("invalid OSF file: header CRC mismatch")
        hdr = fb.root_size_prefixed(self._data, HEADER_IDENT)
        self.version = hdr.scalar(0, "Q")
        # schema version gate (ref: reader_base.cpp:39-66): a newer MAJOR
        # is fatal (structural changes), a newer minor is best-effort
        major = self.version // 10 if self.version >= 10 else 1
        if major > OSF_VERSION // 10:
            self.error_handler(Severity.ERROR, (
                f"The OSF file was created with schema version "
                f"{major}.{self.version % 10} but this reader supports up "
                f"to major version {OSF_VERSION // 10}. The file will not "
                f"be read to prevent possible misinterpretation."))
        elif self.version > OSF_VERSION:
            self.error_handler(Severity.WARNING, (
                f"The OSF file was created with schema version "
                f"{major}.{self.version % 10}, newer than this reader's "
                f"{OSF_VERSION // 10}.{OSF_VERSION % 10}. Continuing in "
                f"best-effort compatibility mode."))
        self.status = hdr.scalar(1, "B")
        self.metadata_offset = hdr.scalar(2, "Q", 1)
        self.file_length = hdr.scalar(3, "Q", 1)
        if self.status != STATUS_VALID:
            raise ValueError("invalid OSF file: header status not VALID")
        if self.file_length != len(self._data):
            raise ValueError("invalid OSF file: file length mismatch")
        self._chunks_base = 4 + hdr_size + 4

        # metadata
        m_off = self.metadata_offset
        m_size = _U32.unpack_from(self._data, m_off)[0]
        m_block = self._data[m_off: m_off + 4 + m_size + 4]
        if not _block_crc_ok(m_block):
            raise ValueError("invalid OSF file: metadata CRC mismatch")
        meta = fb.root_size_prefixed(m_block, METADATA_IDENT)
        self.metadata_id = meta.string(0)
        self.start_ts = meta.scalar(1, "Q")
        self.end_ts = meta.scalar(2, "Q")
        # .copy(): vector_np is zero-copy over the mmap; this array must
        # survive close()
        self.chunk_offsets = meta.vector_np(
            3, np.dtype([("start_ts", np.uint64), ("end_ts", np.uint64),
                         ("offset", np.uint64)])).copy()
        self.entries: Dict[int, MetadataEntry] = {}
        for e in meta.vector_tables(4):
            ent = MetadataEntry(e.scalar(0, "I"), e.string(1),
                                e.vector_bytes(2))
            self.entries[ent.id] = ent

        # resolve sensors + scan streams
        self.sensor_info: List[SensorInfo] = []
        self._sensor_meta_ids: List[int] = []
        self.scan_streams: Dict[int, int] = {}  # stream id -> sensor meta id
        self.stream_sensor_idx: Dict[int, int] = {}
        self.collation_stream_id: Optional[int] = None
        for ent in sorted(self.entries.values(), key=lambda e: e.id):
            if ent.type == _METADATA_ENTRY_LIDAR_SENSOR:
                tbl = fb.root_auto(ent.buffer)
                info = sensor_info_from_metadata(tbl.string(0))
                self._sensor_meta_ids.append(ent.id)
                self.sensor_info.append(info)
        for ent in sorted(self.entries.values(), key=lambda e: e.id):
            if ent.type == _METADATA_ENTRY_LIDAR_SCAN_STREAM:
                tbl = fb.root_auto(ent.buffer)
                sensor_meta_id = tbl.scalar(0, "I")
                self.scan_streams[ent.id] = sensor_meta_id
                if sensor_meta_id in self._sensor_meta_ids:
                    self.stream_sensor_idx[ent.id] = \
                        self._sensor_meta_ids.index(sensor_meta_id)
            elif ent.type == _METADATA_ENTRY_COLLATION_STREAM:
                self.collation_stream_id = ent.id
            elif ent.type == _METADATA_ENTRY_EXTRINSICS:
                tbl = fb.root_auto(ent.buffer)
                ext = tbl.vector_np(0, np.float64)
                ref_id = tbl.scalar(1, "I")
                if ext.size == 16 and ref_id in self._sensor_meta_ids:
                    idx = self._sensor_meta_ids.index(ref_id)
                    self.sensor_info[idx].extrinsic = \
                        np.array(ext, dtype=np.float64).reshape(4, 4)

    def messages(self, start_ts: int = 0,
                 end_ts: int = 2**64 - 1) -> Iterator[MessageRef]:
        """Iterate messages in GLOBAL timestamp order (streaming layout;
        ref: reader.h:884 MessagesStreamingRange). Each chunk holds one
        stream's time-ordered messages, but chunks of different streams
        overlap in time — a k-way merge (not chunk concatenation)
        restores the cross-sensor interleave that collation needs."""
        import heapq

        order = [int(self.chunk_offsets["offset"][ci]) for ci in
                 (np.argsort(self.chunk_offsets["start_ts"],
                             kind="stable")
                  if len(self.chunk_offsets) else [])]
        # group chunks by stream (StreamingInfo) so each run is one
        # stream's chunks in time order — the merge then only parses
        # each stream's FIRST chunk upfront, keeping iteration lazy
        by_stream = self._chunks_by_stream()
        if by_stream is not None:
            starts = {off: k for k, off in enumerate(order)}
            groups = [sorted(offs, key=lambda o: starts.get(o, 0))
                      for offs in by_stream.values()]
        else:  # no StreamingInfo entry: one (eager) run per chunk
            groups = [[off] for off in order]

        def run(offsets, k):
            for off in offsets:
                for m in self._chunk_messages(off):
                    # (ts, run_idx) keeps the merge stable across equal
                    # timestamps without comparing MessageRefs
                    yield (m.ts, k, m)

        for _, _, msg in heapq.merge(
                *(run(g, k) for k, g in enumerate(groups))):
            if start_ts <= msg.ts <= end_ts:
                yield msg

    def _chunks_by_stream(self) -> Optional[Dict[int, List[int]]]:
        """chunk offset lists keyed by stream id, from the StreamingInfo
        metadata entry (ref: meta_streaming_info.cpp); None when the
        file carries no StreamingInfo."""
        for ent in self.entries.values():
            if ent.type != _METADATA_ENTRY_STREAMING_INFO:
                continue
            tbl = fb.root_auto(ent.buffer)
            out: Dict[int, List[int]] = {}
            for ci in tbl.vector_tables(0):
                off = ci.scalar(0, "Q")
                sid = ci.scalar(1, "I")
                out.setdefault(sid, []).append(int(off))
            return out
        return None

    def _chunk_messages(self, rel_offset: int) -> List[MessageRef]:
        pos = self._chunks_base + rel_offset
        size = _U32.unpack_from(self._data, pos)[0]
        block = self._data[pos: pos + 4 + size + 4]
        if not _block_crc_ok(block):
            # a non-raising handler means "skip the corrupt chunk and keep
            # going" (ref: reader.cpp:391-395)
            self.error_handler(
                Severity.ERROR, f"chunk CRC mismatch at offset {rel_offset}")
            return []
        chunk = fb.root_size_prefixed(block, CHUNK_IDENT)
        out = []
        for m in chunk.vector_tables(0):
            out.append(MessageRef(
                ts=m.scalar(0, "Q"), id=m.scalar(1, "I"),
                # zero-copy view into the mmap: indexing a multi-GB OSF
                # does not copy every payload into RAM (decode slices
                # it on demand); valid until Reader.close()
                buffer=m.vector_view(2), ts_sensor=m.scalar(3, "Q"),
                reader=self))
        return out

    def close(self) -> None:
        self._data = memoryview(b"")
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:
                # zero-copy MessageRef views still reference the mmap;
                # it unmaps when the last view is garbage-collected
                pass
            self._mm = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class LidarScanEncoder:
    """Field-image codec selector for the Writer
    (ref: lidarscan_encoder.h LidarScanEncoder)."""

    kind = "png"

    def __init__(self, compression_amount: int = 1):
        self.compression_amount = compression_amount


class PngLidarScanEncoder(LidarScanEncoder):
    """PNG field encoding (ref: png_lidarscan_encoder.h:39-51)."""

    kind = "png"


class ZPngLidarScanEncoder(LidarScanEncoder):
    """zPNG (filter+deflate, no PNG framing) field encoding
    (ref: zpng_lidarscan_encoder.h)."""

    kind = "zpng"


class Encoder:
    """Writer encoder wrapper (ref: _osf.cpp:1057 Encoder — holds the
    scan encoder the Writer uses)."""

    def __init__(self, scan_encoder: LidarScanEncoder):
        self.scan_encoder = scan_encoder


class Writer:
    """OSF file writer with streaming chunk layout
    (ref: writer.h:90, layout_streaming.cpp)."""

    def __init__(self, path: str, chunk_size: int = 2 * 1024 * 1024,
                 compression_level: int = 1, encoder="png"):
        if isinstance(encoder, Encoder):
            encoder = encoder.scan_encoder
        if isinstance(encoder, LidarScanEncoder):
            compression_level = encoder.compression_amount
            encoder = encoder.kind
        if encoder not in ("png", "zpng"):
            raise ValueError("encoder must be 'png' or 'zpng'")
        self._path = path
        self._chunk_size = chunk_size
        self._compression_level = compression_level
        self._encoder = encoder
        self._f = open(path, "wb")
        self._sensors: List[SensorInfo] = []
        self._sensor_field_types: List[Optional[List[FieldType]]] = []
        self._meta_entries: List[MetadataEntry] = []
        self._next_meta_id = 1
        self._sensor_meta_ids: List[int] = []
        self._stream_ids: List[int] = []
        # per-stream pending chunk state
        self._pending: List[Tuple[int, int, int, bytes]] = []
        self._pending_sizes: Dict[int, int] = {}
        self._chunks: List[Tuple[int, int, int]] = []  # start_ts,end_ts,off
        self._chunk_info: List[Tuple[int, int, int]] = []  # off,stream,count
        self._stream_stats: Dict[int, Dict[str, Any]] = {}
        self._chunks_written = 0
        self._collation_stream_id: Optional[int] = None
        self._start_ts: Optional[int] = None
        self._end_ts: int = 0
        self._closed = False

        # reserve header space: write INVALID header now
        hdr = self._build_header(STATUS_INVALID, 0, 0)
        self._header_size = len(hdr)
        self._f.write(hdr)
        self._chunks_base = self._f.tell()

    # -- metadata ----------------------------------------------------------
    def _build_header(self, status: int, metadata_offset: int,
                      file_length: int) -> bytes:
        b = fb.Builder()
        b.start_table()
        b.slot_scalar(0, "Q", OSF_VERSION)
        b.slot_scalar(1, "B", status)
        b.slot_scalar(2, "Q", metadata_offset, default=1)
        b.slot_scalar(3, "Q", file_length, default=1)
        root = b.end_table()
        body = b.finish(root, HEADER_IDENT, size_prefix=True)
        return _frame_block(body)

    def add_sensor(self, info: SensorInfo,
                   field_types: Optional[List[FieldType]] = None) -> int:
        """Register a sensor + its scan stream; returns sensor index
        (ref: writer.h add_sensor)."""
        if self._chunks_written or self._pending:
            raise RuntimeError("cannot add sensors after saving scans")
        b = fb.Builder()
        s = b.string(info.to_json_string())
        b.start_table()
        b.slot_offset(0, s)
        root = b.end_table()
        sensor_buf = b.finish(root, b"oLS_", size_prefix=True)
        sensor_meta_id = self._next_meta_id
        self._next_meta_id += 1
        self._meta_entries.append(MetadataEntry(
            sensor_meta_id, _METADATA_ENTRY_LIDAR_SENSOR, sensor_buf))

        b2 = fb.Builder()
        fts = field_types if field_types is not None \
            else get_field_types(info)
        cf_structs = bytearray()
        for ft in sorted(fts, key=lambda ft: _NAME_TO_CHAN_FIELD.get(
                ft.name, 255)):
            enum_val = _NAME_TO_CHAN_FIELD.get(ft.name)
            if enum_val is not None and ft.storage_dtype in _DTYPE_TO_TYPE:
                cf_structs += struct.pack(
                    "<BB", enum_val, _DTYPE_TO_TYPE[ft.storage_dtype])
        ft_vec = b2.vector_structs(bytes(cf_structs),
                                  len(cf_structs) // 2, align=1)
        b2.start_table()
        b2.slot_scalar(0, "I", sensor_meta_id)
        b2.slot_offset(1, ft_vec)
        root2 = b2.end_table()
        stream_buf = b2.finish(root2, b"oLSS", size_prefix=True)
        stream_id = self._next_meta_id
        self._next_meta_id += 1
        self._meta_entries.append(MetadataEntry(
            stream_id, _METADATA_ENTRY_LIDAR_SCAN_STREAM, stream_buf))

        self._sensors.append(info)
        self._sensor_field_types.append(field_types)
        self._sensor_meta_ids.append(sensor_meta_id)
        self._stream_ids.append(stream_id)
        return len(self._sensors) - 1

    def set_extrinsics(self, sensor_idx: int, extrinsic: np.ndarray) -> None:
        b = fb.Builder()
        vec = b.vector_scalar(np.asarray(extrinsic,
                                         dtype=np.float64).reshape(-1),
                              np.float64)
        b.start_table()
        b.slot_offset(0, vec)
        b.slot_scalar(1, "I", self._sensor_meta_ids[sensor_idx])
        root = b.end_table()
        self._meta_entries.append(MetadataEntry(
            self._next_meta_id, _METADATA_ENTRY_EXTRINSICS,
            b.finish(root, size_prefix=True)))
        self._next_meta_id += 1

    # -- messages ----------------------------------------------------------
    def save(self, sensor_idx: int, scan: LidarScan,
             ts: Optional[int] = None) -> None:
        """Serialize + enqueue one scan (ref: writer.h save)."""
        if self._closed:
            raise RuntimeError("writer is closed")
        info = self._sensors[sensor_idx]
        msg = encode_lidar_scan_msg(
            scan, info, self._sensor_field_types[sensor_idx],
            self._compression_level, encoder=self._encoder)
        if ts is None:
            ts = scan.first_valid_packet_timestamp() or \
                scan.first_valid_column_timestamp()
        ts_sensor = scan.first_valid_column_timestamp()
        self.save_message(self._stream_ids[sensor_idx], int(ts),
                          int(ts_sensor), msg)

    def save_set(self, ls_set: LidarScanSet) -> None:
        """Save a collated LidarScanSet: each scan goes to its sensor's
        stream, then a CollationMsg recording (sensor_id, scan_idx) pairs +
        the set-level fields goes to the collation stream
        (ref: writer.cpp:284-335 Writer::save(LidarScanSet)).

        Readers with collation support reconstruct the exact same grouping;
        older readers just see the per-sensor scan streams.
        """
        if self._closed:
            raise RuntimeError("writer is closed")
        if len(ls_set) != len(self._sensors):
            raise ValueError(
                "scan set size does not match number of sensor infos")
        if self._collation_stream_id is None:
            # lazily register the collation stream metadata entry; the
            # CollationStream table itself carries no data
            b = fb.Builder()
            b.start_table()
            root = b.end_table()
            self._collation_stream_id = self._next_meta_id
            self._next_meta_id += 1
            self._meta_entries.append(MetadataEntry(
                self._collation_stream_id, _METADATA_ENTRY_COLLATION_STREAM,
                b.finish(root, b"oCSt", size_prefix=True)))

        scan_ids: List[Tuple[int, int]] = []
        min_packet_ts = None
        for i, scan in enumerate(ls_set):
            if scan is None:
                scan_ids.append(INVALID_SCAN_ID)
                continue
            packet_ts = scan.first_valid_packet_timestamp()
            if packet_ts == 0:
                # collation replay keys messages on receive timestamps
                raise RuntimeError(
                    "Tried saving collation with scans having no valid "
                    "packet timestamps")
            min_packet_ts = packet_ts if min_packet_ts is None \
                else min(min_packet_ts, packet_ts)
            self.save(i, scan, ts=packet_ts)
            # scan_idx = message index within this sensor's stream
            count = self._stream_stats[self._stream_ids[i]]["count"]
            scan_ids.append((i, count - 1))

        msg = encode_collation_msg(
            scan_ids, {n: ls_set.field(n) for n in ls_set.fields},
            self._compression_level, encoder=self._encoder)
        self.save_message(self._collation_stream_id, int(min_packet_ts or 0),
                          0, msg)

    def save_message(self, stream_id: int, ts: int, ts_sensor: int,
                     buffer: bytes) -> None:
        self._pending.append((stream_id, ts, ts_sensor, buffer))
        self._pending_sizes[stream_id] = \
            self._pending_sizes.get(stream_id, 0) + len(buffer)
        if self._start_ts is None or ts < self._start_ts:
            self._start_ts = ts
        self._end_ts = max(self._end_ts, ts)
        st = self._stream_stats.setdefault(stream_id, {
            "start_ts": ts, "end_ts": ts, "count": 0, "bytes": 0,
            "receive_ts": [], "sensor_ts": []})
        st["start_ts"] = min(st["start_ts"], ts)
        st["end_ts"] = max(st["end_ts"], ts)
        st["count"] += 1
        st["bytes"] += len(buffer)
        st["receive_ts"].append(ts)
        st["sensor_ts"].append(ts_sensor)
        # streaming layout: one stream per chunk, flush on size threshold
        if self._pending_sizes[stream_id] >= self._chunk_size:
            self._flush_stream(stream_id)

    def _flush_stream(self, stream_id: int) -> None:
        msgs = [m for m in self._pending if m[0] == stream_id]
        if not msgs:
            return
        self._pending = [m for m in self._pending if m[0] != stream_id]
        self._pending_sizes[stream_id] = 0

        b = fb.Builder()
        msg_offs = []
        for sid, ts, ts_sensor, buf in msgs:
            data_off = b.vector_bytes(buf)
            b.start_table()
            b.slot_scalar(0, "Q", ts)
            b.slot_scalar(1, "I", sid)
            b.slot_offset(2, data_off)
            b.slot_scalar(3, "Q", ts_sensor)
            msg_offs.append(b.end_table())
        msgs_vec = b.vector_offsets(msg_offs)
        b.start_table()
        b.slot_offset(0, msgs_vec)
        root = b.end_table()
        block = _frame_block(b.finish(root, CHUNK_IDENT, size_prefix=True))

        rel_off = self._f.tell() - self._chunks_base
        ts_list = [m[1] for m in msgs]
        self._chunks.append((min(ts_list), max(ts_list), rel_off))
        self._chunk_info.append((rel_off, stream_id, len(msgs)))
        self._f.write(block)
        self._chunks_written += 1

    # -- finish ------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        for sid in list(self._pending_sizes):
            self._flush_stream(sid)

        # StreamingInfo metadata entry (ref: meta_streaming_info.cpp)
        b = fb.Builder()
        ci_offs = []
        for off, sid, count in self._chunk_info:
            b.start_table()
            b.slot_scalar(0, "Q", off)
            b.slot_scalar(1, "I", sid)
            b.slot_scalar(2, "I", count)
            ci_offs.append(b.end_table())
        ci_vec = b.vector_offsets(ci_offs) if ci_offs else None
        ss_offs = []
        for sid, st in sorted(self._stream_stats.items()):
            rts = b.vector_scalar(st["receive_ts"], np.uint64)
            sts = b.vector_scalar(st["sensor_ts"], np.uint64)
            b.start_table()
            b.slot_scalar(0, "I", sid)
            b.slot_scalar(1, "Q", st["start_ts"])
            b.slot_scalar(2, "Q", st["end_ts"])
            b.slot_scalar(3, "Q", st["count"])
            b.slot_scalar(4, "I", st["bytes"] // max(st["count"], 1))
            b.slot_offset(5, rts)
            b.slot_offset(6, sts)
            ss_offs.append(b.end_table())
        ss_vec = b.vector_offsets(ss_offs) if ss_offs else None
        b.start_table()
        if ci_vec:
            b.slot_offset(0, ci_vec)
        if ss_vec:
            b.slot_offset(1, ss_vec)
        root = b.end_table()
        self._meta_entries.append(MetadataEntry(
            self._next_meta_id, _METADATA_ENTRY_STREAMING_INFO,
            b.finish(root, size_prefix=True)))
        self._next_meta_id += 1

        # Metadata block
        metadata_offset = self._f.tell()
        mb = fb.Builder()
        id_off = mb.string(SDK_NAME)
        entry_offs = []
        for ent in sorted(self._meta_entries, key=lambda e: e.id):
            type_off = mb.string(ent.type)
            buf_off = mb.vector_bytes(ent.buffer)
            mb.start_table()
            mb.slot_scalar(0, "I", ent.id)
            mb.slot_offset(1, type_off)
            mb.slot_offset(2, buf_off)
            entry_offs.append(mb.end_table())
        entries_vec = mb.vector_offsets(entry_offs)
        chunks_packed = b"".join(
            struct.pack("<QQQ", s, e, o) for s, e, o in self._chunks)
        chunks_vec = mb.vector_structs(chunks_packed, len(self._chunks),
                                       align=8) if self._chunks else None
        mb.start_table()
        mb.slot_offset(0, id_off)
        mb.slot_scalar(1, "Q", self._start_ts or 0)
        mb.slot_scalar(2, "Q", self._end_ts)
        if chunks_vec:
            mb.slot_offset(3, chunks_vec)
        mb.slot_offset(4, entries_vec)
        m_root = mb.end_table()
        self._f.write(_frame_block(mb.finish(m_root, METADATA_IDENT,
                                             size_prefix=True)))

        file_length = self._f.tell()

        # flip header INVALID -> VALID in place
        hdr = self._build_header(STATUS_VALID, metadata_offset, file_length)
        if len(hdr) != self._header_size:
            raise RuntimeError("header size changed between writes")
        self._f.seek(0)
        self._f.write(hdr)
        self._f.close()
        self._closed = True

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncWriter:
    """Background-thread writer (ref: async_writer.cpp): save() enqueues,
    a worker thread serializes and writes."""

    def __init__(self, path: str, **kw):
        import queue
        import threading

        self._writer = Writer(path, **kw)
        self._q: "queue.Queue" = queue.Queue(maxsize=16)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add_sensor(self, info: SensorInfo, field_types=None) -> int:
        return self._writer.add_sensor(info, field_types)

    def save(self, sensor_idx: int, scan: LidarScan,
             ts: Optional[int] = None) -> None:
        if self._exc:
            raise RuntimeError("async writer failed") from self._exc
        self._q.put(("save", sensor_idx, scan, ts))

    def save_set(self, ls_set: LidarScanSet) -> None:
        if self._exc:
            raise RuntimeError("async writer failed") from self._exc
        self._q.put(("save_set", ls_set, None, None))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # drain after a failure so producers never block
            try:
                op, a, scan, ts = item
                if op == "save_set":
                    self._writer.save_set(a)
                else:
                    self._writer.save(a, scan, ts)
            except BaseException as e:  # noqa: BLE001
                self._exc = e  # keep draining; surfaced by save()/close()

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
        self._thread.join()
        self._writer.close()
        if self._exc:
            raise RuntimeError("async writer failed") from self._exc

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# ScanSource
# ---------------------------------------------------------------------------

class OsfScanSource(ScanSource):
    """Indexed ScanSource over an OSF file (ref: osf_scan_source.cpp).
    `device` is where the projector runs (None: CUDA, an error at
    iteration without a GPU)."""

    def __init__(self, path: str, *, field_names: Optional[List[str]] = None,
                 extrinsics=None, extrinsics_file=None, index: bool = True,
                 read_collations: bool = True,
                 error_handler: Optional[ErrorHandler] = None,
                 device=None):
        self._reader = Reader(path, error_handler)
        self._device = device
        infos = self._reader.sensor_info
        populate_extrinsics(infos, extrinsics, extrinsics_file)
        super().__init__(infos)
        self._field_names = field_names
        self._msg_index: List[Tuple[int, MessageRef]] = []
        self._collation_index: List[MessageRef] = []
        coll_id = self._reader.collation_stream_id if read_collations else None
        for msg in self._reader.messages():
            if msg.is_lidar_scan():
                self._msg_index.append((msg.sensor_idx, msg))
            elif coll_id is not None and msg.id == coll_id:
                self._collation_index.append(msg)
        # per-sensor message lists in stream order, for scan_idx resolution
        # (ref: osf_scan_source.cpp:178-201 resolve_scan_)
        self._per_sensor: List[List[MessageRef]] = \
            [[] for _ in self.sensor_info]
        for idx, msg in self._msg_index:
            self._per_sensor[idx].append(msg)
        self._device_proj = _UNSET  # resolved lazily (see _projector)

    def is_collated(self) -> bool:
        """True when the file records explicit scan groupings
        (ref: osf_scan_source.cpp:564)."""
        return len(self._collation_index) > 0

    def _projector(self):
        """The OSF device route (lazy): PNG/zstd decode stays host-side
        (like the reference's libpng path), then decoded RANGE/RANGE2
        images batch through the double-single projection on `device` and
        each scan carries a snapshot-guarded XYZ cache that XYZLutFactory
        serves (device_engine.OsfDeviceProjector). None where the policy
        (OUSTER_SDK_TPU_DEVICE_DECODE=0) is off or no sensor is eligible."""
        if self._device_proj is _UNSET:
            from . import device_engine as de

            self._device_proj = de.make_osf_projector(
                self.sensor_info, self._field_names, device=self._device)
        return self._device_proj

    def _resolve_collation(self, msg: MessageRef) -> LidarScanSet:
        scan_ids, set_fields = decode_collation_msg(msg.buffer)
        scans: List[Optional[LidarScan]] = []
        for sid, scan_idx in scan_ids:
            if (sid, scan_idx) == INVALID_SCAN_ID or \
                    sid >= len(self._per_sensor):
                scans.append(None)
                continue
            lst = self._per_sensor[sid]
            if scan_idx >= len(lst):
                raise IndexError("Tried accessing scan beyond index range")
            scans.append(lst[scan_idx].decode(self._field_names))
        proj = self._projector()
        if proj is not None:
            proj.attach([(sid, s)
                         for (sid, _), s in zip(scan_ids, scans)])
        out = LidarScanSet(scans)
        for name, arr in set_fields.items():
            out.add_field(name, arr)
        return out

    @property
    def is_indexed(self) -> bool:
        return True

    def _iter_scans(self):
        it = self._iter_scans_host()
        proj = self._projector()
        if proj is not None:
            yield from proj.wrap(it)
        else:
            yield from it

    def _iter_scans_host(self):
        for idx, msg in self._msg_index:
            scan = msg.decode(self._field_names)
            if scan is not None:
                yield idx, scan

    def _iter_sets(self):
        if self.is_collated():
            # replay the writer's recorded groupings exactly
            return (self._resolve_collation(m)
                    for m in self._collation_index)
        return collate_scans(self._iter_scans(), len(self.sensor_info))

    def __len__(self) -> int:
        if self.is_collated():
            return len(self._collation_index)
        counts: Dict[int, int] = {}
        for idx, _ in self._msg_index:
            counts[idx] = counts.get(idx, 0) + 1
        return max(counts.values(), default=0)

    def __getitem__(self, i) -> LidarScanSet:
        n = len(self)
        if isinstance(i, slice):
            if i.step is not None and i.step <= 0:
                # forward-slicing semantics (ref: forward_slicer.py —
                # sources only slice forward)
                raise ValueError("scan sources require a positive step")
            return [self[j] for j in range(*i.indices(n))]
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if self.is_collated():
            return self._resolve_collation(self._collation_index[i])
        scans = [lst[i].decode(self._field_names) if i < len(lst) else None
                 for lst in self._per_sensor]
        proj = self._projector()
        if proj is not None:
            proj.attach(list(enumerate(scans)))
        return LidarScanSet(scans)

    @property
    def scans_num(self) -> List[int]:
        counts = [0] * len(self.sensor_info)
        for idx, _ in self._msg_index:
            counts[idx] += 1
        return counts

    def full_index(self) -> List[List[Tuple[int, int]]]:
        """Per-sensor (timestamp, scan_index) pairs
        (ref: scan_source.h full_index)."""
        out: List[List[Tuple[int, int]]] = [[] for _ in self.sensor_info]
        counters = [0] * len(self.sensor_info)
        for idx, msg in self._msg_index:
            out[idx].append((msg.ts, counters[idx]))
            counters[idx] += 1
        return out

    def time_range(self) -> Tuple[int, int]:
        return self._reader.start_ts, self._reader.end_ts

    def close(self) -> None:
        self._reader.close()
