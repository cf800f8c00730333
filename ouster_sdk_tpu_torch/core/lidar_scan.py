"""LidarScan: one assembled frame of lidar data.

The SDK's LidarScan container
(ref: ouster_client/include/ouster/lidar_scan.h:122-206). Host representation
is struct-of-numpy-arrays; `get_field_types` reproduces the SDK's
per-profile default field sets (ref: lidar_scan.cpp:799-893). A scan made
by the live device route carries a deferred fill: its pixel fields stay on
the device until a field is first touched.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from .constants import (
    ChanField,
    FRAME_STATUS_SHOT_LIMITING_SHIFT,
    FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT,
    NMEA_SENTENCE_LENGTH,
)
from .field import FieldClass, FieldType, ZONE_STATE_DTYPE
from .types import (
    DataFormat,
    SensorInfo,
    ShotLimitingStatus,
    ThermalShutdownStatus,
    UDPProfileIMU,
    UDPProfileLidar,
    Version,
)
from ..ops.profiles import lookup_scan_fields


def get_field_types(
    info_or_format: Union[SensorInfo, DataFormat],
    fw_version: Optional[Version] = None,
) -> List[FieldType]:
    """Default fields for a profile + IMU/zone scan-level extras
    (ref: lidar_scan.cpp:799-893)."""
    if isinstance(info_or_format, SensorInfo):
        fmt = info_or_format.format
        fw_version = info_or_format.get_version()
    else:
        fmt = info_or_format
        fw_version = fw_version or Version()

    C = ChanField
    out: List[FieldType] = []
    for name, dtype in lookup_scan_fields(fmt.udp_profile_lidar):
        extra = (3,) if name == C.RGB else ()
        out.append(FieldType(name, dtype, extra, FieldClass.PIXEL_FIELD))

    imu_meas = fmt.imu_packets_per_frame * fmt.imu_measurements_per_packet
    if fmt.udp_profile_imu == UDPProfileIMU.ACCEL32_GYRO32_NMEA:
        S = FieldClass.SCAN_FIELD
        out += [
            FieldType(C.IMU_ACC, np.float32, (imu_meas, 3), S),
            FieldType(C.IMU_GYRO, np.float32, (imu_meas, 3), S),
            FieldType(C.IMU_TIMESTAMP, np.uint64, (imu_meas,), S),
            FieldType(C.IMU_MEASUREMENT_ID, np.uint16, (imu_meas,), S),
            FieldType(C.IMU_STATUS, np.uint16, (imu_meas,), S),
            FieldType(C.IMU_PACKET_TIMESTAMP, np.uint64,
                      (fmt.imu_packets_per_frame,), S),
            FieldType(C.POSITION_STRING, np.dtype("S1"),
                      (fmt.imu_packets_per_frame, NMEA_SENTENCE_LENGTH), S),
            FieldType(C.POSITION_LAT_LONG, np.float64,
                      (fmt.imu_packets_per_frame, 2), S),
            FieldType(C.POSITION_TIMESTAMP, np.uint64,
                      (fmt.imu_packets_per_frame,), S),
            FieldType(C.IMU_ALERT_FLAGS, np.uint8,
                      (fmt.imu_packets_per_frame,), S),
        ]

    if fmt.zone_monitoring_enabled:
        S = FieldClass.SCAN_FIELD
        out += [
            FieldType(C.LIVE_ZONESET_HASH, np.uint8, (32,), S),
            FieldType(C.ZONE_TIMESTAMP, np.uint64, (1,), S),
            FieldType(C.ZONE_PACKET_TIMESTAMP, np.uint64, (1,), S),
            FieldType(C.ZONE_ALERT_FLAGS, np.uint8, (1,), S),
            FieldType(C.ZONE_STATES, ZONE_STATE_DTYPE, (16,), S),
        ]

    # WINDOW requires fw >= 3.2 (ref: lidar_scan.cpp:882-890)
    if fw_version < Version(3, 2, 0):
        out = [ft for ft in out if ft.name != C.WINDOW]

    return out


def resolve_field_types(metadata, raw_headers: bool = False,
                        raw_fields: bool = False,
                        field_names=None) -> List[List[FieldType]]:
    """Per-sensor field types for a set of metadata, with optional raw
    header/word channels (ref: open_source.h:226 /
    python field.cpp:156 "resolve_field_types")."""
    if isinstance(metadata, SensorInfo):
        metadata = [metadata]
    out: List[List[FieldType]] = []
    for info in metadata:
        fts = get_field_types(info)
        if field_names is not None:
            fts = [ft for ft in fts if ft.name in field_names]
        if raw_headers and not any(ft.name == ChanField.RAW_HEADERS
                                   for ft in fts):
            fts = list(fts) + [FieldType(ChanField.RAW_HEADERS, np.uint8,
                                         (), FieldClass.PIXEL_FIELD)]
        if raw_fields:
            from ..ops.unpack import make_decode_plan

            pw = make_decode_plan(info).pw
            have = {ft.name for ft in fts}
            fts = list(fts) + [
                FieldType(f"RAW32_WORD{k + 1}", np.uint32, (),
                          FieldClass.PIXEL_FIELD)
                for k in range(pw) if f"RAW32_WORD{k + 1}" not in have]
        out.append(fts)
    return out


class LidarScan:
    """One frame: H x W pixel fields + per-column/packet/scan headers.

    (ref: lidar_scan.h:122-206). Header semantics:
      - timestamp: (w,) uint64, per-column sensor timestamps
      - measurement_id: (w,) uint16
      - status: (w,) uint32 (bit 0 = valid)
      - packet_timestamp: (w / columns_per_packet,) uint64 host receive times
      - alert_flags: (packets,) uint8
      - pose: (w, 4, 4) float64 per-column world poses (row-major identity)
    """

    def __init__(
        self,
        info: Optional[SensorInfo] = None,
        _pos2=None,
        _pos3=None,
        _pos4=None,
        *,
        w: Optional[int] = None,
        h: Optional[int] = None,
        field_types: Optional[List[FieldType]] = None,
        columns_per_packet: int = 16,
    ):
        if isinstance(info, LidarScan):
            # copy constructor (ref: lidar_scan.h LidarScan(const LidarScan&),
            # used by e.g. MaskedScanSource to yield modified copies)
            import copy as _copy

            info._resolve_deferred()  # copies own independent host arrays
            self.__dict__.update(_copy.deepcopy(info).__dict__)
            if isinstance(_pos2, (list, tuple)) or field_types is not None:
                # LidarScan(scan, field_types): clone with the requested
                # field set — existing fields cast elementwise, missing
                # fields zero-filled, absent ones dropped
                # (ref: lidar_scan.h LidarScan(const LidarScan&,
                # const std::vector<FieldType>&);
                # python/tests/test_data.py:495-563
                # copy_extension/retraction/cast)
                want = list(_pos2) if isinstance(_pos2, (list, tuple)) \
                    else list(field_types)
                old_fields, old_types = self._fields, self._field_types
                self._fields, self._field_types = {}, {}
                n_packets = (-(-self.w // self.columns_per_packet)
                             if self.columns_per_packet else 0)
                for ft in want:
                    name = str(ft.name)
                    shape = ft.shape(self.h, self.w, n_packets)
                    src = old_fields.get(name)
                    if src is not None and src.shape == shape:
                        arr = src.astype(ft.storage_dtype, copy=True)
                    else:
                        arr = np.zeros(shape, dtype=ft.storage_dtype)
                    self._fields[name] = arr
                    self._field_types[name] = ft
            return
        if isinstance(info, (int, np.integer)):
            # positional overloads, all (h, w)-first like the reference
            # bindings' lambdas (ref: python/src/cpp/client/
            # lidar_scan.cpp:60-103 — note the py::arg names of the
            # field_types overload are swapped there; positional order
            # is what its own tests rely on):
            #   (h, w) / (h, w, profile, cpp=16) / (h, w, field_types, cpp=16)
            h, w = int(info), int(_pos2)
            if _pos4 is not None:
                columns_per_packet = int(_pos4)
            if isinstance(_pos3, (list, tuple)):
                field_types = list(_pos3)
            elif _pos3 is not None:
                profile = _pos3
                if isinstance(profile, str):
                    profile = UDPProfileLidar.from_string(profile)
                field_types = get_field_types(DataFormat(
                    pixels_per_column=h, columns_per_frame=w,
                    columns_per_packet=columns_per_packet,
                    udp_profile_lidar=profile))
            info = None
        elif info is not None and isinstance(_pos2, (list, tuple)):
            # (sensor_info, field_types) overload
            # (ref: lidar_scan.cpp:132-135)
            field_types = list(_pos2)
        if info is not None:
            w = info.format.columns_per_frame
            h = info.format.pixels_per_column
            columns_per_packet = info.format.columns_per_packet
            if field_types is None:
                field_types = get_field_types(info)
        if w is None or h is None:
            raise ValueError("LidarScan requires dimensions or SensorInfo")
        if field_types is None:
            field_types = get_field_types(
                DataFormat(pixels_per_column=h, columns_per_frame=w,
                           columns_per_packet=columns_per_packet,
                           udp_profile_lidar=UDPProfileLidar.LEGACY))

        self.w = int(w)
        self.h = int(h)
        self.columns_per_packet = int(columns_per_packet)
        # packet headers are wide enough for a PARTIAL trailing packet:
        # ceil(w / columns_per_packet)
        # (ref: python/tests/test_data.py:824-831 packet_header_width)
        n_packets = -(-self.w // self.columns_per_packet) \
            if self.columns_per_packet else 0

        self.frame_id: int = -1
        self.frame_status: int = 0
        self.shutdown_countdown: int = 0
        self.shot_limiting_countdown: int = 0
        self.sensor_info: Optional[SensorInfo] = info

        self.timestamp = np.zeros(self.w, dtype=np.uint64)
        self.packet_timestamp = np.zeros(n_packets, dtype=np.uint64)
        self.alert_flags = np.zeros(n_packets, dtype=np.uint8)
        self.measurement_id = np.zeros(self.w, dtype=np.uint16)
        self.status = np.zeros(self.w, dtype=np.uint32)
        self.pose = np.broadcast_to(
            np.eye(4, dtype=np.float64), (self.w, 4, 4)).copy()

        self._fields: Dict[str, np.ndarray] = {}
        self._field_types: Dict[str, FieldType] = {}
        # device-projected XYZ cache (attach_xyz_cache): does not
        # participate in equality/serialization
        self._xyz_cache: Dict = {}
        # deferred pixel-field fill (set_deferred_fields): device routes
        # keep the decoded frame in device memory and run this on first
        # touch.
        # Lock is PER SCAN so first-touch readbacks of unrelated scans
        # (different sensors / consumer threads) never serialize against
        # each other; reentrant because a fill writes through field().
        self._deferred_fields = None
        self._deferred_lock = threading.RLock()
        for ft in field_types:
            self.add_field(ft)

    # -- deferred (device-resident) pixel fields ----------------------------
    def set_deferred_fields(self, fill) -> None:
        """Defer pixel-field population: `fill(self)` runs once, the
        first time any field is touched. The live device route keeps the
        decoded frame in device memory and defers the device->host
        readback here, so scans that are only counted/queued/dropped (or
        consumed by further device stages) never pay a device->host
        copy. Header arrays (timestamp /
        measurement_id / status / pose / packet headers) are always
        populated eagerly and never defer."""
        self._deferred_fields = fill

    def _resolve_deferred(self) -> None:
        # the per-scan lock makes first-touch materialization safe across
        # threads (producer thread vs consumer(s)). A failed fill restores
        # the hook so the scan never silently serves its zero-initialized
        # arrays as data, and is wrapped so a late failure (arbitrary
        # field()/__eq__ call, possibly after the source closed) is
        # attributable to the live decode pipeline it originated in.
        with self._deferred_lock:
            fill = getattr(self, "_deferred_fields", None)
            if fill is None:
                return
            self._deferred_fields = None
            try:
                fill(self)
            except Exception as exc:
                self._deferred_fields = fill
                raise RuntimeError(
                    "deferred device readback failed while materializing "
                    f"pixel fields of frame_id={self.frame_id} "
                    f"({type(exc).__name__}: {exc}); the scan was decoded "
                    "on-device by the live pipeline and its fields resolve "
                    "lazily on first access") from exc
            except BaseException:  # KeyboardInterrupt etc: pass through
                self._deferred_fields = fill
                raise

    @property
    def fields_deferred(self) -> bool:
        """Whether pixel fields still await their device readback."""
        return getattr(self, "_deferred_fields", None) is not None

    def __getstate__(self):
        # a copied/pickled scan must carry real pixel data: resolve any
        # deferred device readback first (the fill closure and the
        # per-scan lock are process-local and unpicklable)
        self._resolve_deferred()
        state = self.__dict__.copy()
        state.pop("_deferred_lock", None)
        state["_deferred_fields"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._deferred_lock = threading.RLock()

    # -- device-projected XYZ cache ----------------------------------------
    def attach_xyz_cache(self, return_idx: int, use_extrinsics: bool,
                         xyz: np.ndarray, rng_snapshot: np.ndarray) -> None:
        """Attach a device-projected point cloud for this scan's CURRENT
        range content (the OSF device route stores its fused-projection
        output here; XYZLutFactory serves it instead of re-projecting on
        the host). `rng_snapshot` is the exact range image the projection
        consumed — retrieval compares it against the live field, so a
        later in-place mutation of RANGE can never serve stale points."""
        if not hasattr(self, "_xyz_cache"):  # copied/unpickled instances
            self._xyz_cache = {}
        # snapshot must be an independent copy: np.asarray of the live
        # field aliases it, and an aliased snapshot tracks every mutation
        # (defeating the staleness guard)
        self._xyz_cache[(int(return_idx), bool(use_extrinsics))] = (
            np.asarray(xyz), np.array(rng_snapshot, copy=True))

    def cached_xyz(self, return_idx: int, use_extrinsics: bool,
                   rng: np.ndarray):
        """The device-projected XYZ for (return, frame) if one is attached
        AND the scan's range content is unchanged since projection; else
        None (callers fall back to the host path)."""
        hit = getattr(self, "_xyz_cache", {}).get(
            (int(return_idx), bool(use_extrinsics)))
        if hit is None:
            return None
        xyz, snap = hit
        if not np.array_equal(np.asarray(rng), snap):
            return None
        return xyz

    # -- field management -------------------------------------------------
    def add_field(self, ft, data: Optional[np.ndarray] = None,
                  field_class: FieldClass = FieldClass.PIXEL_FIELD,
                  *, dtype=None, shape=()) -> np.ndarray:
        """Add a field. Accepts the reference's three call forms
        (ref: lidar_scan.h:446-471; client.pyi add_field overloads):
        add_field(FieldType), add_field(name, array[, field_class]),
        add_field(name, dtype=…, shape=…[, field_class])."""
        if isinstance(ft, str):
            name = ft
            if data is not None and not isinstance(data, (type,
                                                          np.dtype)):
                arr = np.asarray(data)
                lead = {FieldClass.PIXEL_FIELD: 2,
                        FieldClass.COLUMN_FIELD: 1,
                        FieldClass.PACKET_FIELD: 1}.get(field_class, 0)
                ft = FieldType(name, arr.dtype, arr.shape[lead:],
                               field_class)
                return self.add_field(ft, arr)
            # (name, dtype, shape) form — dtype may arrive positionally
            dt = np.dtype(dtype if dtype is not None else
                          (data if data is not None else np.uint32))
            ft = FieldType(name, dt, tuple(shape), field_class)
            return self.add_field(ft)
        if ft.name in self._fields:
            raise ValueError(f"Duplicated field {ft.name!r}")
        self._resolve_deferred()
        shape = ft.shape(self.h, self.w, len(self.packet_timestamp))
        if data is None:
            data = np.zeros(shape, dtype=ft.storage_dtype)
        else:
            data = np.asarray(data, dtype=ft.storage_dtype).reshape(shape)
        self._fields[ft.name] = data
        self._field_types[ft.name] = ft
        return data

    def del_field(self, name: str) -> np.ndarray:
        if name not in self._fields:
            raise ValueError(f"No such field {name!r}")
        self._resolve_deferred()
        self._field_types.pop(name)
        return self._fields.pop(name)

    def field(self, name: str) -> np.ndarray:
        if name not in self._fields:
            # std::out_of_range -> IndexError, like the binding
            # (ref: lidar_scan.cpp:410); unknown names never force a
            # deferred readback
            raise IndexError(f"Field '{name}' not found in LidarScan.")
        self._resolve_deferred()
        return self._fields[name]

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def field_class(self, name: str) -> FieldClass:
        return self._field_types[name].field_class

    @property
    def fields(self) -> Iterator[str]:
        return iter(sorted(self._fields))

    @property
    def field_types(self) -> List[FieldType]:
        return [self._field_types[k] for k in sorted(self._field_types)]

    # -- derived status ---------------------------------------------------
    def thermal_shutdown(self) -> ThermalShutdownStatus:
        return ThermalShutdownStatus(
            (self.frame_status >> FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT) & 0x0F)

    def shot_limiting(self) -> ShotLimitingStatus:
        return ShotLimitingStatus(
            (self.frame_status >> FRAME_STATUS_SHOT_LIMITING_SHIFT) & 0x0F)

    # -- column helpers (ref: lidar_scan.h:574-700) -----------------------
    def complete(self, window: Optional[Tuple[int, int]] = None) -> bool:
        if window is None:
            if self.sensor_info is not None:
                window = self.sensor_info.format.column_window
            else:
                # (ref: python/tests/test_data.py:193-199 — complete()
                # without a window needs a sensor_info to supply one)
                raise RuntimeError(
                    "LidarScan::complete: no column window provided "
                    "and scan has no sensor_info")
        start, end = window
        status = self.status
        if start <= end:
            cols = status[start:end + 1]
        else:
            cols = np.concatenate([status[start:], status[:end + 1]])
        return bool(np.all(cols & 0x01))

    def first_valid_column(self) -> int:
        valid = np.flatnonzero(self.status & 0x01)
        return int(valid[0]) if valid.size else -1

    def last_valid_column(self) -> int:
        valid = np.flatnonzero(self.status & 0x01)
        return int(valid[-1]) if valid.size else -1

    def first_valid_column_timestamp(self) -> int:
        c = self.first_valid_column()
        return int(self.timestamp[c]) if c >= 0 else 0

    def last_valid_column_timestamp(self) -> int:
        c = self.last_valid_column()
        return int(self.timestamp[c]) if c >= 0 else 0

    def first_valid_packet_timestamp(self) -> int:
        nz = np.flatnonzero(self.packet_timestamp)
        return int(self.packet_timestamp[nz[0]]) if nz.size else 0

    def last_valid_packet_timestamp(self) -> int:
        nz = np.flatnonzero(self.packet_timestamp)
        return int(self.packet_timestamp[nz[-1]]) if nz.size else 0

    def get_first_valid_column_pose(self) -> np.ndarray:
        c = max(self.first_valid_column(), 0)
        return self.pose[c]

    @property
    def packet_count(self) -> int:
        """Packets per full scan given w and columns_per_packet
        (ref: client.pyi LidarScan.packet_count)."""
        return len(self.packet_timestamp)

    @property
    def zones(self) -> np.ndarray:
        """ZONE_STATES records as a structured array, empty when the
        scan carries no zone data (ref: client.pyi LidarScan.zones)."""
        from .field import ZONE_STATE_DTYPE

        if self.has_field(ChanField.ZONE_STATES):
            return self.field(ChanField.ZONE_STATES)
        return np.zeros(0, dtype=ZONE_STATE_DTYPE)

    # reference binding method names (ref: python/src/cpp/client/
    # lidar_scan.cpp "get_first_valid_column" etc.)
    def get_first_valid_column(self) -> int:
        return self.first_valid_column()

    def get_last_valid_column(self) -> int:
        return self.last_valid_column()

    def get_first_valid_column_timestamp(self) -> int:
        return self.first_valid_column_timestamp()

    def get_last_valid_column_timestamp(self) -> int:
        return self.last_valid_column_timestamp()

    def get_first_valid_packet_timestamp(self) -> int:
        return self.first_valid_packet_timestamp()

    def get_last_valid_packet_timestamp(self) -> int:
        return self.last_valid_packet_timestamp()

    def get_first_valid_lidar_packet_timestamp(self) -> int:
        return self.first_valid_packet_timestamp()

    def get_last_valid_lidar_packet_timestamp(self) -> int:
        return self.last_valid_packet_timestamp()

    def set_column_pose(self, idx: int, pose: np.ndarray) -> None:
        self.pose[idx] = pose

    # -- equality (ref: lidar_scan.cpp operator==) ------------------------
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, LidarScan):
            return NotImplemented
        if (self.w, self.h, self.frame_id, self.frame_status) != \
                (other.w, other.h, other.frame_id, other.frame_status):
            return False
        if sorted(self._fields) != sorted(other._fields):
            return False
        self._resolve_deferred()
        other._resolve_deferred()
        for k in self._fields:
            a, b = self._fields[k], other._fields[k]
            # dtype/shape are part of field identity: a u16 SIGNAL scan
            # is not equal to a u32 one even with identical values
            # (ref: python/tests/test_data.py:390-409 ls3 != ls4)
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not np.array_equal(a, b):
                return False
        return (
            np.array_equal(self.timestamp, other.timestamp)
            and np.array_equal(self.measurement_id, other.measurement_id)
            and np.array_equal(self.status, other.status)
            and np.array_equal(self.packet_timestamp, other.packet_timestamp)
            and np.array_equal(self.pose, other.pose)
        )

    def __repr__(self) -> str:
        return (f"LidarScan(w={self.w}, h={self.h}, "
                f"frame_id={self.frame_id}, "
                f"fields={sorted(self._fields)})")
