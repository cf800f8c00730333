"""Core sensor metadata model: enums, DataFormat, SensorConfig, SensorInfo.

The reference's core types (ref: ouster_client/include/ouster/types.h:
64-1108) as Python dataclasses with optional fields. Matrices are numpy
float64 arrays (the device carries hi/lo float32 splits derived from them,
see ops/xyzlut.py). `SensorInfo.to_json_string` is the metadata json an OSF
file stores for its sensor, the zone set (zone.ZoneSet) included.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class UDPProfileLidar(Enum):
    """Lidar packet profiles (ref: types.h:304 and types.cpp string table)."""

    UNKNOWN = "UNKNOWN"
    LEGACY = "LEGACY"
    RNG19_RFL8_SIG16_NIR16_DUAL = "RNG19_RFL8_SIG16_NIR16_DUAL"
    RNG19_RFL8_SIG16_NIR16 = "RNG19_RFL8_SIG16_NIR16"
    RNG15_RFL8_NIR8 = "RNG15_RFL8_NIR8"
    FIVE_WORD_PIXEL = "FIVE_WORD_PIXEL"
    FUSA_RNG15_RFL8_NIR8_DUAL = "FUSA_RNG15_RFL8_NIR8_DUAL"
    RNG15_RFL8_NIR8_DUAL = "RNG15_RFL8_NIR8_DUAL"
    RNG15_RFL8_NIR8_ZONE16 = "RNG15_RFL8_NIR8_ZONE16"
    RNG19_RFL8_SIG16_NIR16_ZONE16 = "RNG19_RFL8_SIG16_NIR16_ZONE16"
    RNG15_RFL8_WIN8 = "RNG15_RFL8_WIN8"
    RNG19_RFL8_SIG16_NIR16_RGB16 = "RNG19_RFL8_SIG16_NIR16_RGB16"
    RNG19_RFL8_SIG16_NIR16_RGB16_DUAL = "RNG19_RFL8_SIG16_NIR16_RGB16_DUAL"
    OFF = "OFF"

    @classmethod
    def from_string(cls, s: str) -> "UDPProfileLidar":
        try:
            return cls(s)
        except ValueError:
            return cls.UNKNOWN


class UDPProfileIMU(Enum):
    LEGACY = "LEGACY"
    ACCEL32_GYRO32_NMEA = "ACCEL32_GYRO32_NMEA"
    OFF = "OFF"

    @classmethod
    def from_string(cls, s: str) -> "UDPProfileIMU":
        try:
            return cls(s)
        except ValueError:
            return cls.LEGACY


class HeaderType(Enum):
    """Lidar packet header flavor (ref: types.h:433)."""

    STANDARD = "STANDARD"
    FUSA = "FUSA"


class TimestampMode(Enum):
    UNSPECIFIED = "UNKNOWN"
    TIME_FROM_INTERNAL_OSC = "TIME_FROM_INTERNAL_OSC"
    TIME_FROM_SYNC_PULSE_IN = "TIME_FROM_SYNC_PULSE_IN"
    TIME_FROM_PTP_1588 = "TIME_FROM_PTP_1588"


class OperatingMode(Enum):
    UNSPECIFIED = "UNKNOWN"
    NORMAL = "NORMAL"
    STANDBY = "STANDBY"


class MultipurposeIOMode(Enum):
    OFF = "OFF"
    INPUT_NMEA_UART = "INPUT_NMEA_UART"
    OUTPUT_FROM_INTERNAL_OSC = "OUTPUT_FROM_INTERNAL_OSC"
    OUTPUT_FROM_SYNC_PULSE_IN = "OUTPUT_FROM_SYNC_PULSE_IN"
    OUTPUT_FROM_PTP_1588 = "OUTPUT_FROM_PTP_1588"
    OUTPUT_FROM_ENCODER_ANGLE = "OUTPUT_FROM_ENCODER_ANGLE"


class Polarity(Enum):
    ACTIVE_LOW = "ACTIVE_LOW"
    ACTIVE_HIGH = "ACTIVE_HIGH"


class NMEABaudRate(Enum):
    BAUD_9600 = "BAUD_9600"
    BAUD_115200 = "BAUD_115200"


class FullScaleRange(Enum):
    NORMAL = "NORMAL"
    EXTENDED = "EXTENDED"


class ReturnOrder(Enum):
    STRONGEST_TO_WEAKEST = "STRONGEST_TO_WEAKEST"
    FARTHEST_TO_NEAREST = "FARTHEST_TO_NEAREST"
    NEAREST_TO_FARTHEST = "NEAREST_TO_FARTHEST"
    DEPRECATED_STRONGEST_RETURN_FIRST = "STRONGEST_RETURN_FIRST"
    DEPRECATED_LAST_RETURN_FIRST = "LAST_RETURN_FIRST"


class ShotLimitingStatus(Enum):
    NORMAL = 0
    IMMINENT = 1
    REDUCTION_0_10 = 2
    REDUCTION_10_20 = 3
    REDUCTION_20_30 = 4
    REDUCTION_30_40 = 5
    REDUCTION_40_50 = 6
    REDUCTION_50_60 = 7
    REDUCTION_60_70 = 8
    REDUCTION_70_75 = 9


class ThermalShutdownStatus(Enum):
    NORMAL = 0
    IMMINENT = 1


class BloomReductionOptimization(Enum):
    BALANCED = "BALANCED"
    MINIMIZE_FALSE_POSITIVES = "MINIMIZE_FALSE_POSITIVES"


@dataclass(frozen=True)
class LidarMode:
    """Horizontal resolution x frame rate (ref: types.h:87-97).

    Serialized as e.g. "1024x10".
    """

    columns: int
    fps: int

    @classmethod
    def from_string(cls, s: str) -> "LidarMode":
        try:
            cols, fps = s.split("x")
            cols_i, fps_i = int(cols), int(fps)
        except ValueError:
            raise ValueError(f'Invalid lidar mode string "{s}".')
        if cols_i < 0 or fps_i < 0:
            raise ValueError(f'Invalid lidar mode string "{s}".')
        return cls(cols_i, fps_i)

    def __str__(self) -> str:
        return f"{self.columns}x{self.fps}"


MODE_512x10 = LidarMode(512, 10)
MODE_512x20 = LidarMode(512, 20)
MODE_1024x10 = LidarMode(1024, 10)
MODE_1024x20 = LidarMode(1024, 20)
MODE_2048x10 = LidarMode(2048, 10)
MODE_4096x5 = LidarMode(4096, 5)


@dataclass(frozen=True, order=True)
class Version:
    """Semantic firmware version (ref: types.h:1580)."""

    major: int = 0
    minor: int = 0
    patch: int = 0
    stage: str = ""
    machine: str = ""
    prerelease: str = ""
    build: str = ""

    @classmethod
    def from_string(cls, s: str) -> "Version":
        """Parse version strings like 'v2.3.0',
        'ousteros-image-prod-aries-v2.0.0-rc.2+123', '1.14.0-beta.1'.

        The regex is the reference's own
        (ref: types.cpp:751-774 version_from_string): an optional
        '<stage>-<machine>-' pair directly before the semver carries the
        build stage and machine; empty major/minor/patch parse invalid
        (all zeros)."""
        import re

        m = re.search(
            r"(([\w\d]*)-([\w\d]*)-)?v?(\d*)\.(\d*)\.(\d*)"
            r"-?([\d\w.]*)?\+?([\d\w.]*)?",
            s.strip(),
        )
        if not m or not (m.group(4) and m.group(5) and m.group(6)):
            return cls()
        return cls(
            major=int(m.group(4)),
            minor=int(m.group(5)),
            patch=int(m.group(6)),
            stage=m.group(2) or "",
            machine=m.group(3) or "",
            prerelease=m.group(7) or "",
            build=m.group(8) or "",
        )

    def __bool__(self) -> bool:
        return (self.major, self.minor, self.patch) != (0, 0, 0)


def _identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


@dataclass
class DataFormat:
    """Frame geometry and packet layout knobs (ref: types.h:830-857)."""

    pixels_per_column: int = 0
    columns_per_packet: int = 0
    columns_per_frame: int = 0
    pixel_shift_by_row: List[int] = dc_field(default_factory=list)
    column_window: Tuple[int, int] = (0, 0)
    udp_profile_lidar: UDPProfileLidar = UDPProfileLidar.LEGACY
    udp_profile_imu: UDPProfileIMU = UDPProfileIMU.LEGACY
    header_type: HeaderType = HeaderType.STANDARD
    fps: int = 0
    imu_measurements_per_packet: int = 0
    imu_packets_per_frame: int = 0
    zone_monitoring_enabled: bool = False

    def valid_columns_per_frame(self) -> int:
        """Number of columns in the configured azimuth window
        (ref: types.cpp DataFormat::valid_columns_per_frame)."""
        start, end = self.column_window
        if start <= end:
            return end - start + 1
        return self.columns_per_frame - start + end + 1

    def lidar_packets_per_frame(self) -> int:
        """Packets needed to cover the column window; 0 when the lidar
        stream is disabled (ref: types.cpp:725-727)."""
        if self.udp_profile_lidar == UDPProfileLidar.OFF:
            return 0
        if self.columns_per_packet == 0:
            return 0
        start, end = self.column_window
        if start <= end:
            first = start // self.columns_per_packet
            last = end // self.columns_per_packet
            return last - first + 1
        # wrapped window: packets from start..end going through 0
        n_pkts = self.columns_per_frame // self.columns_per_packet
        first = (end // self.columns_per_packet) + 1
        last = start // self.columns_per_packet
        return n_pkts - (last - first)


@dataclass
class SensorConfig:
    """Sensor configuration knobs, all optional (ref: types.h:613-821)."""

    udp_dest: Optional[str] = None
    udp_dest_zm: Optional[str] = None
    udp_port_lidar: Optional[int] = None
    udp_port_imu: Optional[int] = None
    udp_port_zm: Optional[int] = None
    udp_multicast_ttl: Optional[int] = None
    udp_multicast_ttl_zm: Optional[int] = None
    timestamp_mode: Optional[TimestampMode] = None
    lidar_mode: Optional[LidarMode] = None
    operating_mode: Optional[OperatingMode] = None
    multipurpose_io_mode: Optional[MultipurposeIOMode] = None
    azimuth_window: Optional[Tuple[int, int]] = None
    lidar_frame_azimuth_offset: Optional[float] = None
    signal_multiplier: Optional[float] = None
    nmea_in_polarity: Optional[Polarity] = None
    nmea_ignore_valid_char: Optional[bool] = None
    nmea_baud_rate: Optional[NMEABaudRate] = None
    nmea_leap_seconds: Optional[int] = None
    sync_pulse_in_polarity: Optional[Polarity] = None
    sync_pulse_out_polarity: Optional[Polarity] = None
    sync_pulse_out_angle: Optional[int] = None
    sync_pulse_out_pulse_width: Optional[int] = None
    sync_pulse_out_frequency: Optional[int] = None
    phase_lock_enable: Optional[bool] = None
    phase_lock_offset: Optional[int] = None
    columns_per_packet: Optional[int] = None
    udp_profile_lidar: Optional[UDPProfileLidar] = None
    udp_profile_imu: Optional[UDPProfileIMU] = None
    header_type: Optional[HeaderType] = None
    gyro_fsr: Optional[FullScaleRange] = None
    accel_fsr: Optional[FullScaleRange] = None
    return_order: Optional[ReturnOrder] = None
    min_range_threshold_cm: Optional[int] = None
    imu_packets_per_frame: Optional[int] = None
    bloom_reduction_optimization: Optional[BloomReductionOptimization] = None
    extra_options: Dict[str, Any] = dc_field(default_factory=dict)

    def to_json_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, value in vars(self).items():
            if value is None or name == "extra_options":
                continue
            if isinstance(value, Enum):
                out[name] = value.value
            elif isinstance(value, LidarMode):
                out[name] = str(value)
            elif isinstance(value, tuple):
                out[name] = list(value)
            else:
                out[name] = value
        out.update(self.extra_options)
        return out

    def to_json_string(self) -> str:
        return json.dumps(self.to_json_dict(), indent=4)


@dataclass
class CalibrationStatus:
    reflectivity_status: Optional[bool] = None
    reflectivity_timestamp: Optional[str] = None


@dataclass
class ProductInfo:
    """Decomposed product line string (ref: types.h ProductInfo)."""

    full_product_info: str = ""
    form_factor: str = ""
    short_range: bool = False
    beam_config: str = ""
    beam_count: int = 0

    @classmethod
    def from_string(cls, prod_line: str) -> "ProductInfo":
        import re

        m = re.match(
            r"^(\w+)-(\d+|DOME)(?:-(\d+))?(-SR)?(?:-(\w+))?", prod_line)
        if not m:
            return cls(full_product_info=prod_line)
        form_factor = m.group(1) + m.group(2)
        beam_count = int(m.group(3)) if m.group(3) else (
            128 if m.group(2) == "DOME" else 0)
        return cls(
            full_product_info=prod_line,
            form_factor=form_factor,
            short_range=bool(m.group(4)),
            beam_config=m.group(5) or "U",
            beam_count=beam_count,
        )


@dataclass
class SensorInfo:
    """Parsed sensor metadata (ref: types.h:985-1108).

    Field names and semantics mirror the reference so metadata.json files
    round-trip. Construction from a metadata string happens in
    core/metadata.py.
    """

    sn: int = 0
    fw_rev: str = ""
    prod_line: str = ""
    format: DataFormat = dc_field(default_factory=DataFormat)
    beam_azimuth_angles: List[float] = dc_field(default_factory=list)
    beam_altitude_angles: List[float] = dc_field(default_factory=list)
    lidar_origin_to_beam_origin_mm: float = 0.0
    beam_to_lidar_transform: np.ndarray = dc_field(default_factory=_identity4)
    imu_to_sensor_transform: np.ndarray = dc_field(default_factory=_identity4)
    lidar_to_sensor_transform: np.ndarray = dc_field(default_factory=_identity4)
    extrinsic: np.ndarray = dc_field(default_factory=_identity4)
    init_id: int = 0
    build_date: str = ""
    image_rev: str = ""
    prod_pn: str = ""
    status: str = ""
    cal: CalibrationStatus = dc_field(default_factory=CalibrationStatus)
    config: SensorConfig = dc_field(default_factory=SensorConfig)
    user_data: str = ""
    # zone monitoring configuration hash (if present)
    zone_set_hash: str = ""
    # parsed zone configuration when available
    # (ref: client.pyi SensorInfo.zone_set: Optional[ZoneSet])
    zone_set: Optional[object] = None

    def __post_init__(self) -> None:
        # SensorInfo(metadata_json_str) parses like the reference ctor
        # (ref: client.pyi SensorInfo.__init__(metadata: str);
        # sensor_info.cpp SensorInfo(const std::string&))
        if isinstance(self.sn, (str, bytes)):
            from .metadata import sensor_info_from_metadata

            parsed = sensor_info_from_metadata(
                self.sn.decode() if isinstance(self.sn, bytes)
                else self.sn)
            self.__dict__.update(parsed.__dict__)

    def get_version(self) -> Version:
        return Version.from_string(self.image_rev or self.fw_rev)

    def get_product_info(self) -> ProductInfo:
        return ProductInfo.from_string(self.prod_line)

    @property
    def w(self) -> int:
        return self.format.columns_per_frame

    @property
    def h(self) -> int:
        return self.format.pixels_per_column

    def has_fields_equal(self, other: "SensorInfo") -> bool:
        return (
            self.sn == other.sn
            and self.fw_rev == other.fw_rev
            and self.prod_line == other.prod_line
            and self.format == other.format
            and self.beam_azimuth_angles == other.beam_azimuth_angles
            and self.beam_altitude_angles == other.beam_altitude_angles
            and np.array_equal(self.beam_to_lidar_transform,
                               other.beam_to_lidar_transform)
            and np.array_equal(self.imu_to_sensor_transform,
                               other.imu_to_sensor_transform)
            and np.array_equal(self.lidar_to_sensor_transform,
                               other.lidar_to_sensor_transform)
            and np.array_equal(self.extrinsic, other.extrinsic)
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, SensorInfo):
            return NotImplemented
        return self.has_fields_equal(other) and self.init_id == other.init_id

    def to_json_string(self) -> str:
        """Serialize to the non-legacy metadata.json layout
        (ref: types.h:1055, metadata.cpp)."""
        d: Dict[str, Any] = {
            "sensor_info": {
                "build_date": self.build_date,
                "build_rev": self.fw_rev,
                "image_rev": self.image_rev,
                "initialization_id": self.init_id,
                "prod_line": self.prod_line,
                "prod_pn": self.prod_pn,
                "prod_sn": str(self.sn),
                "status": self.status,
            },
            "config_params": self.config.to_json_dict(),
            "lidar_data_format": {
                "pixels_per_column": self.format.pixels_per_column,
                "columns_per_packet": self.format.columns_per_packet,
                "columns_per_frame": self.format.columns_per_frame,
                "pixel_shift_by_row": list(self.format.pixel_shift_by_row),
                "column_window": list(self.format.column_window),
                "udp_profile_lidar": self.format.udp_profile_lidar.value,
                "udp_profile_imu": self.format.udp_profile_imu.value,
                "fps": self.format.fps,
            },
            "beam_intrinsics": {
                "beam_altitude_angles": list(self.beam_altitude_angles),
                "beam_azimuth_angles": list(self.beam_azimuth_angles),
                "lidar_origin_to_beam_origin_mm":
                    self.lidar_origin_to_beam_origin_mm,
                "beam_to_lidar_transform":
                    self.beam_to_lidar_transform.flatten().tolist(),
            },
            "lidar_intrinsics": {
                "lidar_to_sensor_transform":
                    self.lidar_to_sensor_transform.flatten().tolist(),
            },
            "imu_intrinsics": {
                "imu_to_sensor_transform":
                    self.imu_to_sensor_transform.flatten().tolist(),
            },
            "calibration_status": {},
        }
        if self.format.imu_measurements_per_packet:
            d["lidar_data_format"]["imu_measurements_per_packet"] = (
                self.format.imu_measurements_per_packet)
        if self.format.imu_packets_per_frame:
            d["lidar_data_format"]["imu_packets_per_frame"] = (
                self.format.imu_packets_per_frame)
        if self.format.header_type != HeaderType.STANDARD:
            d["lidar_data_format"]["header_type"] = self.format.header_type.value
        if self.cal.reflectivity_status is not None:
            d["calibration_status"]["reflectivity"] = {
                "valid": self.cal.reflectivity_status,
                "timestamp": self.cal.reflectivity_timestamp,
            }
        if self.user_data:
            d["user_data"] = self.user_data
        if self.zone_set is not None:
            # embed the zone set as base64 of the STL+ZRB zip
            # (ref: sensor_info.cpp:388-392)
            import base64

            from ..zone.zone import ZoneSetOutputFilter

            d["zone_set"] = base64.b64encode(
                self.zone_set.to_zip_blob(
                    ZoneSetOutputFilter.STL_AND_ZRB)).decode()
        # always emitted by the client-side serialization, never by the
        # sensor's own metadata endpoint
        # (ref: sensor_info.cpp:407-413 to_json_string)
        d["ouster-sdk"] = {
            "extrinsic": np.asarray(
                self.extrinsic).flatten().tolist(),
            "output_source": "sensor_info_to_string",
            "client_version": client_version(),
        }
        return json.dumps(d, indent=4)

    @classmethod
    def from_default(cls, mode: LidarMode) -> "SensorInfo":
        """A synthetic 64-beam OS-1 style SensorInfo for tests
        (ref: sensor_info.cpp default_sensor_info)."""
        from .metadata import default_sensor_info

        return default_sensor_info(mode)


#: The SDK name and version a sensor's metadata json records as its
#: writer: the JAX package's, whose files this package's OSF writer
#: reproduces byte for byte.
SDK_NAME, SDK_VERSION = "ouster_sdk_tpu", "0.5.0"


def client_version() -> str:
    return f"{SDK_NAME} {SDK_VERSION}"


#: Sentinel for an unknown firmware version (ref: version.h:79).
INVALID_VERSION = Version(0, 0, 0)
