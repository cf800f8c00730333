"""Sensor metadata model: the subset of the SDK types the port needs.

Profiles, header flavours and lidar modes (ref: ouster_client/include/
ouster/types.h:87-97, 304, 433), the frame geometry `DataFormat`
(types.h:830-857), the frame-status enums, the firmware `Version` and the
`SensorInfo` fields that decode, projection and scan batching read: format,
beam angles and transforms, extrinsic, ids, firmware revision, lidar mode
and the destination ports of the lidar, IMU and zone streams
(types.h:985-1108). Matrices are float64 numpy arrays; the device carries
hi/lo float32 splits derived from them (see ops/xyzlut.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np


class UDPProfileLidar(Enum):
    """Lidar packet profiles (ref: types.h:304 and the types.cpp table)."""

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


class HeaderType(Enum):
    """Lidar packet header flavour (ref: types.h:433)."""

    STANDARD = "STANDARD"
    FUSA = "FUSA"


@dataclass(frozen=True)
class LidarMode:
    """Horizontal resolution x frame rate, serialized as e.g. "2048x10"
    (ref: types.h:87-97)."""

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
        'ousteros-image-prod-aries-v2.0.0-rc.2+123', '1.14.0-beta.1'
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
    """The configuration knobs the port reads (ref: types.h:613-821)."""

    udp_dest: Optional[str] = None
    udp_dest_zm: Optional[str] = None
    udp_port_lidar: Optional[int] = None
    udp_port_imu: Optional[int] = None
    udp_port_zm: Optional[int] = None
    lidar_mode: Optional[LidarMode] = None


@dataclass
class SensorInfo:
    """Parsed sensor metadata (ref: types.h:985-1108); built from a
    metadata string by core/metadata.py."""

    sn: int = 0
    fw_rev: str = ""
    image_rev: str = ""
    prod_line: str = ""
    format: DataFormat = dc_field(default_factory=DataFormat)
    beam_azimuth_angles: List[float] = dc_field(default_factory=list)
    beam_altitude_angles: List[float] = dc_field(default_factory=list)
    lidar_origin_to_beam_origin_mm: float = 0.0
    beam_to_lidar_transform: np.ndarray = dc_field(default_factory=_identity4)
    lidar_to_sensor_transform: np.ndarray = dc_field(
        default_factory=_identity4)
    extrinsic: np.ndarray = dc_field(default_factory=_identity4)
    init_id: int = 0
    config: SensorConfig = dc_field(default_factory=SensorConfig)

    def get_version(self) -> Version:
        return Version.from_string(self.image_rev or self.fw_rev)

    @property
    def w(self) -> int:
        return self.format.columns_per_frame

    @property
    def h(self) -> int:
        return self.format.pixels_per_column
