"""Metadata parsing and validation.

The reference's non-throwing metadata validator
(ref: ouster_client/src/metadata.cpp, ouster_client/include/ouster/metadata.h:33).
Handles both the modern sectioned layout ($.sensor_info / $.config_params /
$.lidar_data_format / $.beam_intrinsics / ...) and the legacy flat layout
(fw 1.12 - 2.1) by converting legacy to the modern shape first
(ref: metadata.cpp:914-983 convert_legacy_to_nonlegacy).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .types import (
    BloomReductionOptimization,
    CalibrationStatus,
    DataFormat,
    FullScaleRange,
    HeaderType,
    LidarMode,
    MultipurposeIOMode,
    NMEABaudRate,
    OperatingMode,
    Polarity,
    ReturnOrder,
    SensorConfig,
    SensorInfo,
    TimestampMode,
    UDPProfileIMU,
    UDPProfileLidar,
)

DEFAULT_COLUMNS_PER_PACKET = 16  # ref: defaults.h:5

# ref: sensor_info.cpp:242-248
DEFAULT_IMU_TO_SENSOR_TRANSFORM = np.array(
    [[1, 0, 0, 6.253], [0, 1, 0, -11.775], [0, 0, 1, 7.645], [0, 0, 0, 1]],
    dtype=np.float64,
)
DEFAULT_LIDAR_TO_SENSOR_TRANSFORM = np.array(
    [[-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 1, 36.18], [0, 0, 0, 1]],
    dtype=np.float64,
)

# ref: sensor_info.cpp:209-238 (GEN1 beam tables)
GEN1_ALTITUDE_ANGLES = [
    16.611, 16.084, 15.557, 15.029, 14.502, 13.975, 13.447, 12.920,
    12.393, 11.865, 11.338, 10.811, 10.283, 9.756, 9.229, 8.701,
    8.174, 7.646, 7.119, 6.592, 6.064, 5.537, 5.010, 4.482,
    3.955, 3.428, 2.900, 2.373, 1.846, 1.318, 0.791, 0.264,
    -0.264, -0.791, -1.318, -1.846, -2.373, -2.900, -3.428, -3.955,
    -4.482, -5.010, -5.537, -6.064, -6.592, -7.119, -7.646, -8.174,
    -8.701, -9.229, -9.756, -10.283, -10.811, -11.338, -11.865, -12.393,
    -12.920, -13.447, -13.975, -14.502, -15.029, -15.557, -16.084, -16.611,
]
GEN1_AZIMUTH_ANGLES = [3.164, 1.055, -1.055, -3.164] * 16


@dataclass
class ValidatorEntry:
    """One issue found while parsing metadata (ref: metadata.h ValidatorIssues)."""

    path: str
    msg: str

    def to_string(self) -> str:
        return f"{self.path}: {self.msg}"

    def __repr__(self) -> str:
        return f"ValidatorEntry({self.to_string()!r})"


@dataclass
class ValidatorIssues:
    """Issue lists by severity (ref: metadata.h:33)."""

    critical: List[ValidatorEntry] = dc_field(default_factory=list)
    warning: List[ValidatorEntry] = dc_field(default_factory=list)
    information: List[ValidatorEntry] = dc_field(default_factory=list)

    def ok(self) -> bool:
        return not self.critical


def default_lidar_origin_to_beam_origin(prod_line: str) -> float:
    """ref: sensor_info.cpp:56-66"""
    if prod_line.startswith("OS-0-"):
        return 27.67
    if prod_line.startswith("OS-1-"):
        return 15.806
    if prod_line.startswith("OS-2-"):
        return 13.762
    return 12.163  # gen 1 default


def default_beam_to_lidar_transform(prod_line: str) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[0, 3] = default_lidar_origin_to_beam_origin(prod_line)
    return m


def default_data_format(mode: LidarMode) -> DataFormat:
    """ref: sensor_info.cpp:108-155"""
    w = mode.columns
    offsets = {
        512: [9, 6, 3, 0] * 16,
        1024: [18, 12, 6, 0] * 16,
        2048: [36, 24, 12, 0] * 16,
        4096: [72, 48, 24, 0] * 16,
    }
    if w not in offsets:
        raise ValueError("default_data_format")
    return DataFormat(
        pixels_per_column=64,
        columns_per_packet=DEFAULT_COLUMNS_PER_PACKET,
        columns_per_frame=w,
        pixel_shift_by_row=offsets[w],
        column_window=(0, w - 1),
        udp_profile_lidar=UDPProfileLidar.LEGACY,
        udp_profile_imu=UDPProfileIMU.LEGACY,
        header_type=HeaderType.STANDARD,
        fps=mode.fps,
    )


def default_sensor_info(mode: LidarMode) -> SensorInfo:
    """ref: sensor_info.cpp:185-207"""
    info = SensorInfo()
    info.sn = 0
    info.fw_rev = "UNKNOWN"
    info.prod_line = "OS-1-64"
    info.format = default_data_format(mode)
    info.beam_azimuth_angles = list(GEN1_AZIMUTH_ANGLES)
    info.beam_altitude_angles = list(GEN1_ALTITUDE_ANGLES)
    info.lidar_origin_to_beam_origin_mm = default_lidar_origin_to_beam_origin(
        info.prod_line)
    info.beam_to_lidar_transform = default_beam_to_lidar_transform(
        info.prod_line)
    info.imu_to_sensor_transform = DEFAULT_IMU_TO_SENSOR_TRANSFORM.copy()
    info.lidar_to_sensor_transform = DEFAULT_LIDAR_TO_SENSOR_TRANSFORM.copy()
    info.extrinsic = np.eye(4, dtype=np.float64)
    info.config = SensorConfig()
    info.config.lidar_mode = mode
    info.config.udp_port_lidar = 0
    info.config.udp_port_imu = 0
    return info


# Sections of the modern layout; value = required (ref: metadata.cpp:889-894)
NONLEGACY_METADATA_FIELDS = {
    "sensor_info": True,
    "beam_intrinsics": True,
    "imu_intrinsics": True,
    "lidar_intrinsics": True,
    "config_params": True,
    "lidar_data_format": False,
    "calibration_status": False,
}

_LEGACY_CONFIG_FIELDS = ["udp_port_imu", "udp_port_lidar", "lidar_mode",
                         "udp_ip"]
_LEGACY_BEAM_FIELDS = [
    "lidar_origin_to_beam_origin_mm",
    "beam_altitude_angles",
    "beam_azimuth_angles",
    "beam_to_lidar_transform",
]
_LEGACY_SENSOR_INFO_FIELDS = [
    "prod_line", "status", "prod_pn", "prod_sn",
    "initialization_id", "build_rev", "build_date", "image_rev",
]


def convert_legacy_to_nonlegacy(root: Dict[str, Any]) -> Dict[str, Any]:
    """ref: metadata.cpp:914-983"""
    result: Dict[str, Any] = {}
    skip: List[str] = []

    if "lidar_to_sensor_transform" in root:
        result.setdefault("lidar_intrinsics", {})["lidar_to_sensor_transform"] = \
            root["lidar_to_sensor_transform"]
        skip.append("lidar_to_sensor_transform")
    if "imu_to_sensor_transform" in root:
        result.setdefault("imu_intrinsics", {})["imu_to_sensor_transform"] = \
            root["imu_to_sensor_transform"]
        skip.append("imu_to_sensor_transform")
    if "data_format" in root:
        result["lidar_data_format"] = root["data_format"]
        skip.append("data_format")
    if "client_version" in root:
        result.setdefault("ouster-sdk", {})["client_version"] = \
            root["client_version"]
        skip.append("client_version")

    for f in _LEGACY_CONFIG_FIELDS:
        if f in root:
            result.setdefault("config_params", {})[f] = root[f]
            skip.append(f)
    for f in _LEGACY_BEAM_FIELDS:
        if f in root:
            result.setdefault("beam_intrinsics", {})[f] = root[f]
            skip.append(f)
    for f in _LEGACY_SENSOR_INFO_FIELDS:
        if f in root:
            result.setdefault("sensor_info", {})[f] = root[f]
            skip.append(f)
    for k, v in root.items():
        if k not in skip:
            result[k] = v
    return result


def _decode_transform(data: List[float]) -> np.ndarray:
    return np.array(data, dtype=np.float64).reshape(4, 4)


class _Parser:
    """Stateful walker over the modern metadata layout, accumulating issues."""

    def __init__(self, root: Dict[str, Any], issues: ValidatorIssues,
                 strict_sections: bool = True):
        self.root = root
        self.issues = issues
        self.strict_sections = strict_sections

    def missing_section(self, path: str) -> None:
        """A required section is absent. In a partial modern layout this is
        critical (ref: metadata.cpp:1007-1012); in converted-legacy layouts
        the reference fills defaults with warnings."""
        if self.strict_sections:
            self.critical(path, "Required section missing")
        else:
            self.warn(path, "Section missing, using defaults")

    def get(self, *path: str) -> Any:
        node: Any = self.root
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return None
            node = node[p]
        return node

    def info(self, path: str, msg: str) -> None:
        self.issues.information.append(ValidatorEntry(path, msg))

    def warn(self, path: str, msg: str) -> None:
        self.issues.warning.append(ValidatorEntry(path, msg))

    def critical(self, path: str, msg: str) -> None:
        self.issues.critical.append(ValidatorEntry(path, msg))

    # -- typed item parsing with issue reporting --------------------------
    def item(self, path: Tuple[str, ...], ty: type, default: Any = None,
             severity: str = "information") -> Any:
        val = self.get(*path)
        jpath = "$." + ".".join(path)
        if val is None:
            getattr(self.issues, severity).append(
                ValidatorEntry(jpath, "Item not found, using default"))
            return default
        if ty is float:
            # sensor jsons sometimes carry numbers as strings
            try:
                return float(val)
            except (TypeError, ValueError):
                self.warn(jpath, f"Expected number, got {val!r}")
                return default
        if ty is int:
            # sensor jsons sometimes carry ints as strings (e.g. prod_sn)
            try:
                return int(val)
            except (TypeError, ValueError):
                self.warn(jpath, f"Expected integer, got {val!r}")
                return default
        if ty is bool:
            if isinstance(val, bool):
                return val
            self.warn(jpath, f"Expected bool, got {val!r}")
            return default
        if ty is str:
            if isinstance(val, str):
                return val
            self.warn(jpath, f"Expected string, got {val!r}")
            return default
        return val

    def enum(self, path: Tuple[str, ...], enum_cls: type, default: Any = None,
             severity: str = "information") -> Any:
        val = self.get(*path)
        jpath = "$." + ".".join(path)
        if val is None:
            getattr(self.issues, severity).append(
                ValidatorEntry(jpath, "Item not found, using default"))
            return default
        try:
            return enum_cls(val)
        except ValueError:
            self.warn(jpath, f"Invalid value {val!r} for {enum_cls.__name__}")
            return default

    def transform(self, path: Tuple[str, ...],
                  default: Optional[np.ndarray]) -> Optional[np.ndarray]:
        val = self.get(*path)
        jpath = "$." + ".".join(path)
        if val is None:
            self.info(jpath, "Item not found, using default")
            return None if default is None else default.copy()
        try:
            arr = np.asarray(val, dtype=np.float64)
        except (TypeError, ValueError):
            arr = np.zeros(0)
        if arr.size != 16:
            self.critical(jpath, f"Expected 16 elements, got {arr.size}")
            return None if default is None else default.copy()
        return arr.reshape(4, 4)


def check_signal_multiplier(value: float) -> None:
    """ref: types.cpp check_signal_multiplier — valid: 0.25, 0.5, 1, 2, 3."""
    valid = [0.25, 0.5, 1.0, 2.0, 3.0]
    if value not in valid:
        raise ValueError(
            f"signal multiplier must be one of {valid} but was {value}")


def _parse_config_params(p: _Parser, config: SensorConfig) -> None:
    """ref: metadata.cpp parse_and_validate_config_params"""
    cp = ("config_params",)
    if p.get("config_params") is None:
        p.missing_section("$.config_params")
        return

    config.udp_dest = p.item(cp + ("udp_dest",), str)
    config.udp_dest_zm = p.item(cp + ("udp_dest_zm",), str)
    config.udp_port_lidar = p.item(cp + ("udp_port_lidar",), int)
    config.udp_port_imu = p.item(cp + ("udp_port_imu",), int)
    config.udp_port_zm = p.item(cp + ("udp_port_zm",), int)
    config.udp_multicast_ttl = p.item(cp + ("udp_multicast_ttl",), int)
    config.udp_multicast_ttl_zm = p.item(cp + ("udp_multicast_ttl_zm",), int)

    ts_mode = p.get("config_params", "timestamp_mode")
    if ts_mode is not None:
        try:
            config.timestamp_mode = TimestampMode(ts_mode)
        except ValueError:
            p.warn("$.config_params.timestamp_mode",
                   f"Invalid value {ts_mode!r}")

    lidar_mode = p.get("config_params", "lidar_mode")
    if lidar_mode is not None:
        try:
            config.lidar_mode = LidarMode.from_string(str(lidar_mode))
        except ValueError as e:
            p.critical("$.config_params.lidar_mode", str(e))
    else:
        p.info("$.config_params.lidar_mode", "Item not found")

    config.operating_mode = p.enum(cp + ("operating_mode",), OperatingMode)
    if config.operating_mode is None and \
            p.get("config_params", "auto_start_flag") is not None:
        # fw 1.x spelled operating_mode as auto_start_flag
        config.operating_mode = (
            OperatingMode.NORMAL
            if p.get("config_params", "auto_start_flag") else
            OperatingMode.STANDBY)
    config.multipurpose_io_mode = p.enum(
        cp + ("multipurpose_io_mode",), MultipurposeIOMode)

    if config.udp_dest is None:
        # legacy firmware names the UDP destination udp_ip
        # (ref: metadata.cpp legacy config mapping)
        legacy_dest = p.get("config_params", "udp_ip")
        if isinstance(legacy_dest, str) and legacy_dest:
            config.udp_dest = legacy_dest

    az_win = p.get("config_params", "azimuth_window")
    if az_win is not None and isinstance(az_win, list) and len(az_win) == 2:
        try:
            config.azimuth_window = (int(az_win[0]), int(az_win[1]))
        except (TypeError, ValueError):
            p.warn("$.config_params.azimuth_window",
                   f"Expected [int, int], got {az_win!r}")

    config.lidar_frame_azimuth_offset = p.item(
        cp + ("lidar_frame_azimuth_offset",), float)

    sig = p.get("config_params", "signal_multiplier")
    if sig is not None:
        try:
            sigf = float(sig)
            check_signal_multiplier(sigf)
            config.signal_multiplier = sigf
        except (ValueError, TypeError) as e:
            p.critical("$.config_params.signal_multiplier", str(e))

    config.nmea_in_polarity = p.enum(cp + ("nmea_in_polarity",), Polarity)
    nmea_ignore = p.get("config_params", "nmea_ignore_valid_char")
    if nmea_ignore is not None:
        config.nmea_ignore_valid_char = bool(nmea_ignore)
    config.nmea_baud_rate = p.enum(cp + ("nmea_baud_rate",), NMEABaudRate)
    config.nmea_leap_seconds = p.item(cp + ("nmea_leap_seconds",), int)
    config.sync_pulse_in_polarity = p.enum(
        cp + ("sync_pulse_in_polarity",), Polarity)
    config.sync_pulse_out_polarity = p.enum(
        cp + ("sync_pulse_out_polarity",), Polarity)
    config.sync_pulse_out_angle = p.item(cp + ("sync_pulse_out_angle",), int)
    config.sync_pulse_out_pulse_width = p.item(
        cp + ("sync_pulse_out_pulse_width",), int)
    config.sync_pulse_out_frequency = p.item(
        cp + ("sync_pulse_out_frequency",), int)
    phase_lock = p.get("config_params", "phase_lock_enable")
    if phase_lock is not None:
        config.phase_lock_enable = bool(phase_lock)
    config.phase_lock_offset = p.item(cp + ("phase_lock_offset",), int)
    config.columns_per_packet = p.item(cp + ("columns_per_packet",), int)
    config.udp_profile_lidar = p.enum(
        cp + ("udp_profile_lidar",), UDPProfileLidar)
    config.udp_profile_imu = p.enum(cp + ("udp_profile_imu",), UDPProfileIMU)
    config.header_type = p.enum(cp + ("header_type",), HeaderType)
    config.gyro_fsr = p.enum(cp + ("gyro_fsr",), FullScaleRange)
    config.accel_fsr = p.enum(cp + ("accel_fsr",), FullScaleRange)
    config.return_order = p.enum(cp + ("return_order",), ReturnOrder)
    config.min_range_threshold_cm = p.item(
        cp + ("min_range_threshold_cm",), int)
    config.imu_packets_per_frame = p.item(
        cp + ("imu_packets_per_frame",), int)
    config.bloom_reduction_optimization = p.enum(
        cp + ("bloom_reduction_optimization",), BloomReductionOptimization)


_KNOWN_CONFIG_KEYS = {
    "udp_dest", "udp_dest_zm", "udp_port_lidar", "udp_port_imu", "udp_port_zm",
    "udp_multicast_ttl", "udp_multicast_ttl_zm", "timestamp_mode",
    "lidar_mode", "operating_mode", "auto_start_flag", "multipurpose_io_mode",
    "azimuth_window", "lidar_frame_azimuth_offset", "signal_multiplier",
    "nmea_in_polarity", "nmea_ignore_valid_char", "nmea_baud_rate",
    "nmea_leap_seconds", "sync_pulse_in_polarity", "sync_pulse_out_polarity",
    "sync_pulse_out_angle", "sync_pulse_out_pulse_width",
    "sync_pulse_out_frequency", "phase_lock_enable", "phase_lock_offset",
    "columns_per_packet", "udp_profile_lidar", "udp_profile_imu",
    "header_type", "gyro_fsr", "accel_fsr", "return_order",
    "min_range_threshold_cm", "imu_packets_per_frame",
    "bloom_reduction_optimization", "udp_ip",
}


def _parse_data_format(p: _Parser, info: SensorInfo) -> None:
    """ref: metadata.cpp:539-660 parse_and_validate_data_format"""
    have_ldf = p.get("lidar_data_format") is not None

    if not have_ldf:
        if info.config.lidar_mode is None:
            p.critical(
                "$.lidar_data_format",
                "Missing and cannot derive default without lidar_mode")
            return
        info.format = default_data_format(info.config.lidar_mode)
        p.info("$.lidar_data_format", "Item not found, using default")
        return

    ldf = ("lidar_data_format",)
    fmt = info.format

    ppc = p.item(ldf + ("pixels_per_column",), int, severity="warning")
    if ppc is None:
        # fall back to beam count
        ppc = len(info.beam_altitude_angles) or 64
    fmt.pixels_per_column = ppc

    cpf = p.item(ldf + ("columns_per_frame",), int)
    if cpf is None:
        cpf = info.config.lidar_mode.columns if info.config.lidar_mode else 1024
    fmt.columns_per_frame = cpf

    cw = p.get("lidar_data_format", "column_window")
    if cw is not None and isinstance(cw, list) and len(cw) == 2:
        fmt.column_window = (int(cw[0]), int(cw[1]))
        if not (0 <= fmt.column_window[0] < cpf
                and 0 <= fmt.column_window[1] < cpf):
            p.warn("$.lidar_data_format.column_window.*",
                   "column window out of bounds")
    else:
        fmt.column_window = (0, cpf - 1)
        p.info("$.lidar_data_format.column_window.*",
               "Item not found, using default")

    cpp = p.item(ldf + ("columns_per_packet",), int)
    fmt.columns_per_packet = cpp if cpp is not None \
        else DEFAULT_COLUMNS_PER_PACKET

    shifts = p.get("lidar_data_format", "pixel_shift_by_row")
    if shifts is not None:
        try:
            fmt.pixel_shift_by_row = [int(s) for s in shifts]
        except (TypeError, ValueError):
            p.warn("$.lidar_data_format.pixel_shift_by_row.*",
                   f"Expected integers, got {shifts!r}")
            fmt.pixel_shift_by_row = [0] * fmt.pixels_per_column
            shifts = None
    if shifts is not None:
        if len(fmt.pixel_shift_by_row) != fmt.pixels_per_column:
            # ref truncates/extends (metadata.cpp:600-604)
            fmt.pixel_shift_by_row = (
                fmt.pixel_shift_by_row + [0] * fmt.pixels_per_column
            )[: fmt.pixels_per_column]
            p.warn("$.lidar_data_format.pixel_shift_by_row.*",
                   "size mismatch with pixels_per_column")
    else:
        fmt.pixel_shift_by_row = [0] * fmt.pixels_per_column
        p.info("$.lidar_data_format.pixel_shift_by_row.*",
               "Item not found, using default")

    prof = p.enum(ldf + ("udp_profile_lidar",), UDPProfileLidar)
    fmt.udp_profile_lidar = prof if prof is not None else UDPProfileLidar.LEGACY
    prof_imu = p.enum(ldf + ("udp_profile_imu",), UDPProfileIMU)
    fmt.udp_profile_imu = prof_imu if prof_imu is not None \
        else UDPProfileIMU.LEGACY
    ht = p.enum(ldf + ("header_type",), HeaderType)
    if ht is not None:
        fmt.header_type = ht
    elif fmt.udp_profile_lidar == UDPProfileLidar.FUSA_RNG15_RFL8_NIR8_DUAL:
        # header_type was introduced in fw 3.2; the FUSA profile implies the
        # FUSA header when absent (ref: metadata.cpp:614-624)
        fmt.header_type = HeaderType.FUSA
    else:
        fmt.header_type = HeaderType.STANDARD

    fmt.imu_packets_per_frame = p.item(
        ("imu_data_format", "imu_packets_per_frame"), int, 0) or \
        p.item(ldf + ("imu_packets_per_frame",), int, 0) or 0
    fmt.imu_measurements_per_packet = p.item(
        ("imu_data_format", "imu_measurements_per_packet"), int, 0) or \
        p.item(ldf + ("imu_measurements_per_packet",), int, 0) or 0

    fps = p.item(ldf + ("fps",), int)
    if fps is None:
        fps = info.config.lidar_mode.fps if info.config.lidar_mode else 0
    fmt.fps = fps

    if fmt.udp_profile_lidar in (
            UDPProfileLidar.RNG15_RFL8_NIR8_ZONE16,
            UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_ZONE16):
        fmt.zone_monitoring_enabled = True


def _parse_sensor_info_section(p: _Parser, info: SensorInfo) -> None:
    si = ("sensor_info",)
    if p.get("sensor_info") is None:
        p.missing_section("$.sensor_info")
        return
    info.build_date = p.item(si + ("build_date",), str, "") or ""
    info.fw_rev = p.item(si + ("build_rev",), str, "",
                         severity="warning") or ""
    info.image_rev = p.item(si + ("image_rev",), str, "",
                            severity="warning") or ""
    info.init_id = p.item(si + ("initialization_id",), int, 0) or 0
    info.prod_line = p.item(si + ("prod_line",), str, "",
                            severity="warning") or ""
    info.prod_pn = p.item(si + ("prod_pn",), str, "") or ""
    sn = p.item(si + ("prod_sn",), int, 0)
    info.sn = sn if sn is not None else 0
    info.status = p.item(si + ("status",), str, "") or ""


def _parse_beam_intrinsics(p: _Parser, info: SensorInfo) -> None:
    bi = ("beam_intrinsics",)
    if p.get("beam_intrinsics") is None:
        p.missing_section("$.beam_intrinsics")
        return
    alts = p.get("beam_intrinsics", "beam_altitude_angles")
    azis = p.get("beam_intrinsics", "beam_azimuth_angles")
    if alts is None or azis is None:
        p.critical("$.beam_intrinsics.beam_altitude_angles",
                   "Missing beam angles")
    else:
        # angles may be flat lists or (DF sensors) lists of per-column lists
        def flatten(x):
            if x and isinstance(x[0], list):
                return [float(v) for row in x for v in row]
            return [float(v) for v in x]

        try:
            info.beam_altitude_angles = flatten(alts)
            info.beam_azimuth_angles = flatten(azis)
        except (TypeError, ValueError):
            p.critical("$.beam_intrinsics.beam_altitude_angles",
                       "Non-numeric beam angles")

    origin = p.item(bi + ("lidar_origin_to_beam_origin_mm",), float)
    if origin is None:
        origin = default_lidar_origin_to_beam_origin(info.prod_line)
    info.lidar_origin_to_beam_origin_mm = origin

    b2l = p.get("beam_intrinsics", "beam_to_lidar_transform")
    if b2l is not None:
        try:
            arr = np.asarray(b2l, dtype=np.float64)
        except (TypeError, ValueError):
            arr = np.zeros(0)
        if arr.size == 16:
            info.beam_to_lidar_transform = arr.reshape(4, 4)
        else:
            p.critical("$.beam_intrinsics.beam_to_lidar_transform.*",
                       f"Expected 16 elements, got {arr.size}")
    else:
        m = np.eye(4, dtype=np.float64)
        m[0, 3] = info.lidar_origin_to_beam_origin_mm
        info.beam_to_lidar_transform = m
        p.info("$.beam_intrinsics.beam_to_lidar_transform.*",
               "Item not found, using default")


def _parse_intrinsics(p: _Parser, info: SensorInfo) -> None:
    for section, attr, required in (
        ("imu_intrinsics", "imu_to_sensor_transform", True),
        ("lidar_intrinsics", "lidar_to_sensor_transform", True),
    ):
        if p.get(section) is None:
            p.missing_section(f"$.{section}")
            continue
        t = p.transform((section, attr), None)
        if t is not None:
            setattr(info, attr, t)

    ext = p.get("ouster-sdk", "extrinsic")
    if ext is not None:
        try:
            arr = np.asarray(ext, dtype=np.float64)
        except (TypeError, ValueError):
            arr = np.zeros(0)
        if arr.size == 16:
            info.extrinsic = arr.reshape(4, 4)


def _parse_calibration_status(p: _Parser, info: SensorInfo) -> None:
    refl = p.get("calibration_status", "reflectivity")
    if refl is not None and isinstance(refl, dict):
        info.cal.reflectivity_status = refl.get("valid")
        info.cal.reflectivity_timestamp = refl.get("timestamp")


def parse_and_validate_metadata(
    json_data: Union[str, Dict[str, Any]],
) -> Tuple[Optional[SensorInfo], ValidatorIssues]:
    """Parse sensor metadata into a SensorInfo, collecting issues.

    Returns (sensor_info | None, issues); sensor_info is None when critical
    issues were found (ref: metadata.cpp:986-1040).
    """
    issues = ValidatorIssues()
    if isinstance(json_data, str):
        try:
            root = json.loads(json_data)
        except json.JSONDecodeError as e:
            issues.critical.append(ValidatorEntry("$", f"Invalid JSON: {e}"))
            return None, issues
    else:
        root = json_data

    if not isinstance(root, dict):
        issues.critical.append(ValidatorEntry("$", "Metadata must be object"))
        return None, issues

    present = [f for f in NONLEGACY_METADATA_FIELDS if f in root]
    if len(present) != len(NONLEGACY_METADATA_FIELDS):
        # treat as legacy; a *partial* modern layout is also parsed after
        # conversion but flags missing required sections as critical
        # (ref: metadata.cpp:1007-1012)
        converted = convert_legacy_to_nonlegacy(root)
        partial = 0 < len(present) < len(NONLEGACY_METADATA_FIELDS)
        missing = [f for f, req in NONLEGACY_METADATA_FIELDS.items()
                   if f not in root]
        root = converted
    else:
        partial = False
        missing = []

    info = SensorInfo()
    p = _Parser(root, issues, strict_sections=partial)

    _parse_sensor_info_section(p, info)
    _parse_config_params(p, info.config)
    _parse_beam_intrinsics(p, info)
    _parse_data_format(p, info)
    _parse_intrinsics(p, info)
    _parse_calibration_status(p, info)

    # zone monitoring also engages via a configured zm destination
    # (ref: metadata.cpp:650-656)
    if (info.config.udp_dest_zm or "") and \
            (info.config.udp_port_zm or 0) != 0:
        info.format.zone_monitoring_enabled = True

    # lidar stream disabled: port 0 or empty udp_dest means no lidar
    # packets will ever arrive — profile OFF so batching completes from
    # IMU/zone packets alone (ref: metadata.cpp:658-665)
    port = info.config.udp_port_lidar
    dest = info.config.udp_dest
    if (port if port is not None else 7504) == 0 or \
            (dest is not None and dest == ""):
        info.format.udp_profile_lidar = UDPProfileLidar.OFF

    if "user_data" in root and isinstance(root["user_data"], str):
        info.user_data = root["user_data"]

    # embedded zone-monitor configuration: base64 of the zone zip
    # (ref: metadata.cpp:871-875)
    if "zone_set" in root and isinstance(root["zone_set"], str):
        import base64

        from ..zone.zone import ZoneSet

        try:
            info.zone_set = ZoneSet.from_zip(
                base64.b64decode(root["zone_set"]))
        except Exception as exc:
            issues.warning.append(ValidatorEntry(
                "$.zone_set", f"could not parse zone set: {exc}"))

    # stash unknown config params for round-tripping
    cfg = root.get("config_params") or {}
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            if k not in _KNOWN_CONFIG_KEYS:
                info.config.extra_options[k] = v

    if partial:
        for f in missing:
            if NONLEGACY_METADATA_FIELDS.get(f):
                issues.critical.append(ValidatorEntry(
                    "$." + f, "Non-legacy metadata must include field"))

    if issues.critical:
        return None, issues
    return info, issues


def sensor_info_from_metadata(json_data: Union[str, Dict[str, Any]]
                              ) -> SensorInfo:
    """Strict constructor: raises on critical issues
    (ref: SensorInfo(std::string) ctor, sensor_info.cpp)."""
    info, issues = parse_and_validate_metadata(json_data)
    if info is None:
        raise RuntimeError(
            "Errors parsing metadata: "
            + "; ".join(e.to_string() for e in issues.critical))
    return info


def parse_and_validate_config(json_data: Union[str, Dict[str, Any]]
                              ) -> Tuple[SensorConfig, ValidatorIssues]:
    """Parse a bare config_params json into a SensorConfig
    (ref: metadata.cpp:1062-1080 parse_and_validate_config)."""
    issues = ValidatorIssues()
    if isinstance(json_data, str):
        try:
            cfg_root = json.loads(json_data)
        except json.JSONDecodeError as e:
            issues.critical.append(ValidatorEntry("$", f"Invalid JSON: {e}"))
            return SensorConfig(), issues
    else:
        cfg_root = json_data
    config = SensorConfig()
    p = _Parser({"config_params": cfg_root}, issues)
    _parse_config_params(p, config)
    for k, v in (cfg_root or {}).items():
        if k not in _KNOWN_CONFIG_KEYS:
            config.extra_options[k] = v
    return config, issues


def parse_config(json_data: Union[str, Dict[str, Any]]) -> SensorConfig:
    """(ref: metadata.cpp parse_config)"""
    config, _ = parse_and_validate_config(json_data)
    return config


#: Reference export name (ref: core/__init__.py
#: parse_and_validate_sensor_config).
parse_and_validate_sensor_config = parse_and_validate_config
