"""Metadata parsing: the sections the port reads.

Handles the sectioned layout ($.sensor_info / $.config_params /
$.lidar_data_format / $.beam_intrinsics / $.lidar_intrinsics) and the
legacy flat layout (fw 1.12 - 2.1) by converting legacy to the sectioned
shape first (ref: ouster_client/src/metadata.cpp:914-983). Sections the
port does not need (IMU intrinsics, the zone set, calibration status, the
long tail of config params) are ignored.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Union

import numpy as np

from .types import (DataFormat, HeaderType, LidarMode, SensorConfig,
                    SensorInfo, UDPProfileIMU, UDPProfileLidar)

DEFAULT_COLUMNS_PER_PACKET = 16  # ref: defaults.h:5

# ref: sensor_info.cpp:242-248
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


def default_lidar_origin_to_beam_origin(prod_line: str) -> float:
    """ref: sensor_info.cpp:56-66"""
    if prod_line.startswith("OS-0-"):
        return 27.67
    if prod_line.startswith("OS-1-"):
        return 15.806
    if prod_line.startswith("OS-2-"):
        return 13.762
    return 12.163  # gen 1 default


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
        fps=mode.fps,
    )


def default_sensor_info(mode: LidarMode) -> SensorInfo:
    """A synthetic 64-beam OS-1 (ref: sensor_info.cpp:185-207)."""
    info = SensorInfo()
    info.prod_line = "OS-1-64"
    info.format = default_data_format(mode)
    info.beam_azimuth_angles = list(GEN1_AZIMUTH_ANGLES)
    info.beam_altitude_angles = list(GEN1_ALTITUDE_ANGLES)
    info.lidar_origin_to_beam_origin_mm = default_lidar_origin_to_beam_origin(
        info.prod_line)
    info.beam_to_lidar_transform = np.eye(4, dtype=np.float64)
    info.beam_to_lidar_transform[0, 3] = info.lidar_origin_to_beam_origin_mm
    info.lidar_to_sensor_transform = DEFAULT_LIDAR_TO_SENSOR_TRANSFORM.copy()
    info.config = SensorConfig(udp_port_lidar=0, udp_port_imu=0,
                               lidar_mode=mode)
    return info


# Sections of the sectioned layout; value = required (ref: metadata.cpp:889)
NONLEGACY_METADATA_FIELDS = {
    "sensor_info": True,
    "beam_intrinsics": True,
    "imu_intrinsics": True,
    "lidar_intrinsics": True,
    "config_params": True,
    "lidar_data_format": False,
    "calibration_status": False,
}

_LEGACY_SECTIONS = {
    "config_params": ["udp_port_imu", "udp_port_lidar", "lidar_mode",
                      "udp_ip"],
    "beam_intrinsics": ["lidar_origin_to_beam_origin_mm",
                        "beam_altitude_angles", "beam_azimuth_angles",
                        "beam_to_lidar_transform"],
    "sensor_info": ["prod_line", "status", "prod_pn", "prod_sn",
                    "initialization_id", "build_rev", "build_date",
                    "image_rev"],
}


def convert_legacy_to_nonlegacy(root: Dict[str, Any]) -> Dict[str, Any]:
    """ref: metadata.cpp:914-983"""
    result: Dict[str, Any] = {}
    skip: List[str] = []
    moves = (("lidar_to_sensor_transform", "lidar_intrinsics"),
             ("imu_to_sensor_transform", "imu_intrinsics"))
    for key, section in moves:
        if key in root:
            result.setdefault(section, {})[key] = root[key]
            skip.append(key)
    if "data_format" in root:
        result["lidar_data_format"] = root["data_format"]
        skip.append("data_format")
    for section, keys in _LEGACY_SECTIONS.items():
        for k in keys:
            if k in root:
                result.setdefault(section, {})[k] = root[k]
                skip.append(k)
    for k, v in root.items():
        if k not in skip:
            result[k] = v
    return result


def _get(root: Dict[str, Any], *path: str) -> Any:
    node: Any = root
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _int_or(val: Any, default):
    try:
        return int(val)
    except (TypeError, ValueError):
        return default


def _enum_or(enum_cls, val: Any, default):
    try:
        return enum_cls(val)
    except ValueError:
        return default


def _transform(val: Any):
    arr = np.asarray(val, dtype=np.float64)
    if arr.size != 16:
        raise RuntimeError(
            f"Errors parsing metadata: expected 16 elements, got {arr.size}")
    return arr.reshape(4, 4)


def _parse_data_format(root: Dict[str, Any], info: SensorInfo) -> None:
    """ref: metadata.cpp:539-660"""
    ldf = root.get("lidar_data_format")
    mode = info.config.lidar_mode
    if ldf is None:
        if mode is None:
            raise RuntimeError("Errors parsing metadata: $.lidar_data_format: "
                               "Missing and cannot derive default without "
                               "lidar_mode")
        info.format = default_data_format(mode)
        return
    fmt = info.format
    ppc = _int_or(ldf.get("pixels_per_column"), None)
    fmt.pixels_per_column = ppc if ppc is not None else (
        len(info.beam_altitude_angles) or 64)
    cpf = _int_or(ldf.get("columns_per_frame"), None)
    if cpf is None:
        cpf = mode.columns if mode else 1024
    fmt.columns_per_frame = cpf
    cw = ldf.get("column_window")
    fmt.column_window = ((int(cw[0]), int(cw[1]))
                         if isinstance(cw, list) and len(cw) == 2
                         else (0, cpf - 1))
    fmt.columns_per_packet = _int_or(ldf.get("columns_per_packet"),
                                     DEFAULT_COLUMNS_PER_PACKET)
    shifts = ldf.get("pixel_shift_by_row")
    try:
        shifts = None if shifts is None else [int(s) for s in shifts]
    except (TypeError, ValueError):
        shifts = None
    if shifts is None:
        shifts = [0] * fmt.pixels_per_column
    # the reference truncates/extends a mis-sized table (metadata.cpp:600)
    fmt.pixel_shift_by_row = (shifts + [0] * fmt.pixels_per_column)[
        :fmt.pixels_per_column]
    fmt.udp_profile_lidar = _enum_or(
        UDPProfileLidar, ldf.get("udp_profile_lidar", "LEGACY"),
        UDPProfileLidar.LEGACY)
    fmt.udp_profile_imu = _enum_or(
        UDPProfileIMU, ldf.get("udp_profile_imu", "LEGACY"),
        UDPProfileIMU.LEGACY)
    ht = ldf.get("header_type")
    if ht is not None:
        fmt.header_type = _enum_or(HeaderType, ht, HeaderType.STANDARD)
    elif fmt.udp_profile_lidar == UDPProfileLidar.FUSA_RNG15_RFL8_NIR8_DUAL:
        # header_type arrived in fw 3.2; the FUSA profile implies the FUSA
        # header when it is absent (ref: metadata.cpp:614-624)
        fmt.header_type = HeaderType.FUSA
    imu = root.get("imu_data_format") or {}
    fmt.imu_packets_per_frame = (
        _int_or(imu.get("imu_packets_per_frame"), 0)
        or _int_or(ldf.get("imu_packets_per_frame"), 0) or 0)
    fmt.imu_measurements_per_packet = (
        _int_or(imu.get("imu_measurements_per_packet"), 0)
        or _int_or(ldf.get("imu_measurements_per_packet"), 0) or 0)
    fps = _int_or(ldf.get("fps"), None)
    fmt.fps = fps if fps is not None else (mode.fps if mode else 0)
    fmt.zone_monitoring_enabled = fmt.udp_profile_lidar in (
        UDPProfileLidar.RNG15_RFL8_NIR8_ZONE16,
        UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_ZONE16)


def sensor_info_from_metadata(json_data: Union[str, Dict[str, Any]]
                              ) -> SensorInfo:
    """Parse metadata json; raises RuntimeError where the reference's
    validator reports a critical issue (ref: metadata.cpp:986-1040)."""
    root = json.loads(json_data) if isinstance(json_data, str) else json_data
    if not isinstance(root, dict):
        raise RuntimeError("Errors parsing metadata: $: Metadata must be "
                           "object")
    present = [f for f in NONLEGACY_METADATA_FIELDS if f in root]
    if len(present) != len(NONLEGACY_METADATA_FIELDS):
        if present:
            # a partial sectioned layout: missing required sections are
            # critical (ref: metadata.cpp:1007-1012)
            missing = [f for f, req in NONLEGACY_METADATA_FIELDS.items()
                       if req and f not in root]
            if missing:
                raise RuntimeError(
                    "Errors parsing metadata: " + "; ".join(
                        f"$.{f}: Non-legacy metadata must include field"
                        for f in missing))
        root = convert_legacy_to_nonlegacy(root)

    info = SensorInfo()
    si = root.get("sensor_info") or {}
    info.init_id = _int_or(si.get("initialization_id"), 0) or 0
    info.prod_line = si.get("prod_line") or ""
    info.sn = _int_or(si.get("prod_sn"), 0) or 0
    info.fw_rev = si.get("build_rev") or ""
    info.image_rev = si.get("image_rev") or ""

    cp = root.get("config_params") or {}
    info.config.udp_dest = cp.get("udp_dest")
    if info.config.udp_dest is None and isinstance(cp.get("udp_ip"), str) \
            and cp["udp_ip"]:
        info.config.udp_dest = cp["udp_ip"]
    info.config.udp_port_lidar = _int_or(cp.get("udp_port_lidar"), None)
    info.config.udp_port_imu = _int_or(cp.get("udp_port_imu"), None)
    info.config.udp_port_zm = _int_or(cp.get("udp_port_zm"), None)
    info.config.udp_dest_zm = cp.get("udp_dest_zm")
    if cp.get("lidar_mode") is not None:
        info.config.lidar_mode = LidarMode.from_string(str(cp["lidar_mode"]))

    alts = _get(root, "beam_intrinsics", "beam_altitude_angles")
    azis = _get(root, "beam_intrinsics", "beam_azimuth_angles")
    if alts is None or azis is None:
        raise RuntimeError("Errors parsing metadata: "
                           "$.beam_intrinsics.beam_altitude_angles: "
                           "Missing beam angles")

    def flatten(x):
        # DF sensors carry per-column lists of angles
        if x and isinstance(x[0], list):
            return [float(v) for row in x for v in row]
        return [float(v) for v in x]

    info.beam_altitude_angles = flatten(alts)
    info.beam_azimuth_angles = flatten(azis)
    origin = _get(root, "beam_intrinsics", "lidar_origin_to_beam_origin_mm")
    info.lidar_origin_to_beam_origin_mm = (
        float(origin) if origin is not None
        else default_lidar_origin_to_beam_origin(info.prod_line))
    b2l = _get(root, "beam_intrinsics", "beam_to_lidar_transform")
    if b2l is not None:
        info.beam_to_lidar_transform = _transform(b2l)
    else:
        info.beam_to_lidar_transform[0, 3] = \
            info.lidar_origin_to_beam_origin_mm

    _parse_data_format(root, info)

    l2s = _get(root, "lidar_intrinsics", "lidar_to_sensor_transform")
    if l2s is not None:
        info.lidar_to_sensor_transform = _transform(l2s)
    ext = _get(root, "ouster-sdk", "extrinsic")
    if ext is not None and np.asarray(ext).size == 16:
        info.extrinsic = np.asarray(ext, dtype=np.float64).reshape(4, 4)

    # zone monitoring also engages via a configured zone-monitoring
    # destination (ref: metadata.cpp:650-656)
    if (info.config.udp_dest_zm or "") and \
            (info.config.udp_port_zm or 0) != 0:
        info.format.zone_monitoring_enabled = True

    # lidar stream disabled: port 0 or an empty udp_dest means no lidar
    # packets will arrive (ref: metadata.cpp:658-665)
    port = info.config.udp_port_lidar
    if (port if port is not None else 7504) == 0 or \
            info.config.udp_dest == "":
        info.format.udp_profile_lidar = UDPProfileLidar.OFF
    return info
