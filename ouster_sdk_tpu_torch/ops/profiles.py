"""Packet bit-layout tables for every Ouster UDP profile, as pure data.

The single source the frame decoder (ops/unpack.py) and the packet writer
(ops/packet_format.py) are generated from, mirroring the reference's
FieldInfo tables (ref: ouster_client/src/parsing.cpp:201-376) and packet
header layouts (ref: parsing.cpp:466-621).

Semantics of a FieldInfo (ref: parsing.cpp:113-159):
  value = ((le64_load(buf + bit_start//8) >> (bit_start % 8)) & ((1<<bits)-1))
          << upshift
  dtype is chosen from ceil((bits + upshift) / 8) / num_elements bytes:
  1 -> u8, 2 -> u16, 3..4 -> u32, 5..8 -> u64.

Every pixel block (4/8/12/16/20 B), column header (12/16 B), column footer
(0/4 B) and packet header/footer (0/32 B) is a multiple of 4 bytes, so a
lidar packet parses on uint32 word boundaries and every field sits at a
fixed (word, bit) position within its pixel block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.constants import ChanField
from ..core.types import HeaderType, UDPProfileIMU, UDPProfileLidar


@dataclass(frozen=True)
class FieldInfo:
    """Bit placement of one field within its enclosing block."""

    bit_start: int
    bit_size: int
    upshift: int = 0
    num_elements: int = 1

    @property
    def value_mask(self) -> int:
        """Mask of the decoded value (ref: parsing.cpp:171-188)."""
        return ((1 << self.bit_size) - 1) << self.upshift

    @property
    def dtype(self) -> np.dtype:
        """Packet-level dtype (ref: parsing.cpp:134-156)."""
        needs_bits = self.bit_size + self.upshift
        size_bytes = (needs_bits + 7) // 8
        size_bytes //= self.num_elements
        if size_bytes == 1:
            return np.dtype(np.uint8)
        if size_bytes == 2:
            return np.dtype(np.uint16)
        if size_bytes <= 4:
            return np.dtype(np.uint32)
        if size_bytes <= 8:
            return np.dtype(np.uint64)
        raise ValueError("field cannot store more than 64 bits")


def fi(bit_start: int, bit_size: int, upshift: int = 0,
       num_elements: int = 1) -> FieldInfo:
    return FieldInfo(bit_start, bit_size, upshift, num_elements)


@dataclass(frozen=True)
class ProfileEntry:
    """Per-profile channel layout (ref: parsing.cpp:195-199, 348-376)."""

    chan_data_size: int  # bytes per pixel
    fields: Dict[str, FieldInfo]


C = ChanField

# ref: parsing.cpp:201-210
LEGACY_FIELDS = {
    C.RANGE: fi(0, 20),
    C.FLAGS: fi(28, 4),
    C.REFLECTIVITY: fi(32, 8),
    C.SIGNAL: fi(48, 16),
    C.NEAR_IR: fi(64, 16),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
}

# ref: parsing.cpp:212-218
LB_FIELDS = {
    C.RANGE: fi(0, 15, 3),
    C.FLAGS: fi(15, 1),
    C.REFLECTIVITY: fi(16, 8),
    C.NEAR_IR: fi(24, 8, 4),
    C.RAW32_WORD1: fi(0, 32),
}

# ref: parsing.cpp:220-226
LB_WINDOW_FIELDS = {
    C.RANGE: fi(0, 15, 3),
    C.FLAGS: fi(15, 1),
    C.REFLECTIVITY: fi(16, 8),
    C.WINDOW: fi(24, 8),
    C.RAW32_WORD1: fi(0, 32),
}

# ref: parsing.cpp:228-242
RGB_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(24, 8),
    C.SIGNAL: fi(32, 16),
    C.NEAR_IR: fi(48, 16),
    C.R: fi(64, 16),
    C.G: fi(80, 16),
    C.B: fi(96, 16),
    C.RGB: fi(64, 48, 0, 3),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
    C.RAW32_WORD4: fi(96, 32),
}

# ref: parsing.cpp:244-263
DUAL_RGB_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(24, 8),
    C.RANGE2: fi(32, 19),
    C.FLAGS2: fi(51, 5),
    C.REFLECTIVITY2: fi(56, 8),
    C.SIGNAL: fi(64, 16),
    C.SIGNAL2: fi(80, 16),
    C.NEAR_IR: fi(96, 16),
    C.R: fi(112, 16),
    C.G: fi(128, 16),
    C.B: fi(144, 16),
    C.RGB: fi(112, 48, 0, 3),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
    C.RAW32_WORD4: fi(96, 32),
    C.RAW32_WORD5: fi(128, 32),
}

# ref: parsing.cpp:265-280
DUAL_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(24, 8),
    C.RANGE2: fi(32, 19),
    C.FLAGS2: fi(51, 5),
    C.REFLECTIVITY2: fi(56, 8),
    C.SIGNAL: fi(64, 16),
    C.SIGNAL2: fi(80, 16),
    C.NEAR_IR: fi(96, 16),
    C.WINDOW: fi(120, 8),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
    C.RAW32_WORD4: fi(96, 32),
}

# ref: parsing.cpp:282-292
SINGLE_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(32, 8),
    C.SIGNAL: fi(48, 16),
    C.NEAR_IR: fi(64, 16),
    C.WINDOW: fi(88, 8),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
}

# ref: parsing.cpp:294-309
FIVE_WORD_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(24, 8),
    C.RANGE2: fi(32, 19),
    C.FLAGS2: fi(51, 5),
    C.REFLECTIVITY2: fi(56, 8),
    C.SIGNAL: fi(64, 16),
    C.SIGNAL2: fi(80, 16),
    C.NEAR_IR: fi(96, 16),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
    C.RAW32_WORD4: fi(96, 32),
    C.RAW32_WORD5: fi(128, 32),
}

# ref: parsing.cpp:311-319
ZM_LB_FIELDS = {
    C.RANGE: fi(0, 15, 3),
    C.FLAGS: fi(15, 1),
    C.REFLECTIVITY: fi(16, 8),
    C.NEAR_IR: fi(24, 8, 4),
    C.ZONE_MASK: fi(32, 16),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
}

# ref: parsing.cpp:321-331
ZM_SINGLE_FIELDS = {
    C.RANGE: fi(0, 19),
    C.FLAGS: fi(19, 5),
    C.REFLECTIVITY: fi(32, 8),
    C.SIGNAL: fi(48, 16),
    C.NEAR_IR: fi(64, 16),
    C.ZONE_MASK: fi(80, 16),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
    C.RAW32_WORD3: fi(64, 32),
}

# ref: parsing.cpp:333-344
DUAL_LB_FIELDS = {
    C.RANGE: fi(0, 15, 3),
    C.FLAGS: fi(15, 1),
    C.REFLECTIVITY: fi(16, 8),
    C.NEAR_IR: fi(24, 8, 4),
    C.RANGE2: fi(32, 15, 3),
    C.FLAGS2: fi(47, 1),
    C.REFLECTIVITY2: fi(48, 8),
    C.WINDOW: fi(56, 8),
    C.RAW32_WORD1: fi(0, 32),
    C.RAW32_WORD2: fi(32, 32),
}

# ref: parsing.cpp:348-376
PROFILES: Dict[UDPProfileLidar, ProfileEntry] = {
    UDPProfileLidar.LEGACY: ProfileEntry(12, LEGACY_FIELDS),
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_DUAL: ProfileEntry(16, DUAL_FIELDS),
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16: ProfileEntry(12, SINGLE_FIELDS),
    UDPProfileLidar.RNG15_RFL8_NIR8: ProfileEntry(4, LB_FIELDS),
    UDPProfileLidar.FIVE_WORD_PIXEL: ProfileEntry(20, FIVE_WORD_FIELDS),
    UDPProfileLidar.FUSA_RNG15_RFL8_NIR8_DUAL: ProfileEntry(8, DUAL_LB_FIELDS),
    UDPProfileLidar.RNG15_RFL8_NIR8_DUAL: ProfileEntry(8, DUAL_LB_FIELDS),
    UDPProfileLidar.OFF: ProfileEntry(0, {}),
    UDPProfileLidar.RNG15_RFL8_NIR8_ZONE16: ProfileEntry(8, ZM_LB_FIELDS),
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_ZONE16:
        ProfileEntry(12, ZM_SINGLE_FIELDS),
    UDPProfileLidar.RNG15_RFL8_WIN8: ProfileEntry(4, LB_WINDOW_FIELDS),
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_RGB16: ProfileEntry(16, RGB_FIELDS),
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_RGB16_DUAL:
        ProfileEntry(20, DUAL_RGB_FIELDS),
}


# Runtime-extensible custom profiles (ref: profile_extension.cpp:136)
_custom_profiles: Dict[UDPProfileLidar, ProfileEntry] = {}
_custom_scan_slots: Dict[UDPProfileLidar, List[Tuple[str, np.dtype]]] = {}


def add_custom_profile(profile_nr: int, name: str,
                       fields: List[Tuple[str, FieldInfo]],
                       chan_data_size: int) -> None:
    """Register a custom UDP profile at runtime
    (ref: ouster_client/src/profile_extension.cpp:136). As in the JAX
    package, a name that is not a UDPProfileLidar value is its own key:
    a DataFormat whose udp_profile_lidar is that name decodes by the
    registered fields (PacketFormat, make_decode_plan, get_field_types)."""
    profile = _extend_profile_enum(profile_nr, name)
    _custom_profiles[profile] = ProfileEntry(chan_data_size, dict(fields))
    _custom_scan_slots[profile] = [
        (fname, finfo.dtype) for fname, finfo in fields
        if not fname.startswith("RAW32")]


def _extend_profile_enum(profile_nr: int, name: str) -> UDPProfileLidar:
    existing = [p for p in UDPProfileLidar if p.value == name]
    if existing:
        return existing[0]
    # a pseudo member: the name itself keys the registries, and callers
    # look the profile up through lookup_profile_entry
    return name  # type: ignore[return-value]


def lookup_profile_entry(profile: UDPProfileLidar) -> ProfileEntry:
    if profile in PROFILES:
        return PROFILES[profile]
    if profile in _custom_profiles:
        return _custom_profiles[profile]
    raise ValueError("Unknown lidar udp profile")


# ---------------------------------------------------------------------------
# Default scan field slots per profile (ref: lidar_scan.cpp:72-233)
# ---------------------------------------------------------------------------

_U8, _U16, _U32 = np.dtype(np.uint8), np.dtype(np.uint16), np.dtype(np.uint32)
_F16 = np.dtype(np.float16)

DEFAULT_SCAN_FIELDS: Dict[UDPProfileLidar, List[Tuple[str, np.dtype]]] = {
    UDPProfileLidar.LEGACY: [
        (C.RANGE, _U32), (C.SIGNAL, _U16), (C.NEAR_IR, _U16),
        (C.REFLECTIVITY, _U8), (C.FLAGS, _U8)],
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_DUAL: [
        (C.RANGE, _U32), (C.RANGE2, _U32), (C.SIGNAL, _U16),
        (C.SIGNAL2, _U16), (C.REFLECTIVITY, _U8), (C.REFLECTIVITY2, _U8),
        (C.FLAGS, _U8), (C.FLAGS2, _U8), (C.NEAR_IR, _U16), (C.WINDOW, _U8)],
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16: [
        (C.RANGE, _U32), (C.SIGNAL, _U16), (C.REFLECTIVITY, _U8),
        (C.FLAGS, _U8), (C.NEAR_IR, _U16), (C.WINDOW, _U8)],
    UDPProfileLidar.RNG15_RFL8_NIR8: [
        (C.RANGE, _U32), (C.REFLECTIVITY, _U8), (C.NEAR_IR, _U16),
        (C.FLAGS, _U8)],
    UDPProfileLidar.RNG15_RFL8_WIN8: [
        (C.RANGE, _U32), (C.REFLECTIVITY, _U8), (C.WINDOW, _U8),
        (C.FLAGS, _U8)],
    UDPProfileLidar.FIVE_WORD_PIXEL: [
        (C.RAW32_WORD1, _U32), (C.RAW32_WORD2, _U32), (C.RAW32_WORD3, _U32),
        (C.RAW32_WORD4, _U32), (C.RAW32_WORD5, _U32)],
    UDPProfileLidar.FUSA_RNG15_RFL8_NIR8_DUAL: [
        (C.RANGE, _U32), (C.REFLECTIVITY, _U8), (C.NEAR_IR, _U16),
        (C.RANGE2, _U32), (C.REFLECTIVITY2, _U8), (C.FLAGS, _U8),
        (C.FLAGS2, _U8), (C.WINDOW, _U8)],
    UDPProfileLidar.RNG15_RFL8_NIR8_DUAL: [
        (C.RANGE, _U32), (C.REFLECTIVITY, _U8), (C.NEAR_IR, _U16),
        (C.RANGE2, _U32), (C.REFLECTIVITY2, _U8), (C.FLAGS, _U8),
        (C.FLAGS2, _U8), (C.WINDOW, _U8)],
    UDPProfileLidar.OFF: [],
    UDPProfileLidar.RNG15_RFL8_NIR8_ZONE16: [
        (C.RANGE, _U32), (C.REFLECTIVITY, _U8), (C.NEAR_IR, _U16),
        (C.FLAGS, _U8), (C.ZONE_MASK, _U16)],
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_ZONE16: [
        (C.RANGE, _U32), (C.SIGNAL, _U16), (C.REFLECTIVITY, _U8),
        (C.FLAGS, _U8), (C.NEAR_IR, _U16), (C.ZONE_MASK, _U16)],
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_RGB16: [
        (C.RANGE, _U32), (C.SIGNAL, _U16), (C.REFLECTIVITY, _U8),
        (C.NEAR_IR, _U16), (C.RGB, _F16), (C.FLAGS, _U8)],
    UDPProfileLidar.RNG19_RFL8_SIG16_NIR16_RGB16_DUAL: [
        (C.RANGE, _U32), (C.RANGE2, _U32), (C.SIGNAL, _U16),
        (C.SIGNAL2, _U16), (C.REFLECTIVITY, _U8), (C.REFLECTIVITY2, _U8),
        (C.NEAR_IR, _U16), (C.RGB, _F16), (C.FLAGS, _U8), (C.FLAGS2, _U8)],
}


def lookup_scan_fields(profile: UDPProfileLidar) -> List[Tuple[str, np.dtype]]:
    if profile in DEFAULT_SCAN_FIELDS:
        return list(DEFAULT_SCAN_FIELDS[profile])
    if profile in _custom_scan_slots:
        return list(_custom_scan_slots[profile])
    raise ValueError("Unknown lidar udp profile")



# ---------------------------------------------------------------------------
# Packet geometry (ref: parsing.cpp:466-621)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PacketGeometry:
    """Byte geometry + header FieldInfos for a (profile, format) pair."""

    legacy: bool
    fusa: bool
    packet_header_size: int
    col_header_size: int
    channel_data_size: int
    col_footer_size: int
    packet_footer_size: int
    col_size: int
    lidar_packet_size: int
    imu_packet_size: int
    zone_packet_size: int
    imu_measurement_offset: int
    imu_measurement_size: int
    zone_measurement_offset: int
    zone_measurement_size: int
    max_frame_id: int
    pixels_per_column: int
    columns_per_packet: int

    # packet-header fields, bit offsets relative to packet start
    packet_type: FieldInfo = fi(0, 0)
    frame_id: FieldInfo = fi(0, 0)
    init_id: FieldInfo = fi(0, 0)
    prod_sn: FieldInfo = fi(0, 0)
    alert_flags: FieldInfo = fi(0, 0)
    countdown_thermal_shutdown: FieldInfo = fi(0, 0)
    countdown_shot_limiting: FieldInfo = fi(0, 0)
    thermal_shutdown: FieldInfo = fi(0, 0)
    shot_limiting: FieldInfo = fi(0, 0)

    # column-header fields, bit offsets relative to column start
    col_timestamp: FieldInfo = fi(0, 64)
    col_measurement_id: FieldInfo = fi(64, 16)
    col_status: FieldInfo = fi(80, 16)
    # legacy only: frame id + encoder count live in the column header
    col_frame_id: FieldInfo = fi(0, 0)
    col_encoder: FieldInfo = fi(0, 0)

    # IMU fields
    imu_sys_ts: FieldInfo = fi(0, 0)
    imu_accel_ts: FieldInfo = fi(0, 0)
    imu_gyro_ts: FieldInfo = fi(0, 0)
    imu_nmea_ts: FieldInfo = fi(0, 0)
    imu_la_x: FieldInfo = fi(0, 0)
    imu_la_y: FieldInfo = fi(0, 0)
    imu_la_z: FieldInfo = fi(0, 0)
    imu_av_x: FieldInfo = fi(0, 0)
    imu_av_y: FieldInfo = fi(0, 0)
    imu_av_z: FieldInfo = fi(0, 0)


def make_packet_geometry(fmt) -> PacketGeometry:
    """Build byte geometry for a DataFormat (ref: parsing.cpp:466-621)."""
    profile = fmt.udp_profile_lidar
    legacy = profile == UDPProfileLidar.LEGACY
    fusa = (fmt.header_type == HeaderType.FUSA) and not legacy
    entry = lookup_profile_entry(profile)

    packet_header_size = 0 if legacy else 32
    col_header_size = 16 if legacy else 12
    col_footer_size = 4 if legacy else 0
    packet_footer_size = 0 if legacy else 32
    chan = entry.chan_data_size
    col_size = col_header_size + fmt.pixels_per_column * chan + col_footer_size
    lidar_packet_size = (packet_header_size
                         + fmt.columns_per_packet * col_size
                         + packet_footer_size)
    if lidar_packet_size > 65535:
        raise ValueError("lidar_packet_size cannot exceed 65535")

    kw: Dict[str, FieldInfo] = {}
    if legacy:
        kw["frame_id"] = fi(80, 16)  # inside first column header
        # LEGACY col_status sits at the *end* of the column (last 4 bytes)
        kw["col_status"] = fi(8 * (col_size - col_footer_size), 32)
        kw["col_frame_id"] = fi(80, 16)
        kw["col_encoder"] = fi(96, 32)
    elif fusa:
        kw["packet_type"] = fi(0, 8)
        kw["frame_id"] = fi(32, 32)
        kw["init_id"] = fi(8, 24)
        kw["alert_flags"] = fi(64, 8)
        kw["prod_sn"] = fi(88, 40)
        kw["countdown_thermal_shutdown"] = fi(128, 8)
        kw["countdown_shot_limiting"] = fi(136, 8)
        kw["thermal_shutdown"] = fi(144, 4)
        kw["shot_limiting"] = fi(156, 4)
        kw["col_status"] = fi(80, 16)
    else:
        kw["packet_type"] = fi(0, 16)
        kw["frame_id"] = fi(16, 16)
        kw["init_id"] = fi(32, 24)
        kw["prod_sn"] = fi(56, 40)
        kw["alert_flags"] = fi(96, 8)
        kw["countdown_thermal_shutdown"] = fi(128, 8)
        kw["countdown_shot_limiting"] = fi(136, 8)
        kw["thermal_shutdown"] = fi(144, 4)
        kw["shot_limiting"] = fi(156, 4)
        kw["col_status"] = fi(80, 16)

    # IMU packet geometry (ref: parsing.cpp:563-598)
    imu_measurement_offset = 0
    imu_measurement_size = 0
    if fmt.udp_profile_imu == UDPProfileIMU.LEGACY:
        imu_packet_size = 48
        kw["imu_sys_ts"] = fi(0, 64)
        kw["imu_accel_ts"] = fi(64, 64)
        kw["imu_gyro_ts"] = fi(128, 64)
        kw["imu_la_x"] = fi(192, 32)
        kw["imu_la_y"] = fi(224, 32)
        kw["imu_la_z"] = fi(256, 32)
        kw["imu_av_x"] = fi(288, 32)
        kw["imu_av_y"] = fi(320, 32)
        kw["imu_av_z"] = fi(352, 32)
    else:  # ACCEL32_GYRO32_NMEA
        nmea_block_size = 100
        imu_measurement_size = 36
        imu_packet_size = (packet_header_size + nmea_block_size
                           + fmt.imu_measurements_per_packet
                           * imu_measurement_size
                           + packet_footer_size)
        imu_measurement_offset = packet_header_size + nmea_block_size
        kw["imu_nmea_ts"] = fi(packet_header_size * 8, 64)
        kw["imu_la_x"] = fi(96, 32)
        kw["imu_la_y"] = fi(128, 32)
        kw["imu_la_z"] = fi(160, 32)
        kw["imu_av_x"] = fi(192, 32)
        kw["imu_av_y"] = fi(224, 32)
        kw["imu_av_z"] = fi(256, 32)

    zone_measurement_offset = packet_header_size + 8 + 32
    zone_measurement_size = 36
    zone_packet_size = (packet_header_size + 8 + 32
                        + zone_measurement_size * 16 + packet_footer_size)

    return PacketGeometry(
        legacy=legacy,
        fusa=fusa,
        packet_header_size=packet_header_size,
        col_header_size=col_header_size,
        channel_data_size=chan,
        col_footer_size=col_footer_size,
        packet_footer_size=packet_footer_size,
        col_size=col_size,
        lidar_packet_size=lidar_packet_size,
        imu_packet_size=imu_packet_size,
        zone_packet_size=zone_packet_size,
        imu_measurement_offset=imu_measurement_offset,
        imu_measurement_size=imu_measurement_size,
        zone_measurement_offset=zone_measurement_offset,
        zone_measurement_size=zone_measurement_size,
        max_frame_id=(2**32 - 1) if fusa else (2**16 - 1),
        pixels_per_column=fmt.pixels_per_column,
        columns_per_packet=fmt.columns_per_packet,
        **kw,
    )


# Zone packet record layout (ref: parsing.cpp:600-620); offsets relative to
# the start of a 36-byte zone measurement record, except zone_timestamp which
# is relative to packet start + header.
ZONE_TIMESTAMP = fi(256, 64)  # relative to packet start
ZONE_RECORD_FIELDS = {
    "live": fi(0, 1),
    "id": fi(8, 8),
    "error_flags": fi(16, 8),
    "trigger_type": fi(26, 2),
    "trigger_status": fi(31, 1),
    "triggered_frames": fi(32, 32),
    "count": fi(64, 32),
    "occlusion_count": fi(96, 32),
    "invalid_count": fi(128, 32),
    "max_count": fi(160, 32),
    "min_range": fi(192, 19),
    "max_range": fi(224, 19),
    "mean_range": fi(256, 19),
}
