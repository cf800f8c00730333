"""PacketFormat: packet geometry and vectorized numpy reads of lidar, IMU
and zone packets, and the packet writer.

The SDK's PacketFormat / PacketWriter (ref: ouster_client/src/parsing.cpp:
399-1241, types.h:1598) on the host: the decoder ScanBatcher parses packets
with, the header reads the device engine populates scan headers from, and
the writer that synthesizes packets from field values (test captures and
the chip smoke run's captures). The device decoder in ops/unpack.py is
generated from the same profile tables.

A packet is viewed as little-endian uint32 words; every block boundary is
4-byte aligned, so fields are word-parallel shift/mask operations with no
per-pixel loops.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np

from ..core.types import DataFormat, SensorInfo
from ..utils import native
from .profiles import (
    FieldInfo,
    PacketGeometry,
    ZONE_RECORD_FIELDS,
    ZONE_TIMESTAMP,
    lookup_profile_entry,
    make_packet_geometry,
)


def _mask32(size: int) -> np.uint32:
    return np.uint32((1 << size) - 1) if size < 32 else np.uint32(0xFFFFFFFF)


def read_bits(words: np.ndarray, info: FieldInfo,
              element: int = 0) -> np.ndarray:
    """Extract a bitfield from uint32 word blocks.

    `words` has the block's words on the last axis; `info.bit_start` is
    relative to the block start. Returns an array of info.dtype with the
    leading axes of `words`. Replicates FieldInfo::get semantics
    (ref: parsing.cpp:59-72) including upshift.
    """
    if info.bit_size == 0:
        shape = words.shape[:-1]
        return np.zeros(shape, dtype=np.uint32)

    size = info.bit_size
    upshift = info.upshift
    bit = info.bit_start
    if info.num_elements > 1:
        # multi-element fields (RGB): each element is size/num_elements bits
        per = size // info.num_elements
        bit = bit + element * per
        size = per

    w0, b = divmod(bit, 32)
    out_dtype = info.dtype

    if b + size <= 32:
        v = (words[..., w0] >> np.uint32(b)) & _mask32(size)
        res = v.astype(out_dtype, copy=True)
    elif size <= 32:
        lo = words[..., w0] >> np.uint32(b)
        hi = words[..., w0 + 1] << np.uint32(32 - b)
        v = (lo | hi) & _mask32(size)
        res = v.astype(out_dtype, copy=True)
    else:
        lo = words[..., w0].astype(np.uint64)
        hi = words[..., w0 + 1].astype(np.uint64)
        v = ((lo | (hi << np.uint64(32))) >> np.uint64(b))
        if size < 64:
            v &= np.uint64((1 << size) - 1)
        res = v.astype(out_dtype, copy=True)

    if upshift:
        res = (res << out_dtype.type(upshift)).astype(out_dtype)
    return res


def write_bits(words: np.ndarray, info: FieldInfo, value: np.ndarray,
               element: int = 0) -> None:
    """Inverse of read_bits (ref: FieldInfo::set, parsing.cpp:82-96).

    Mutates `words` in place. `value` must broadcast to the block leading
    axes.
    """
    if info.bit_size == 0:
        return
    size = info.bit_size
    bit = info.bit_start
    if info.num_elements > 1:
        per = size // info.num_elements
        bit = bit + element * per
        size = per

    v = np.asarray(value).astype(np.uint64)
    if info.upshift:
        v = v >> np.uint64(info.upshift)
    v &= np.uint64((1 << size) - 1)

    w0, b = divmod(bit, 32)
    lo_bits = min(size, 32 - b)
    lo_mask = np.uint32(((1 << lo_bits) - 1) << b)
    lo_val = ((v << np.uint64(b)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words[..., w0] = (words[..., w0] & ~lo_mask) | (lo_val & lo_mask)
    rem = size - lo_bits
    if rem > 0:
        hi_mask = _mask32(rem)
        hi_val = (v >> np.uint64(lo_bits)).astype(np.uint32)
        words[..., w0 + 1] = \
            (words[..., w0 + 1] & ~hi_mask) | (hi_val & hi_mask)


class PacketFormat:
    """Geometry + decode for one sensor's packet format
    (ref: types.h:1598, parsing.cpp:399-1016)."""

    _cache: Dict[Tuple, "PacketFormat"] = {}
    _cache_lock = threading.Lock()

    def __init__(self, info_or_format: Union[SensorInfo, DataFormat]):
        fmt = (info_or_format.format
               if isinstance(info_or_format, SensorInfo) else info_or_format)
        self._format = fmt
        self.geom: PacketGeometry = make_packet_geometry(fmt)
        self.udp_profile_lidar = fmt.udp_profile_lidar
        self.udp_profile_imu = fmt.udp_profile_imu
        self.header_type = fmt.header_type
        entry = lookup_profile_entry(fmt.udp_profile_lidar)
        self._fields: Dict[str, FieldInfo] = dict(sorted(entry.fields.items()))

        g = self.geom
        self.lidar_packet_size = g.lidar_packet_size
        self.imu_packet_size = g.imu_packet_size
        self.zone_packet_size = g.zone_packet_size
        self.columns_per_packet = fmt.columns_per_packet
        self.pixels_per_column = fmt.pixels_per_column
        self.imu_measurements_per_packet = fmt.imu_measurements_per_packet
        self.imu_packets_per_frame = fmt.imu_packets_per_frame
        self.packet_header_size = g.packet_header_size
        self.col_header_size = g.col_header_size
        self.col_footer_size = g.col_footer_size
        self.col_size = g.col_size
        self.packet_footer_size = g.packet_footer_size
        self.max_frame_id = g.max_frame_id
        self.zone_monitoring_enabled = fmt.zone_monitoring_enabled

    @staticmethod
    def from_info(info: SensorInfo) -> "PacketFormat":
        """Cached accessor (ref: parsing.cpp:1002-1016 get_format)."""
        fmt = info.format
        key = (fmt.udp_profile_lidar, fmt.udp_profile_imu, fmt.header_type,
               fmt.pixels_per_column, fmt.columns_per_packet,
               fmt.imu_measurements_per_packet, fmt.imu_packets_per_frame)
        with PacketFormat._cache_lock:
            if key not in PacketFormat._cache:
                PacketFormat._cache[key] = PacketFormat(fmt)
            return PacketFormat._cache[key]

    @staticmethod
    def from_data_format(fmt: DataFormat) -> "PacketFormat":
        """(ref: client.pyi PacketFormat.from_data_format)"""
        return PacketFormat(fmt)

    @staticmethod
    def from_metadata(info: SensorInfo) -> "PacketFormat":
        """(ref: client.pyi PacketFormat.from_metadata)"""
        return PacketFormat.from_info(info)

    # -- structural views -------------------------------------------------
    def _as_words(self, buf: Union[bytes, np.ndarray]) -> np.ndarray:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        n = self.lidar_packet_size
        return a[:n].view("<u4")

    def col_blocks(self, buf) -> np.ndarray:
        """(columns_per_packet, col_words) uint32 view of the column blocks."""
        words = self._as_words(buf)
        hw = self.packet_header_size // 4
        cw = self.col_size // 4
        ncols = self.columns_per_packet
        return words[hw:hw + ncols * cw].reshape(ncols, cw)

    def px_blocks(self, buf) -> np.ndarray:
        """(columns, pixels, px_words) uint32 view of channel data blocks."""
        cols = self.col_blocks(buf)
        chw = self.col_header_size // 4
        pw = self.geom.channel_data_size // 4
        n_px = self.pixels_per_column
        return cols[:, chw:chw + n_px * pw].reshape(
            cols.shape[0], n_px, pw)

    # -- channel fields ---------------------------------------------------
    @property
    def fields(self) -> Iterator[str]:
        return iter(self._fields)

    def field_info(self, name: str) -> FieldInfo:
        return self._fields[name]

    def field_type(self, name: str) -> np.dtype:
        return self._fields[name].dtype

    def field_value_mask(self, name: str) -> int:
        return self._fields[name].value_mask

    def field_bitness(self, name: str) -> int:
        """Bit width of a field's decoded value."""
        return self._fields[name].bit_size

    def packet_field(self, name: str, buf) -> np.ndarray:
        """Decode one channel field to (pixels, columns)
        (ref: python/src/cpp/client/packet.cpp packet_field binding)."""
        info = self._fields[name]
        px = self.px_blocks(buf)  # (cols, pixels, pw)
        return read_bits(px, info).T.copy()

    def packet_field_all(self, name: str, bufs: np.ndarray) -> np.ndarray:
        """Batched decode over (n_packets, packet_bytes) -> (n, px, cols)."""
        n = bufs.shape[0]
        words = bufs[:, :self.lidar_packet_size].reshape(n, -1).view("<u4")
        hw = self.packet_header_size // 4
        cw = self.col_size // 4
        chw = self.col_header_size // 4
        pw = self.geom.channel_data_size // 4
        ncols, npx = self.columns_per_packet, self.pixels_per_column
        cols = words[:, hw:hw + ncols * cw].reshape(n, ncols, cw)
        pxb = cols[:, :, chw:chw + npx * pw].reshape(n, ncols, npx, pw)
        info = self._fields[name]
        return np.swapaxes(read_bits(pxb, info), 1, 2)

    # -- column headers ---------------------------------------------------
    def packet_header(self, header, buf) -> np.ndarray:
        """Per-column header array; header index follows the reference
        ColHeader enum (ref: packet.cpp:171-194, data.py ColHeader)."""
        idx = int(header)
        cols = self.col_blocks(buf)
        g = self.geom
        if idx == 0:
            return read_bits(cols, g.col_timestamp).astype(np.uint64)
        if idx == 1:  # ENCODER_COUNT (deprecated; legacy only)
            return read_bits(cols, g.col_encoder).astype(np.uint32)
        if idx == 2:
            return read_bits(cols, g.col_measurement_id).astype(np.uint16)
        if idx == 3:
            return read_bits(cols, g.col_status).astype(np.uint32)
        if idx == 4:
            return read_bits(cols, g.col_frame_id).astype(np.uint16)
        raise KeyError("Invalid header index for PacketFormat")

    def col_timestamp(self, buf) -> np.ndarray:
        return read_bits(self.col_blocks(buf), self.geom.col_timestamp)

    def col_measurement_id(self, buf) -> np.ndarray:
        return read_bits(self.col_blocks(buf), self.geom.col_measurement_id)

    def col_status(self, buf) -> np.ndarray:
        return read_bits(self.col_blocks(buf), self.geom.col_status) \
            .astype(np.uint32)

    # -- packet headers ---------------------------------------------------
    def _pkt_words(self, buf) -> np.ndarray:
        return self._as_words(buf)

    def scalar_reader(self, fi):
        """Byte-level closure reading one packet-header scalar straight
        from raw packet bytes (bytes or a u8 array), skipping the u32 word
        staging: the live receive path checks init_id and prod_sn on every
        packet (same le64-load semantics as read_bits / FieldInfo::get,
        ref: parsing.cpp:59-72)."""
        byte0, b = divmod(fi.bit_start, 8)
        nb = (b + fi.bit_size + 7) // 8
        mask = (1 << fi.bit_size) - 1
        up = fi.upshift

        def read(data) -> int:
            v = int.from_bytes(bytes(data[byte0:byte0 + nb]), "little")
            v = (v >> b) & mask
            return v << up if up else v

        return read

    def packet_type(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.packet_type))

    def frame_id(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.frame_id))

    def init_id(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.init_id))

    def prod_sn(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.prod_sn))

    def alert_flags(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.alert_flags))

    def countdown_thermal_shutdown(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf),
                             self.geom.countdown_thermal_shutdown))

    def countdown_shot_limiting(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf),
                             self.geom.countdown_shot_limiting))

    def thermal_shutdown(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf),
                             self.geom.thermal_shutdown))

    def shot_limiting(self, buf) -> int:
        return int(read_bits(self._pkt_words(buf), self.geom.shot_limiting))

    # -- CRC64 (ref: parsing.cpp:1243-1289) -------------------------------
    _CRC64_TABLE: Optional[np.ndarray] = None

    @classmethod
    def _crc64_table(cls) -> np.ndarray:
        if cls._CRC64_TABLE is None:
            poly = np.uint64(0xC96C5795D7870F42)  # ECMA-182, reflected
            table = np.zeros(256, dtype=np.uint64)
            for i in range(256):
                crc = np.uint64(i)
                for _ in range(8):
                    if crc & np.uint64(1):
                        crc = (crc >> np.uint64(1)) ^ poly
                    else:
                        crc >>= np.uint64(1)
                table[i] = crc
            cls._CRC64_TABLE = table
        return cls._CRC64_TABLE

    def calculate_crc(self, buf) -> int:
        """CRC64 over all bytes except the trailing 8-byte CRC field: the
        native library's where it is built, else byte at a time through
        the table (the two are tested equal)."""
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        data = a[: len(a) - 8]
        fast = native.crc64(data)
        if fast is not None:
            return fast
        table = self._crc64_table()
        crc = np.uint64(0xFFFFFFFFFFFFFFFF)
        for b in data.tobytes():
            crc = table[(int(crc) ^ b) & 0xFF] ^ (crc >> np.uint64(8))
        return int(crc ^ np.uint64(0xFFFFFFFFFFFFFFFF))

    def crc(self, buf) -> Optional[int]:
        """Stored CRC64: last 8 bytes of the packet footer
        (ref: parsing.cpp:1274-1289)."""
        if self.packet_footer_size == 0:
            return None
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        return int(a[len(a) - 8:].view("<u8")[0])

    # -- IMU packets (ref: parsing.cpp:792-974) ---------------------------
    def _imu_words(self, buf) -> np.ndarray:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        return a[: self.imu_packet_size].view("<u4")

    def imu_sys_ts(self, buf) -> int:
        return int(read_bits(self._imu_words(buf), self.geom.imu_sys_ts))

    def imu_accel_ts(self, buf) -> int:
        return int(read_bits(self._imu_words(buf), self.geom.imu_accel_ts))

    def imu_gyro_ts(self, buf) -> int:
        return int(read_bits(self._imu_words(buf), self.geom.imu_gyro_ts))

    def imu_nmea_ts(self, buf) -> int:
        return int(read_bits(self._imu_words(buf), self.geom.imu_nmea_ts))

    def imu_nmea_sentence(self, buf) -> bytes:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        start = self.packet_header_size + 8
        return a[start:start + 84].tobytes()

    def _imu_measurement_blocks(self, buf) -> np.ndarray:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        g = self.geom
        n = self.imu_measurements_per_packet
        blk = a[g.imu_measurement_offset:
                g.imu_measurement_offset + n * g.imu_measurement_size]
        return blk.reshape(n, g.imu_measurement_size).view("<u4")

    def imu_nth_measurement_words(self, buf) -> np.ndarray:
        return self._imu_measurement_blocks(buf)

    def _imu_float(self, buf, info: FieldInfo) -> float:
        v = read_bits(self._imu_words(buf), info)
        return float(np.asarray(v, dtype=np.uint32).view(np.float32))

    def imu_la_x(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_la_x)

    def imu_la_y(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_la_y)

    def imu_la_z(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_la_z)

    def imu_av_x(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_av_x)

    def imu_av_y(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_av_y)

    def imu_av_z(self, buf) -> float:
        return self._imu_float(buf, self.geom.imu_av_z)

    def parse_accel(self, buf) -> np.ndarray:
        """(n_measurements, 3) float32 accelerations
        (ref: parsing.cpp:910-952 parse_accel)."""
        blocks = self._imu_measurement_blocks(buf)
        # accel xyz at bits 96/128/160 within a 36-B measurement
        return blocks[:, 3:6].copy().view(np.float32)

    def parse_gyro(self, buf) -> np.ndarray:
        blocks = self._imu_measurement_blocks(buf)
        return blocks[:, 6:9].copy().view(np.float32)

    def imu_measurement_headers(self, buf) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
        """(ts u64, m_id u16, status u16) per measurement."""
        blocks = self._imu_measurement_blocks(buf)
        ts = read_bits(blocks, FieldInfo(0, 64))
        m_id = read_bits(blocks, FieldInfo(64, 16))
        status = read_bits(blocks, FieldInfo(80, 16))
        return ts, m_id, status

    # -- zone packets (ref: parsing.cpp:600-620, 1361) --------------------
    def zone_timestamp(self, buf) -> int:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        return int(read_bits(a[: self.zone_packet_size].view("<u4"),
                             ZONE_TIMESTAMP))

    def live_zoneset_hash(self, buf) -> np.ndarray:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        start = self.packet_header_size + 8
        return a[start:start + 32].copy()

    def zone_measurements(self, buf) -> Dict[str, np.ndarray]:
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        g = self.geom
        blk = a[g.zone_measurement_offset:
                g.zone_measurement_offset + 16 * g.zone_measurement_size]
        words = blk.reshape(16, g.zone_measurement_size).view("<u4")
        return {name: read_bits(words, info)
                for name, info in ZONE_RECORD_FIELDS.items()}


def _writable(packet_or_buf) -> np.ndarray:
    buf = getattr(packet_or_buf, "buf", packet_or_buf)
    arr = (buf if isinstance(buf, np.ndarray)
           else np.frombuffer(buf, dtype=np.uint8))
    if not arr.flags.writeable:
        raise ValueError("packet buffer is not writable")
    return arr


class PacketWriter(PacketFormat):
    """Synthesize packet bytes from values — the inverse direction, used to
    fabricate test streams (ref: ouster_client/include/ouster/impl/
    packet_writer.h, parsing.cpp:1030-1241)."""

    @staticmethod
    def from_info(info: SensorInfo) -> "PacketWriter":
        """A new writer: the PacketFormat cache holds readers only."""
        return PacketWriter(info)

    @staticmethod
    def from_data_format(fmt: DataFormat) -> "PacketWriter":
        return PacketWriter(fmt)

    def new_packet(self) -> np.ndarray:
        return np.zeros(self.lidar_packet_size, dtype=np.uint8)

    def set_frame_id(self, buf: np.ndarray, frame_id: int) -> None:
        words = buf.view("<u4")
        write_bits(words, self.geom.frame_id, frame_id)

    def set_packet_header(self, buf: np.ndarray, *, init_id: int = 0,
                          prod_sn: int = 0, packet_type: int = 1,
                          alert_flags: int = 0, thermal_shutdown: int = 0,
                          shot_limiting: int = 0,
                          countdown_thermal: int = 0,
                          countdown_shot: int = 0) -> None:
        words = buf.view("<u4")
        g = self.geom
        write_bits(words, g.packet_type, packet_type)
        write_bits(words, g.init_id, init_id)
        write_bits(words, g.prod_sn, prod_sn)
        write_bits(words, g.alert_flags, alert_flags)
        write_bits(words, g.thermal_shutdown, thermal_shutdown)
        write_bits(words, g.shot_limiting, shot_limiting)
        write_bits(words, g.countdown_thermal_shutdown, countdown_thermal)
        write_bits(words, g.countdown_shot_limiting, countdown_shot)

    def set_col_headers(self, buf: np.ndarray, timestamps: np.ndarray,
                        m_ids: np.ndarray, statuses: np.ndarray) -> None:
        hw = self.packet_header_size // 4
        cw = self.col_size // 4
        words = buf.view("<u4")
        cols = words[hw:hw + self.columns_per_packet * cw].reshape(
            self.columns_per_packet, cw)
        g = self.geom
        write_bits(cols, g.col_timestamp, timestamps)
        write_bits(cols, g.col_measurement_id, m_ids)
        write_bits(cols, g.col_status, statuses)

    def set_field(self, buf: np.ndarray, name: str,
                  values: np.ndarray) -> None:
        """values: (pixels, columns) array in the field's value range."""
        info = self._fields[name]
        hw = self.packet_header_size // 4
        cw = self.col_size // 4
        chw = self.col_header_size // 4
        pw = self.geom.channel_data_size // 4
        words = buf.view("<u4")
        cols = words[hw:hw + self.columns_per_packet * cw].reshape(
            self.columns_per_packet, cw)
        px = cols[:, chw:chw + self.pixels_per_column * pw].reshape(
            self.columns_per_packet, self.pixels_per_column, pw)
        vals = np.swapaxes(np.asarray(values), 0, 1)  # -> (cols, pixels, ...)
        if info.num_elements > 1:
            for e in range(info.num_elements):
                write_bits(px, info, vals[..., e], element=e)
        else:
            write_bits(px, info, vals)

    # -- single-value setters, on a packet or its buffer
    # (ref: impl/packet_writer.h) ------------------------------------------
    def _col_words(self, packet, col_idx: int) -> np.ndarray:
        hw = self.packet_header_size // 4
        cw = self.col_size // 4
        words = _writable(packet).view("<u4")
        return words[hw + col_idx * cw: hw + (col_idx + 1) * cw]

    def set_col_timestamp(self, packet, col_idx: int, ts: int) -> None:
        write_bits(self._col_words(packet, col_idx),
                   self.geom.col_timestamp, ts)

    def set_col_measurement_id(self, packet, col_idx: int,
                               m_id: int) -> None:
        write_bits(self._col_words(packet, col_idx),
                   self.geom.col_measurement_id, m_id)

    def set_col_status(self, packet, col_idx: int, status: int) -> None:
        write_bits(self._col_words(packet, col_idx), self.geom.col_status,
                   status)

    def set_alert_flags(self, packet, alert_flags: int) -> None:
        write_bits(_writable(packet).view("<u4"), self.geom.alert_flags,
                   alert_flags)

    def set_shot_limiting_countdown(self, packet, value: int) -> None:
        write_bits(_writable(packet).view("<u4"),
                   self.geom.countdown_shot_limiting, value)

    def set_shutdown_countdown(self, packet, value: int) -> None:
        write_bits(_writable(packet).view("<u4"),
                   self.geom.countdown_thermal_shutdown, value)


# The JAX package attaches these methods to the classes from module-level
# functions of these names; here they are the classes' own methods, and
# the names are aliases of them.
_pf_field_bitness = PacketFormat.field_bitness
_pf_from_data_format = PacketFormat.from_data_format
_pf_from_metadata = PacketFormat.from_metadata
_pw_from_info = PacketWriter.from_info
_pw_from_data_format = PacketWriter.from_data_format
_pw_buf = _writable
_pw_col_words = PacketWriter._col_words
_pw_set_col_timestamp = PacketWriter.set_col_timestamp
_pw_set_col_measurement_id = PacketWriter.set_col_measurement_id
_pw_set_col_status = PacketWriter.set_col_status
_pw_set_alert_flags = PacketWriter.set_alert_flags
_pw_set_shot_limiting_countdown = PacketWriter.set_shot_limiting_countdown
_pw_set_shutdown_countdown = PacketWriter.set_shutdown_countdown
