"""ScanBatcher: packet -> LidarScan assembly state machine.

The SDK's batcher (ref: ouster_client/src/lidar_scan.cpp:1035-1643) in
numpy. The per-packet pixel decode is vectorized (ops/packet_format.py);
frame-boundary logic, reorder/duplicate handling and the zero-fill
semantics replicate the SDK's exactly. The device engine
(io/device_engine.py) batches whole frames of packets and decodes them on
the device instead; this class is the streaming path and the oracle the
engine's scans are held bit-equal to.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .constants import (
    ChanField,
    FRAME_STATUS_SHOT_LIMITING_SHIFT,
    FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT,
)
from .lidar_scan import LidarScan
from .packets import ImuPacket, LidarPacket, Packet, ZonePacket
from .types import SensorInfo, UDPProfileIMU, UDPProfileLidar
from ..ops.packet_format import PacketFormat, read_bits


def _to_scan_dtype(vals: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Packet value -> scan field dtype. Float targets take the raw bit
    pattern (the reference reinterprets RGB u16 as float16,
    ref: lidar_scan.cpp:1084-1097), integer targets cast."""
    if np.issubdtype(dtype, np.floating):
        src = {2: np.uint16, 4: np.uint32, 8: np.uint64}[dtype.itemsize]
        return np.ascontiguousarray(vals.astype(src, copy=False)).view(dtype)
    return vals.astype(dtype, copy=False)


def _frame_status(thermal_shutdown: int, shot_limiting: int) -> int:
    """(ref: lidar_scan.cpp:1101-1116)"""
    res = (thermal_shutdown & 0x0F) << FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT
    res |= (shot_limiting & 0x0F) << FRAME_STATUS_SHOT_LIMITING_SHIFT
    return res


class ScanBatcher:
    """Assembles packets into LidarScans; call returns True when a scan is
    complete and ready to be consumed (ref: lidar_scan.h:874-949)."""

    def __init__(self, info: SensorInfo):
        if info.format.columns_per_packet == 0:
            raise ValueError("unexpected columns_per_packet: 0")
        self._info = info
        self.w = info.format.columns_per_frame
        self.h = info.format.pixels_per_column
        self.pf = PacketFormat.from_info(info)

        self._expected_lidar_packets = info.format.lidar_packets_per_frame()
        self._expected_imu_packets = (
            info.format.imu_packets_per_frame
            if info.format.udp_profile_imu == UDPProfileIMU.ACCEL32_GYRO32_NMEA
            else 0)
        self._expected_zone_packets = (
            1 if info.format.zone_monitoring_enabled else 0)

        self._finished_scan_id = -1
        self._next_valid_m_id = 0
        self._next_headers_m_id = 0
        self._batched_lidar_packets = 0
        self._batched_imu_packets = 0
        self._batched_zone_packets = 0
        self._cache: Optional[Packet] = None

    # ------------------------------------------------------------------
    def __call__(self, packet: Packet, ls: LidarScan) -> bool:
        """(ref: lidar_scan.cpp:1505-1591)"""
        pf = self.pf
        if isinstance(packet, ImuPacket) and \
                pf.udp_profile_imu != UDPProfileIMU.ACCEL32_GYRO32_NMEA:
            return False

        if ls.w != self.w or ls.h != self.h:
            raise ValueError("unexpected scan dimensions")
        if len(ls.packet_timestamp) != self.w // pf.columns_per_packet:
            raise ValueError("unexpected scan columns_per_packet")

        # process cached packet from the previous frame boundary
        if self._cache is not None:
            cached, self._cache = self._cache, None
            self(cached, ls)

        buf = packet.buf
        f_id = pf.frame_id(buf)
        max_fid = pf.max_frame_id

        if ls.frame_id == -1 or self._finished_scan_id >= 0:
            # expecting to start a new scan
            if self._finished_scan_id >= 0:
                if self._finished_scan_id == f_id:
                    return False  # old duplicate
                if self._finished_scan_id == (f_id + 1) % (max_fid + 1):
                    return False  # reordered from previous frame
            self._finished_scan_id = -1
            self._next_valid_m_id = 0
            self._next_headers_m_id = 0
            self._batched_lidar_packets = 0
            self._batched_imu_packets = 0
            self._batched_zone_packets = 0
            ls.frame_id = f_id
            ls.timestamp[:] = 0
            ls.measurement_id[:] = 0
            ls.status[:] = 0
            ls.packet_timestamp[:] = 0
            ls.frame_status = _frame_status(
                pf.thermal_shutdown(buf), pf.shot_limiting(buf))
            ls.shutdown_countdown = pf.countdown_thermal_shutdown(buf)
            ls.shot_limiting_countdown = pf.countdown_shot_limiting(buf)
            ls.sensor_info = self._info
        elif ls.frame_id == (f_id + 1) % (max_fid + 1):
            return False  # reordered packet from previous frame
        elif ls.frame_id != f_id:
            # packet from a new frame: release current scan, cache packet
            self._finalize_scan(ls)
            self._cache = packet
            return True

        if pf.udp_profile_lidar == UDPProfileLidar.LEGACY or \
                isinstance(packet, LidarPacket):
            self._batch_lidar_packet(packet, ls)
        elif isinstance(packet, ImuPacket):
            self._batch_imu_packet(packet, ls)
        elif isinstance(packet, ZonePacket):
            self._batch_zone_packet(packet, ls)

        if self._check_scan_complete(ls):
            self._finalize_scan(ls)
            return True
        return False

    def reset(self) -> None:
        self._cache = None

    def batched_packets(self) -> int:
        return (self._batched_lidar_packets + self._batched_imu_packets
                + self._batched_zone_packets)

    # ------------------------------------------------------------------
    def _zero_fields(self, ls: LidarScan, start: int, end: int) -> None:
        """Zero columns [start, end) of every packet-derived pixel field
        (ref: lidar_scan.cpp:1194-1203)."""
        if start >= end:
            return
        for name in self.pf.fields:
            if ls.has_field(name):
                ls.field(name)[:, start:end] = 0

    def _zero_header_cols(self, ls: LidarScan, start: int, end: int) -> None:
        if start >= end:
            return
        ls.timestamp[start:end] = 0
        ls.measurement_id[start:end] = 0
        ls.status[start:end] = 0

    def _batch_lidar_packet(self, packet: Packet, ls: LidarScan) -> None:
        """(ref: lidar_scan.cpp:1324-1372)"""
        pf = self.pf
        buf = packet.buf

        cols = pf.col_blocks(buf)
        m_ids = read_bits(cols, pf.geom.col_measurement_id)
        statuses = read_bits(cols, pf.geom.col_status).astype(np.uint32)
        timestamps = read_bits(cols, pf.geom.col_timestamp)
        valid = (statuses & 1).astype(bool)

        packet_id = int(m_ids[0]) // pf.columns_per_packet
        if packet_id < len(ls.packet_timestamp):
            ls.packet_timestamp[packet_id] = packet.host_timestamp
            ls.alert_flags[packet_id] = pf.alert_flags(buf)

        block_parsable = self._block_dim()
        if not (valid.all() and (m_ids < self.w).all()):
            block_parsable = 0
        if block_parsable:
            # every block must fit before the end of the scan
            # (ref: lidar_scan.cpp:1351-1363)
            starts = m_ids[::block_parsable].astype(np.int64)
            if (starts + block_parsable > self.w).any():
                block_parsable = 0

        raw_headers = ls.has_field(ChanField.RAW_HEADERS)

        if block_parsable and not raw_headers:
            self._parse_by_block(ls, m_ids, timestamps, statuses, buf)
        else:
            self._parse_by_col(ls, m_ids, timestamps, statuses, valid, buf,
                               raw_headers)

        self._batched_lidar_packets += 1

    def _block_dim(self) -> int:
        """(ref: parsing.cpp:976-984)"""
        for dim in (16, 8, 4):
            if self.pf.pixels_per_column % dim == 0 and \
                    self.pf.columns_per_packet % dim == 0:
                return dim
        return 0

    def _decoded_fields(self, ls: LidarScan, buf) -> Dict[str, np.ndarray]:
        """Decode every scan-present channel field to (pixels, cols)."""
        pf = self.pf
        px = pf.px_blocks(buf)  # (cols, pixels, pw)
        out = {}
        for name in pf.fields:
            if not ls.has_field(name):
                continue
            info = pf.field_info(name)
            tgt = ls.field(name)
            if not np.issubdtype(tgt.dtype, np.floating) and \
                    tgt.dtype.itemsize < info.dtype.itemsize:
                # destination can't hold the decoded values — reject like
                # the reference's typed field visitor
                # (ref: python/tests/test_batching.py:201-225
                # test_incompatible_profile)
                raise ValueError(
                    f"field {name} dtype {tgt.dtype} is too small for "
                    f"profile values ({info.dtype})")
            if info.num_elements > 1:
                vals = np.stack(
                    [read_bits(px, info, element=e)
                     for e in range(info.num_elements)], axis=-1)
                # (cols, pixels, n) -> (pixels, cols, n)
                vals = np.swapaxes(vals, 0, 1)
                out[name] = _to_scan_dtype(vals, tgt.dtype)
            else:
                out[name] = _to_scan_dtype(read_bits(px, info).T, tgt.dtype)
        return out

    def _parse_by_block(self, ls: LidarScan, m_ids, timestamps, statuses,
                        buf) -> None:
        """(ref: lidar_scan.cpp:1282-1322)"""
        first_m_id = int(m_ids[0])
        if first_m_id >= self._next_valid_m_id:
            self._zero_fields(ls, self._next_valid_m_id, first_m_id)
            self._zero_header_cols(ls, self._next_valid_m_id, first_m_id)
            self._next_valid_m_id = first_m_id + self.pf.columns_per_packet

        idx = m_ids.astype(np.int64)
        ls.measurement_id[idx] = m_ids
        ls.timestamp[idx] = timestamps
        ls.status[idx] = statuses

        for name, vals in self._decoded_fields(ls, buf).items():
            ls.field(name)[:, idx] = vals

    def _parse_by_col(self, ls: LidarScan, m_ids, timestamps, statuses,
                      valid, buf, raw_headers: bool) -> None:
        """(ref: lidar_scan.cpp:1207-1255)"""
        decoded = self._decoded_fields(ls, buf)
        pf = self.pf
        if raw_headers:
            rh = ls.field(ChanField.RAW_HEADERS)
            rh_cols = self._raw_headers_cols(buf, rh.dtype)

        for icol in range(pf.columns_per_packet):
            m_id = int(m_ids[icol])
            if m_id >= self.w:
                continue

            if raw_headers:
                if m_id >= self._next_headers_m_id:
                    rh[:, self._next_headers_m_id:m_id] = 0
                    self._next_headers_m_id = m_id + 1
                rh[: rh_cols.shape[0], m_id] = rh_cols[:, icol]

            if not valid[icol]:
                continue

            if m_id >= self._next_valid_m_id:
                self._zero_fields(ls, self._next_valid_m_id, m_id)
                self._zero_header_cols(ls, self._next_valid_m_id, m_id)
                self._next_valid_m_id = m_id + 1

            ls.timestamp[m_id] = timestamps[icol]
            ls.measurement_id[m_id] = m_id
            ls.status[m_id] = statuses[icol]
            for name, vals in decoded.items():
                ls.field(name)[:, m_id] = vals[:, icol]

    def _raw_headers_cols(self, buf, dtype: np.dtype) -> np.ndarray:
        """Pack col header + col footer + packet header + packet footer per
        column (ref: lidar_scan.cpp:1121-1161 PackRawHeadersCol)."""
        pf = self.pf
        a = np.frombuffer(buf, dtype=np.uint8) \
            if not isinstance(buf, np.ndarray) else buf
        itemsize = dtype.itemsize
        cols = []
        for icol in range(pf.columns_per_packet):
            col_start = pf.packet_header_size + icol * pf.col_size
            col_hdr = a[col_start:col_start + pf.col_header_size]
            col_ftr = a[col_start + pf.col_size - pf.col_footer_size:
                        col_start + pf.col_size]
            pkt_hdr = a[: pf.packet_header_size]
            pkt_ftr = a[len(a) - pf.packet_footer_size:] \
                if pf.packet_footer_size else a[:0]
            packed = np.concatenate([col_hdr, col_ftr, pkt_hdr, pkt_ftr])
            cols.append(packed.view(dtype))
        return np.stack(cols, axis=1)

    # ------------------------------------------------------------------
    def _batch_imu_packet(self, packet: ImuPacket, ls: LidarScan) -> None:
        """(ref: lidar_scan.cpp:1374-1456)"""
        C = ChanField
        pf = self.pf
        buf = packet.buf

        ts, m_id, status = pf.imu_measurement_headers(buf)
        # guards like the lidar path (batcher line ~177): malformed
        # metadata (imu_packets_per_frame 0) or a corrupt measurement id
        # must drop the packet, not crash mid-stream
        ippf = pf.imu_packets_per_frame
        mpp = pf.imu_measurements_per_packet
        if ippf <= 0 or mpp <= 0 or ls.w < ippf:
            return
        imu_first_m_id = int(m_id[0])
        packet_id = imu_first_m_id // (ls.w // ippf)
        if not 0 <= packet_id < ippf:
            return
        col_offset = packet_id * mpp
        n = mpp
        sl = slice(col_offset, col_offset + n)

        if ls.has_field(C.IMU_TIMESTAMP):
            ls.field(C.IMU_TIMESTAMP)[sl] = ts
        if ls.has_field(C.IMU_MEASUREMENT_ID):
            ls.field(C.IMU_MEASUREMENT_ID)[sl] = m_id
        if ls.has_field(C.IMU_STATUS):
            ls.field(C.IMU_STATUS)[sl] = status & 1
        if ls.has_field(C.IMU_ACC):
            ls.field(C.IMU_ACC)[sl] = pf.parse_accel(buf)
        if ls.has_field(C.IMU_GYRO):
            ls.field(C.IMU_GYRO)[sl] = pf.parse_gyro(buf)
        if ls.has_field(C.IMU_PACKET_TIMESTAMP):
            ls.field(C.IMU_PACKET_TIMESTAMP)[packet_id] = \
                packet.host_timestamp
        if ls.has_field(C.IMU_ALERT_FLAGS):
            ls.field(C.IMU_ALERT_FLAGS)[packet_id] = pf.alert_flags(buf)

        sentence = pf.imu_nmea_sentence(buf)
        if ls.has_field(C.POSITION_STRING):
            ls.field(C.POSITION_STRING)[packet_id] = np.frombuffer(
                sentence, dtype="S1")
        if ls.has_field(C.POSITION_TIMESTAMP):
            ls.field(C.POSITION_TIMESTAMP)[packet_id] = pf.imu_nmea_ts(buf)
        if ls.has_field(C.POSITION_LAT_LONG):
            from ..utils.nmea import parse_lat_long

            lat, lon = parse_lat_long(sentence)
            ls.field(C.POSITION_LAT_LONG)[packet_id] = (lat, lon)

        self._batched_imu_packets += 1

    def _batch_zone_packet(self, packet: ZonePacket, ls: LidarScan) -> None:
        """(ref: lidar_scan.cpp:1458-1503)"""
        C = ChanField
        pf = self.pf
        buf = packet.buf

        if ls.has_field(C.ZONE_ALERT_FLAGS):
            ls.field(C.ZONE_ALERT_FLAGS)[0] = pf.alert_flags(buf)
        if ls.has_field(C.ZONE_TIMESTAMP):
            ls.field(C.ZONE_TIMESTAMP)[0] = pf.zone_timestamp(buf)
        if ls.has_field(C.ZONE_PACKET_TIMESTAMP):
            ls.field(C.ZONE_PACKET_TIMESTAMP)[0] = packet.host_timestamp
        if ls.has_field(C.LIVE_ZONESET_HASH):
            ls.field(C.LIVE_ZONESET_HASH)[:] = pf.live_zoneset_hash(buf)
        if ls.has_field(C.ZONE_STATES):
            zs = ls.field(C.ZONE_STATES)
            meas = pf.zone_measurements(buf)
            for key in meas:
                zs[key][:] = meas[key].astype(zs[key].dtype)

        self._batched_zone_packets += 1

    # ------------------------------------------------------------------
    def _check_scan_complete(self, ls: LidarScan) -> bool:
        """(ref: lidar_scan.cpp:1605-1617)"""
        lidar_done = (
            self.pf.udp_profile_lidar == UDPProfileLidar.OFF
            or (self._batched_lidar_packets >= self._expected_lidar_packets
                and int(np.count_nonzero(ls.packet_timestamp))
                == self._expected_lidar_packets))
        imu_done = self._batched_imu_packets >= self._expected_imu_packets
        zone_done = self._batched_zone_packets >= self._expected_zone_packets
        return lidar_done and imu_done and zone_done

    def _finalize_scan(self, ls: LidarScan) -> None:
        """(ref: lidar_scan.cpp:1619-1636)"""
        if self._next_valid_m_id < self.w:
            self._zero_fields(ls, self._next_valid_m_id, self.w)
        if ls.has_field(ChanField.RAW_HEADERS):
            ls.field(ChanField.RAW_HEADERS)[
                :, self._next_headers_m_id:self.w] = 0
        self._finished_scan_id = ls.frame_id
        self._batched_lidar_packets = 0
        self._batched_imu_packets = 0
        self._batched_zone_packets = 0
