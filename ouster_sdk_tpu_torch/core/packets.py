"""Packet containers and validation.

Rebuild of the reference Packet/LidarPacket/ImuPacket/ZonePacket
(ref: ouster_client/include/ouster/packet.h:41-489, packet.cpp).
"""

from __future__ import annotations

from enum import Enum
from typing import Union

import numpy as np

from .types import SensorInfo, UDPProfileLidar


class PacketType(Enum):
    Unknown = "Unknown"
    Lidar = "Lidar"
    Imu = "Imu"
    Zone = "Zone"


class PacketValidationFailure(Enum):
    """(ref: packet.h:34-38)"""

    NONE = 0
    PACKET_SIZE = 1
    ID = 2


class Packet:
    """Raw packet bytes + host receive timestamp (ref: packet.h:41)."""

    __slots__ = ("buf", "host_timestamp", "format")
    TYPE = PacketType.Unknown

    def __init__(self,
                 buf: Union[int, bytes, bytearray, np.ndarray] = 65536,
                 host_timestamp: int = 0):
        if isinstance(buf, (int, np.integer)):
            # size overload: writable zeroed buffer, for PacketWriter
            # synthesis (ref: python/src/cpp/client/packet.cpp:353
            # py::init<int>, size=65536)
            self.buf = np.zeros(int(buf), dtype=np.uint8)
        elif isinstance(buf, np.ndarray):
            self.buf = np.ascontiguousarray(buf, dtype=np.uint8)
        elif isinstance(buf, bytes):
            # zero-copy (read-only) view — the pcap hot path
            self.buf = np.frombuffer(buf, dtype=np.uint8)
        else:
            # bytearray/memoryview: zero-copy view, writable when the
            # source is
            self.buf = np.frombuffer(buf, dtype=np.uint8)
        self.host_timestamp = int(host_timestamp)
        self.format = None

    def type(self) -> PacketType:
        return self.TYPE

    @property
    def size(self) -> int:
        return self.buf.size


class LidarPacket(Packet):
    TYPE = PacketType.Lidar

    def validate(self, info: SensorInfo,
                 pf=None) -> PacketValidationFailure:
        """Size + init_id/serial check vs metadata
        (ref: packet.cpp LidarPacket::validate, packet.h:205)."""
        from ..ops.packet_format import PacketFormat

        pf = pf or PacketFormat.from_info(info)
        if self.buf.size != pf.lidar_packet_size:
            return PacketValidationFailure.PACKET_SIZE
        if info.format.udp_profile_lidar != UDPProfileLidar.LEGACY:
            init_id = pf.init_id(self.buf)
            prod_sn = pf.prod_sn(self.buf)
            if info.init_id and init_id and init_id != info.init_id:
                return PacketValidationFailure.ID
            if info.sn and prod_sn and prod_sn != info.sn:
                return PacketValidationFailure.ID
        return PacketValidationFailure.NONE


class ImuPacket(Packet):
    TYPE = PacketType.Imu

    def validate(self, info: SensorInfo, pf=None) -> PacketValidationFailure:
        from ..ops.packet_format import PacketFormat

        pf = pf or PacketFormat.from_info(info)
        if self.buf.size != pf.imu_packet_size:
            return PacketValidationFailure.PACKET_SIZE
        return PacketValidationFailure.NONE


class ZonePacket(Packet):
    TYPE = PacketType.Zone

    def validate(self, info: SensorInfo, pf=None) -> PacketValidationFailure:
        from ..ops.packet_format import PacketFormat

        pf = pf or PacketFormat.from_info(info)
        if self.buf.size != pf.zone_packet_size:
            return PacketValidationFailure.PACKET_SIZE
        return PacketValidationFailure.NONE
